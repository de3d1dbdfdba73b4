"""Unix-socket tensor server (counterpart of `veon_tpu/serve/server.py`
`TensorServer`). It serves a handler built by `entry.serve_entry` (or any
callable of named tensors); the clients are `serve/client.py` and the JAX
package's python and C++ clients, which share the framing.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .protocol import error_frame, recv_frame, send_frame


class TensorServer:
    """Serve `fn(**request_tensors)` over a unix domain socket.

    fn gets the request's tensors by name (numpy arrays; torch.bfloat16
    tensors for bf16) and returns a dict of arrays or tensors, which are
    brought to the host before `server_ms` is read. Connections are
    persistent (one request per round until the peer closes). One compute
    at a time: requests of every connection queue on one lock. A failed
    request gets an error frame and the server keeps serving.
    """

    def __init__(self, fn: Callable[..., Dict[str, Any]], socket_path: str,
                 required: Sequence[str] = (), exclusive: bool = False):
        """exclusive=True admits one connection at a time (a later connect
        gets an error frame and is closed): a stateful handler such as the
        temporal session's rolling cache must see one stream only."""
        self.fn = fn
        self.socket_path = socket_path
        self.required = tuple(required)
        self.exclusive = exclusive
        self._lock = threading.Lock()
        self._active = 0
        self._stop = threading.Event()
        self._threads = []
        self._sock: Optional[socket.socket] = None

    def start(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(8)
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            t.start()
            # keep only live connection threads: a long-lived server takes
            # one connection per client
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            with self._lock:
                if self.exclusive and self._active > 0:
                    try:
                        error_frame(conn, "server busy: exclusive session mode admits one "
                                          "connection")
                    except OSError:
                        pass
                    return
                self._active += 1
            try:
                self._conn_loop(conn)
            finally:
                with self._lock:
                    self._active -= 1

    def _conn_loop(self, conn: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                status, tensors = recv_frame(conn)
            except (ConnectionError, OSError):
                return
            try:
                missing = [k for k in self.required if k not in tensors]
                if status != 0:
                    raise ValueError(f"request status {status}")
                if missing:
                    raise KeyError(f"missing tensors: {missing}")
                with self._lock:  # one in-flight compute at a time
                    t0 = time.perf_counter()
                    out = {k: v.detach().cpu() if isinstance(v, torch.Tensor) else np.asarray(v)
                           for k, v in self.fn(**tensors).items()}
                    out["server_ms"] = np.float32((time.perf_counter() - t0) * 1e3)
                send_frame(conn, out)
            except Exception as e:  # report, keep serving
                try:
                    error_frame(conn, f"{type(e).__name__}: {e}")
                except OSError:
                    return

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:  # wakes the accept loop (close alone leaves accept() blocked on Linux)
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
