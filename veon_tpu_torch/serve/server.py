"""Unix-socket tensor server (counterpart of `veon_tpu/serve/server.py`
`TensorServer` and `serve_exported`). It serves a handler built by
`entry.serve_entry`, an exported `.pt2` program (`serve_exported`) or any
callable of named tensors; the clients are `serve/client.py` and the JAX
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
import torch.utils._pytree as pytree

from .. import resolve_device
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


def serve_exported(artifact_path: str, socket_path: str, bound: Dict[str, Any],
                   request_keys: Sequence[str], arg_order: Sequence[str],
                   out_names: Optional[Sequence[str]] = None, device="cuda") -> TensorServer:
    """Serve a saved `.pt2` program (`utils/export.py`) over the socket
    protocol (counterpart of `veon_tpu/serve/server.py` `serve_exported`).

    bound: name -> fixed argument (a tensor or a tree of tensors, such as
    the rig metas with their presorted lift), moved to `device` once.
    arg_order: the names of the program's positional arguments, each looked
    up in `bound` or, per request, in the request's tensors (moved to
    `device`). A dict output is answered key by key; a tensor or a tuple
    under `out_names` (default out0, out1, ...). The first request pays
    the kernels' build; the program itself is shape-frozen, so nothing
    compiles. Returns the started server."""
    from ..utils.export import load_inference

    dev = resolve_device(device)
    program = load_inference(artifact_path)

    def on_dev(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    bound_dev = pytree.tree_map(on_dev, dict(bound))

    @torch.no_grad()
    def fn(**req):
        args = [bound_dev[k] if k in bound_dev else on_dev(req[k]) for k in arg_order]
        out = program(*args)
        if isinstance(out, dict):
            return out
        if not isinstance(out, (tuple, list)):
            out = (out,)
        names = out_names or [f"out{i}" for i in range(len(out))]
        return dict(zip(names, out))

    srv = TensorServer(fn, socket_path, required=request_keys)
    srv.start()
    return srv
