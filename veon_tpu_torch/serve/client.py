"""Python client of the serving socket (counterpart of
`veon_tpu/serve/client.py`; the frame is in protocol.py)."""

from __future__ import annotations

import socket
from typing import Dict

import numpy as np

from .protocol import recv_frame, send_frame


class TensorClient:
    """One connection to a `TensorServer`; `infer(**tensors)` sends numpy
    arrays or torch tensors and returns the response's tensors (numpy, or
    torch for bfloat16). An error frame raises RuntimeError."""

    def __init__(self, socket_path: str, timeout: float = 600.0):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout)
        self.sock.connect(socket_path)

    def infer(self, **tensors) -> Dict[str, object]:
        send_frame(self.sock, tensors)
        status, out = recv_frame(self.sock)
        if status != 0:
            raise RuntimeError(np.asarray(out.get("error", np.frombuffer(b"?", np.uint8)))
                               .tobytes().decode("utf-8", "replace"))
        return out

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
