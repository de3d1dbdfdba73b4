"""Binary tensor framing of the serving socket (counterpart of
`veon_tpu/serve/protocol.py`; the frames are byte for byte those of the
JAX module and its C++ client).

Little-endian frame:
  u32 magic 0x56454F4E ('VEON')  | u16 version=1 | u16 status
  u32 tensor count
  per tensor: u16 name_len, name utf8, u8 dtype, u8 ndim, u64 dims[ndim],
              raw C-order data
status 0 = ok; nonzero = error, frame carries one tensor named 'error'
(u8 utf-8 message bytes).

Tensors go out from numpy arrays or torch tensors and come back as numpy
arrays, except dtype code 5 (bfloat16), which numpy lacks: it is sent as
the 16-bit view of a `torch.bfloat16` tensor (or of a numpy array whose
dtype is named bfloat16) and read back as a `torch.bfloat16` tensor.
"""

from __future__ import annotations

import socket
import struct
from typing import Dict, Tuple

import numpy as np
import torch

MAGIC = 0x56454F4E
VERSION = 1
BF16 = 5

_DTYPES = [
    np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.int32),
    np.dtype(np.int64), np.dtype(np.uint8), None,  # 5 = bfloat16
    np.dtype(np.bool_), np.dtype(np.float16),
]


def _dtype_code(dt) -> int:
    if getattr(dt, "name", str(dt)) == "bfloat16":
        return BF16
    for i, d in enumerate(_DTYPES):
        if d is not None and np.dtype(dt) == d:
            return i
    raise ValueError(f"unsupported dtype {dt}")


def _code_dtype(code: int) -> np.dtype:
    """The numpy dtype that holds code's bytes (int16 for bfloat16)."""
    if code == BF16:
        return np.dtype(np.int16)
    if 0 <= code < len(_DTYPES) and _DTYPES[code] is not None:
        return _DTYPES[code]
    raise ValueError(f"unsupported dtype code {code}")


def _wire(x) -> Tuple[int, np.ndarray]:
    """(dtype code, C-order array with at least one dimension, as
    np.ascontiguousarray gives) of a numpy array or torch tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return BF16, np.ascontiguousarray(t.view(torch.int16).numpy())
        x = t.numpy()
    arr = np.ascontiguousarray(x)
    return _dtype_code(arr.dtype), arr


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed mid-frame")
        got += r
    return bytes(buf)


def send_frame(sock: socket.socket, tensors: Dict[str, object], status: int = 0) -> None:
    parts = [struct.pack("<IHHI", MAGIC, VERSION, status, len(tensors))]
    for name, x in tensors.items():
        code, arr = _wire(x)
        nb = name.encode("utf-8")
        parts.append(struct.pack("<H", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<BB", code, arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}Q", *arr.shape))
        parts.append(arr.tobytes())
    sock.sendall(b"".join(parts))


def recv_frame(sock: socket.socket) -> Tuple[int, Dict[str, object]]:
    magic, version, status, count = struct.unpack("<IHHI", _recv_exact(sock, 12))
    if magic != MAGIC:
        raise ConnectionError(f"bad magic {magic:#x}")
    if version != VERSION:
        raise ConnectionError(f"protocol version {version} != {VERSION}")
    out: Dict[str, object] = {}
    for _ in range(count):
        (nlen,) = struct.unpack("<H", _recv_exact(sock, 2))
        name = _recv_exact(sock, nlen).decode("utf-8")
        code, ndim = struct.unpack("<BB", _recv_exact(sock, 2))
        dims = struct.unpack(f"<{ndim}Q", _recv_exact(sock, 8 * ndim))
        dt = _code_dtype(code)
        n_bytes = int(np.prod(dims, dtype=np.int64)) * dt.itemsize if ndim else dt.itemsize
        arr = np.frombuffer(_recv_exact(sock, n_bytes), dtype=dt).reshape(dims).copy()
        out[name] = torch.from_numpy(arr).view(torch.bfloat16) if code == BF16 else arr
    return status, out


def error_frame(sock: socket.socket, msg: str) -> None:
    send_frame(sock, {"error": np.frombuffer(msg.encode(), dtype=np.uint8)}, status=1)
