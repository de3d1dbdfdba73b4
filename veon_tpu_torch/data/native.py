"""ctypes binding of the host data plane's C++ library (counterpart of
`veon_tpu/data/native.py`): the LiDAR -> camera depth projection of the
per-sample loader loop, the voxel-rank precompute and, where libjpeg links,
a JPEG decoder.

`csrc/host/depth_proj.cpp` is the port's own copy of the reference
package's source. It is built with g++ at first use into
`build/veon_tpu_torch/`, named by a hash of the source, with libjpeg where
it links and without it otherwise; then images decode through PIL.
Without g++ every function returns None and callers take their numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops.native import BUILD_DIR

SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / "depth_proj.cpp"
_LOCK = threading.Lock()
_STATE: dict = {}  # "lib": the loaded library or None once a build was tried


def library_path() -> Path:
    return BUILD_DIR / f"libdepth_proj-{hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    base = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SRC)]
    try:  # with libjpeg where it links (the native decode path)
        subprocess.run(base + ["-DVEON_WITH_JPEG", "-ljpeg"], check=True, capture_output=True,
                       timeout=120)
    except subprocess.SubprocessError:
        subprocess.run(base, check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)  # atomic against concurrent builds


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f, i64, i32 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int
    lib.veon_points_to_depth.argtypes = [f, i64, f, f, f, i32, i32, i32, i32, ctypes.c_float,
                                         ctypes.c_float, f]
    lib.veon_points_to_depth.restype = None
    lib.veon_voxel_ranks.argtypes = [f, i64, f, f, i32, i32, i32, i32,
                                     ctypes.POINTER(ctypes.c_int32)]
    lib.veon_voxel_ranks.restype = None
    if hasattr(lib, "veon_decode_jpeg"):
        lib.veon_decode_jpeg.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte), i64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_ubyte)]
        lib.veon_decode_jpeg.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    with _LOCK:
        if "lib" not in _STATE:
            so = library_path()
            try:
                if not so.exists():
                    _build(so)
                try:
                    lib = ctypes.CDLL(str(so))
                except OSError:  # built on a machine with libraries this one lacks
                    _build(so)
                    lib = ctypes.CDLL(str(so))
                _STATE["lib"] = _bind(lib)
            except (OSError, subprocess.SubprocessError):
                _STATE["lib"] = None
        return _STATE["lib"]


def available() -> bool:
    """True when the library is built and loadable."""
    return _load() is not None


def has_jpeg() -> bool:
    """True when the library was built with libjpeg."""
    lib = _load()
    return lib is not None and hasattr(lib, "veon_decode_jpeg")


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def points_to_depth_native(points: np.ndarray, lidar2img: np.ndarray, post_rots: np.ndarray,
                           post_trans: np.ndarray, hw: Tuple[int, int],
                           depth_range: Tuple[float, float], downsample: int = 1
                           ) -> Optional[np.ndarray]:
    """All-camera LiDAR depth projection: points (P, >=3) lidar xyz,
    lidar2img (N, 4, 4), post_rots (N, 3, 3), post_trans (N, 3), hw the
    full-resolution (H, W) -> (N, H/ds, W/ds) float32 min-depth maps; None
    without the library."""
    lib = _load()
    if lib is None:
        return None
    H, W = hw
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    l2i = np.ascontiguousarray(lidar2img, np.float32)
    pr = np.ascontiguousarray(post_rots, np.float32)
    pt = np.ascontiguousarray(post_trans, np.float32)
    N = l2i.shape[0]
    out = np.zeros((N, H // downsample, W // downsample), np.float32)
    lib.veon_points_to_depth(_fptr(pts), ctypes.c_int64(pts.shape[0]), _fptr(l2i), _fptr(pr),
                             _fptr(pt), N, H, W, downsample, ctypes.c_float(depth_range[0]),
                             ctypes.c_float(depth_range[1]), _fptr(out))
    return out


def voxel_ranks_native(coor: np.ndarray, lower_bound: Sequence[float],
                       interval: Sequence[float], size: Sequence[int]) -> Optional[np.ndarray]:
    """Voxel ranks of ego points coor (B, ..., 3), the leading axis the
    batch: rank = b * nvox + flat voxel, B * nvox (the overflow cell) out of
    the grid; None without the library."""
    lib = _load()
    if lib is None:
        return None
    nx, ny, nz = [int(s) for s in size]
    nvox = nx * ny * nz
    coor = np.ascontiguousarray(coor, np.float32)
    B = coor.shape[0]
    lb = np.ascontiguousarray(lower_bound, np.float32)
    iv = np.ascontiguousarray(interval, np.float32)
    out = np.empty(coor.shape[:-1], np.int32)
    for b in range(B):
        flat = np.ascontiguousarray(coor[b].reshape(-1, 3))
        ranks = np.empty(flat.shape[0], np.int32)
        lib.veon_voxel_ranks(_fptr(flat), ctypes.c_int64(flat.shape[0]), _fptr(lb), _fptr(iv),
                             nx, ny, nz, 0, ranks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        overflow = ranks == nvox
        ranks += b * nvox
        ranks[overflow] = B * nvox
        out[b] = ranks.reshape(coor.shape[1:-1])
    return out


def decode_jpeg_native(data: bytes) -> Optional[np.ndarray]:
    """(H, W, 3) RGB uint8 of a JPEG byte string through libjpeg (the GIL
    released for the whole decode); None without JPEG support or for a
    stream it cannot decode."""
    lib = _load()
    if lib is None or not hasattr(lib, "veon_decode_jpeg"):
        return None
    buf = (ctypes.c_ubyte * len(data)).from_buffer_copy(data)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    if lib.veon_decode_jpeg(buf, len(data), ctypes.byref(h), ctypes.byref(w), None):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.veon_decode_jpeg(buf, len(data), ctypes.byref(h), ctypes.byref(w),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))):
        return None
    return out


def _jpeg_parity_check(data: bytes, native_arr: np.ndarray) -> bool:
    """The first native decode held byte for byte against PIL's: the system
    libjpeg may round its IDCT differently from the one Pillow bundles, and
    samples must not depend on which library happened to build. On a
    mismatch the native decode is off for the process."""
    if "jpeg_ok" not in _STATE:
        from PIL import Image

        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        _STATE["jpeg_ok"] = pil.shape == native_arr.shape and bool(np.array_equal(pil, native_arr))
    return _STATE["jpeg_ok"]


def open_image_native(path: str):
    """A PIL image of `path`, JPEGs decoded natively where libjpeg is built
    in and agrees with PIL."""
    from PIL import Image

    if _STATE.get("jpeg_ok", True) and path.lower().endswith((".jpg", ".jpeg")):
        try:
            with open(path, "rb") as f:
                data = f.read()
            arr = decode_jpeg_native(data)
        except OSError:
            arr = None
        if arr is not None and _jpeg_parity_check(data, arr):
            return Image.fromarray(arr)
    return Image.open(path)
