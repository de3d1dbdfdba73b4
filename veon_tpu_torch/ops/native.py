"""Build and load the port's CUDA kernels (`veon_tpu_torch/csrc/*.cu`).

Each source is compiled by `nvcc` for sm_90a into a shared library with a
plain C interface, loaded with ctypes. Libraries are built at first use
from the checkout's sources only, into `build/veon_tpu_torch/` beside the
package, and named by a hash of the source and flags, so an edited source
is rebuilt and a stale library is never loaded. No library links more
than the CUDA runtime: `ln_dense.cu` takes the driver's TMA descriptor
encoder through the runtime's driver entry point.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "veon_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from source on the machine with the card")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> Dict[str, dict]:
    """Compile the named sources, one nvcc process each, all started at
    once. Returns {name: {"seconds", "log"}} (0 s for a library already
    built); raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib, time.perf_counter())
    # wait for every nvcc before raising, so a failed build leaves no process behind
    logs = {name: (proc.communicate()[0], time.perf_counter() - t0)
            for name, (proc, _tmp, _lib, t0) in procs.items()}
    failed = [name for name, (proc, *_rest) in procs.items() if proc.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{name}.cu:\n{logs[name][0]}" for name in failed))
    for name, (_proc, tmp, lib, _t0) in procs.items():
        os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
        out[name] = {"seconds": logs[name][1], "log": logs[name][0]}
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library `name`, compiling it on first use."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def function(name: str, symbol: str, argtypes: tuple):
    """The C entry `symbol` of library `name` with its argument types set
    once (it returns a cudaError_t as int), so a launch pays no setup."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
