"""Build and load the port's CUDA kernels (`veon_tpu_torch/csrc/*.cu`), and
build its programs over libtorch (`csrc/veon_ops.cpp`, `csrc/host/`).

Each kernel source is compiled by `nvcc` for sm_90a into a shared library
with a plain C interface, loaded with ctypes. No kernel library links more
than the CUDA runtime: `ln_dense.cu` takes the driver's TMA descriptor
encoder through the runtime's driver entry point.

`build_host` compiles with g++ against the installed torch's `include/`
and `lib/` (`HOST_TARGETS`): the op library `veon_ops` (kernels #1-#3 and
the deformable stencil as C++-registered `torch.ops.veon.*`, linking the
kernel libraries by path where torch has CUDA, CPU-only otherwise), the
one-shot runner
`veon_aoti_runner` and the daemon `veon_serve_host` of an exported package
(`utils/export.py` `export_native_bundle`), and the daemon's echo build
`veon_serve_host_echo` with no libtorch. A Python process never loads
`veon_ops`: it would define the ops `ops/bev_pool.py` and
`ops/deform_stencil.py` define.

Everything is built at first use from the checkout's sources only, into
`build/veon_tpu_torch/` beside the package, and named by a hash of the
sources and flags, so an edited source is rebuilt and a stale build is
never loaded.
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
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "veon_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (os.path.join(cuda_home(), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from source on the machine with the card")


def cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


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


# name -> (source, headers it includes, links libtorch, shared library)
HOST_TARGETS = {
    "veon_ops": ("veon_ops.cpp", (), True, True),
    "veon_aoti_runner": ("host/aoti_runner.cpp", ("host/aoti_util.h", "host/frame.h"), True,
                         False),
    "veon_serve_host": ("host/serve_host.cpp", ("host/aoti_util.h", "host/frame.h"), True,
                        False),
    "veon_serve_host_echo": ("host/serve_host.cpp", ("host/frame.h",), False, False),
}
# what veon_ops launches
KERNEL_LIBRARIES = ("bev_pool_pooled", "bev_pool_sorted", "deform_stencil")


def torch_with_cuda() -> bool:
    import torch

    return torch.version.cuda is not None


def _host_flags(name: str) -> Tuple[List[str], List[str]]:
    """(compile flags, link flags) of a host target: libtorch's headers and
    libraries (rpath'd to the installed torch) where it links them, the CUDA
    runtime's and, for `veon_ops`, the kernel libraries where torch has
    CUDA; -DVEON_NO_TORCH for the echo daemon."""
    _src, _headers, with_torch, shared = HOST_TARGETS[name]
    cflags = ["-std=c++20", "-O2", "-fPIC", "-pthread"]
    ldflags = ["-shared"] if shared else []
    if not with_torch:
        return cflags + ["-DVEON_NO_TORCH"], ldflags
    import torch

    root = Path(torch.__file__).resolve().parent
    cflags += [f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
               f"-I{root / 'include'}",
               f"-I{root / 'include' / 'torch' / 'csrc' / 'api' / 'include'}"]
    # --no-as-needed: the runners reach libtorch_cuda's package runner only
    # through its static registration, never by a symbol
    ldflags += [f"-L{root / 'lib'}", f"-Wl,-rpath,{root / 'lib'}", "-Wl,--no-as-needed",
                "-ltorch", "-ltorch_cpu", "-lc10"]
    if torch_with_cuda():
        cuda = Path(cuda_home())
        cflags += ["-DVEON_WITH_CUDA", f"-I{cuda / 'include'}"]
        if name == "veon_ops":
            ldflags += [str(library_path(k)) for k in KERNEL_LIBRARIES]
        ldflags += ["-ltorch_cuda", "-lc10_cuda", f"-L{cuda / 'lib64'}",
                    f"-Wl,-rpath,{cuda / 'lib64'}", "-lcudart"]
    return cflags, ldflags + ["-ldl"]


def host_path(name: str) -> Path:
    """Where the build of host target `name` lies (named by the hash of its
    sources and flags)."""
    src, headers, _with_torch, shared = HOST_TARGETS[name]
    cflags, ldflags = _host_flags(name)
    digest = hashlib.sha256(b"".join((CSRC / f).read_bytes() for f in (src,) + headers)
                            + " ".join(cflags + ldflags).encode()).hexdigest()[:16]
    return BUILD_DIR / (f"lib{name}-{digest}.so" if shared else f"{name}-{digest}")


def build_host(*names: str) -> Dict[str, dict]:
    """Compile the named host targets with g++, one process each, all
    started at once (after the kernel libraries `veon_ops` links, where
    torch has CUDA). Returns {name: {"seconds", "log", "path"}} (0 s for a
    target already built); raises on failure."""
    if "veon_ops" in names and torch_with_cuda():
        build(*KERNEL_LIBRARIES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) for the host programs")
    procs, out = {}, {}
    for name in names:
        path = host_path(name)
        if path.exists():
            out[name] = {"seconds": 0.0, "log": "", "path": str(path)}
            continue
        cflags, ldflags = _host_flags(name)
        tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
        cmd = [cxx, *cflags, "-o", str(tmp), str(CSRC / HOST_TARGETS[name][0]), *ldflags]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, path, time.perf_counter())
    logs = {name: (proc.communicate()[0], time.perf_counter() - t0)
            for name, (proc, _tmp, _path, t0) in procs.items()}
    failed = [name for name, (proc, *_rest) in procs.items() if proc.returncode != 0]
    if failed:
        raise RuntimeError("g++ failed for " + ", ".join(
            f"{name} ({HOST_TARGETS[name][0]}):\n{logs[name][0]}" for name in failed))
    for name, (_proc, tmp, path, _t0) in procs.items():
        os.replace(tmp, path)
        out[name] = {"seconds": logs[name][1], "log": logs[name][0], "path": str(path)}
    return out
