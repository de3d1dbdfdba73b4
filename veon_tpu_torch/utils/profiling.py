"""Profiling and analysis tools (counterpart of `veon_tpu/utils/profiling.py`),
covering the reference's `tools/analysis_tools/`:
  benchmark.py                    -> `fps_harness` (the fps protocol)
  benchmark_view_transformer.py   -> `lift_microbench`
  get_flops.py                    -> `flops`
plus a Chrome trace of a region (`trace`; the reference has no tracer).
Each runs on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

from .. import resolve_device


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "veon_trace"), device="cuda"):
    """Profile the body with `torch.profiler` (host ops of every thread,
    the serve worker's spans of `utils/tracing.py` among them, and the
    card's kernels on a CUDA device) and write its Chrome trace to
    `<log_dir>/trace.json` (chrome://tracing, Perfetto). Yields the path."""
    from torch._C._profiler import _ExperimentalConfig

    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with torch.profiler.profile(activities=activities, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)


def flops(fn: Callable, *args) -> Dict[str, object]:
    """Floating-point operations of one call of fn(*args), without gradient
    (the get_flops counterpart), from `torch.utils.flop_counter.
    FlopCounterMode`: {"flops": total, "by_op": {aten op: flops}}. It counts
    the matmuls, convolutions and attention (2 per multiply-add) and
    nothing else: elementwise ops, norms, softmax, resizes and the lift's
    gathers count 0, where XLA's cost analysis (the JAX tool's) counts every
    op and also reports bytes. So the two totals are not comparable."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()), "by_op": by_op}


def fps_harness(step: Callable[[], object], n_iters: int = 50, warmup: int = 5,
                device="cuda") -> Dict[str, float]:
    """FPS = n / the time of n calls (`benchmark.py:73-96` protocol): warmup
    calls, then n_iters back to back between two device synchronizations
    (no scalar read back per call), on the host clock."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        step()
    sync()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        step()
    sync()
    per = max((time.perf_counter() - t0) / n_iters, 1e-9)
    return {"fps": 1.0 / per, "ms_per_iter": per * 1e3}


def lift_inputs(device="cuda", dtype=torch.float32):
    """(lift, feat, metric, metas) at the production VEON-B lift shapes of
    the JAX microbench: B=1, N=6 cameras yawed by pi/3 at 32x88 features of
    256 channels, 512x1408 input, 200x200x16 grid with 88 depth bins, the
    [2, 2, 2] output max-pool; metric depth U(1, 44) m; numpy seed 0."""
    from ..configs.base import GridConfig
    from ..lift.lss import LSSLift

    dev = resolve_device(device)
    lift = LSSLift(grid=GridConfig(), input_size=(512, 1408), downsample=16, ds_feat=(2, 2, 2))
    B, N, h, w = 1, 6, 32, 88
    rng = np.random.default_rng(0)
    s2e = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    for i in range(N):
        th = i * np.pi / 3
        s2e[0, i, :3, :3] = np.array(
            [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]], np.float32)
    K = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    K[..., 0, 0] = K[..., 1, 1] = 780.0
    K[..., 0, 2] = 704.0
    K[..., 1, 2] = 256.0
    eye3 = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    metas = [s2e, K, eye3, np.zeros((B, N, 3), np.float32),
             np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))]
    metas = [torch.from_numpy(m).to(dev) for m in metas]
    feat = torch.from_numpy(rng.standard_normal((B, N, h, w, 256)).astype(np.float32))
    metric = torch.from_numpy(rng.uniform(1, 44, size=(B, N, h, w)).astype(np.float32))
    return lift, feat.to(dev, dtype), metric.to(dev), metas


def lift_microbench(n_iters: int = 10, device="cuda", dtype=torch.float32) -> Dict[str, float]:
    """The LSS lift at production VEON-B shapes (`lift_inputs`;
    benchmark_view_transformer counterpart): two-hot depth and
    `LSSLift.__call__`, the reference's full-frustum lift (kernel #2 on the
    card), through `fps_harness`."""
    from ..lift.lss import two_hot_depth

    lift, feat, metric, metas = lift_inputs(device, dtype)

    def run():
        with torch.no_grad():
            return lift(feat, two_hot_depth(metric, lift.grid).to(dtype), *metas)

    return fps_harness(run, n_iters=n_iters, device=device)
