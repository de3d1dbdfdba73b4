"""Per-preset serving benchmark (counterpart of
`veon_tpu/utils/bench_model.py`): frames/s of the F=1 serving graph of any
preset, timed as the JAX tool times it, in torch.

    python -m veon_tpu_torch.utils.bench_model --preset veon_l --iters 8

The protocol (`measure`): warm-up calls, then `iters` back-to-back calls
on inputs perturbed per call (imgs + e_i and depth_imgs + e_i, every
perturbed copy built on the device beforehand), nothing read back until
one `torch.cuda.synchronize()`; the host clock around that, the median of
3 such runs, per frame. The one synchronize keeps the host's dispatch of
frame i+1 overlapped with the device's work on frame i, as JAX's on-device
loop does, so the figure is the serving graph's throughput at batch 1.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Mapping, Optional, Sequence, Tuple

import torch


def build_serving_forward(preset: str = "veon_b", dtype: str = "bfloat16",
                          presorted: bool = True, device="cuda",
                          variables: Optional[Mapping] = None):
    """(forward, (imgs, depth_imgs, metas, ov_weight)) of a preset's F=1
    serving graph in `dtype`, LoRA folded: `entry.ServingForward` on the
    example frame (`cli/shapes.py` `example_batch_full`) and the entry's
    seeded open-vocabulary matrix; `presorted` keeps the fixed rig's
    presorted lift in the metas (kernel #1), else the banded lift runs from
    metric depth (kernel #3 with its spray stream, #2 without)."""
    from ..entry import entry
    from .export import _serving_cfg

    server, (imgs, depth_imgs) = entry(_serving_cfg(preset, compute_dtype=dtype), device=device,
                                       variables=variables)
    metas = dict(server.metas)
    if not presorted:
        metas.pop("lift_sorted")
    return server.forward, (imgs, depth_imgs, metas, server.ov_weight)


def perturbed(args: Sequence, iters: int, float_idx: Sequence[int], scale: float = 1e-3):
    """`iters` argument tuples, the float tensors at `float_idx` plus
    e_i = i * scale / (iters - 1) each (JAX's jnp.linspace(0, 1e-3, iters)),
    every copy made on its tensor's device before any timing."""
    eps = torch.linspace(0.0, scale, iters).tolist()
    return [tuple(a + e if i in float_idx else a for i, a in enumerate(args)) for e in eps]


def timed_runs(call: Callable, calls: Sequence[Tuple], outer: int = 3, warmup: int = 2,
               device="cuda") -> Tuple[float, float]:
    """(seconds per call, first call's seconds): the median over `outer`
    runs of len(calls) back-to-back calls ended by one synchronize, after
    `warmup` calls (the first timed alone)."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    call(*calls[0])
    sync()
    first_s = time.perf_counter() - t0
    for i in range(1, warmup):
        call(*calls[i % len(calls)])
    sync()
    runs = []
    for _ in range(outer):
        t0 = time.perf_counter()
        for args in calls:
            call(*args)
        sync()
        runs.append((time.perf_counter() - t0) / len(calls))
    return statistics.median(runs), first_s


@torch.no_grad()
def measure(preset: str, dtype: str = "bfloat16", iters: int = 8, presorted: bool = True,
            device="cuda") -> Tuple[float, dict]:
    """(frames/s, detail) of the preset's serving graph under the protocol
    above."""
    forward, args = build_serving_forward(preset, dtype, presorted, device)
    per, first_s = timed_runs(forward, perturbed(args, iters, (0, 1)), device=device)
    return 1.0 / per, {"ms_per_frame": per * 1e3, "first_call_s": first_s, "iters": iters,
                       "dtype": dtype, "presorted": presorted}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="veon_b")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--no-presorted", action="store_true",
                    help="use the banded (training-formulation) lift")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = ap.parse_args(argv)
    fps, detail = measure(args.preset, args.dtype, args.iters, presorted=not args.no_presorted,
                          device=args.device)
    line = {"metric": f"{args.preset}_6cam_frames_per_sec_per_chip", "value": fps,
            "unit": "frames/s", "detail": detail}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
