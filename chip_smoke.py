"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases; any failed check raises, so the exit code is non-zero:
  1. build every CUDA kernel of the serving path from `veon_tpu_torch/csrc`
     (one nvcc per source, started together);
  2. hold each kernel against its plain PyTorch version on the card at the
     flagship shapes and time kernel, plain version and the PyTorch library
     equivalent with CUDA events;
  3. the serving path at a small size on the card against the same model on
     the CPU (plain versions), same weights;
  4. the main path: `veon_tpu_torch.entry` at full VEON-B width in bf16
     with seeded random weights, serving 3 frames, with every kernel's
     launch count read around exactly that run;
  5. where a frame's time goes: per-tower device time and the profiler's
     kernel time (two more frames, not counted above).
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
Without a card it exits non-zero and prints no result.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM rate and the fp32 rate outside
# the tensor cores, which the pool's adds run on
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
OUT_DIR = "chiprun_out"


def log(*a):
    print(*a, flush=True)


def time_ms(fn, warmup=3, iters=25):
    """Median of `iters` CUDA-event timings after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(x):
    """One bf16 ulp at each value of x (fp32)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def kernel_phase(cfg):
    """Kernel #1 vs its plain version on the flagship rig precompute (which
    must equal the CPU's, integer for integer)."""
    from veon_tpu_torch.cli.shapes import example_batch_full
    from veon_tpu_torch.geometry.frustum import sensor2keyego_chain
    from veon_tpu_torch.lift.lss import LSSLift, two_hot_depth
    from veon_tpu_torch.ops import bev_pool as bp

    dev = torch.device("cuda")
    _, _, metas = example_batch_full(cfg, device=dev)
    s2k = sensor2keyego_chain(metas["sensor2egos"].reshape(1, -1, 4, 4),
                              metas["ego2globals"].reshape(1, -1, 4, 4), 1, cfg.data.num_cams)
    lift = LSSLift.from_config(cfg)
    pre = lift.precompute_sorted(s2k[:, 0], metas["intrins"][:, 0], metas["post_rots"][:, 0],
                                 metas["post_trans"][:, 0], metas["bda"])
    cpu_pre = lift.precompute_sorted(*(t.cpu() for t in (
        s2k[:, 0], metas["intrins"][:, 0], metas["post_rots"][:, 0], metas["post_trans"][:, 0],
        metas["bda"])))
    for k, v in cpu_pre.items():
        if not torch.equal(v, pre[k].cpu()):
            raise AssertionError(f"flagship rig precompute {k} differs between the card and the CPU")
    nx, ny, nz = cfg.grid.size
    num_cells, pool_r, C = nx * ny * nz, 8, cfg.propagation.dim
    p_cap = int(pre["order"].shape[0])
    n_valid = int((pre["rk_pooled"] < num_cells).sum())
    h, w = cfg.feat_hw
    g = torch.Generator(device=dev).manual_seed(7)
    feat = torch.randn(1, cfg.data.num_cams, h, w, C, generator=g, device=dev)
    metric = torch.rand(1, cfg.data.num_cams, h, w, generator=g, device=dev) * 58.0 + 1.5
    dist = two_hot_depth(metric, cfg.grid)
    rk = pre["rk_pooled"]
    results = {"p_cap": p_cap, "n_valid": n_valid, "C": C, "num_cells": num_cells}
    for dt, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        vals = bp.presorted_vals(dist.to(dt), feat.to(dt), pre["order"]).contiguous()
        got = bp.bev_pool_pooled(vals, rk, num_cells, pool_r, dt)
        plain = bp.bev_pool_pooled_plain(vals, rk, num_cells, pool_r, dt)
        ref32 = bp.bev_pool_pooled_plain(vals, rk, num_cells, pool_r, torch.float32)
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        if dt == torch.float32:
            torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
        else:
            # one bf16 ulp (at the larger magnitude: the two sums may round
            # to either side of a power of two) on top of the fp32 check's
            # sum-order tolerance, which cancelling sums near 0 need
            ulp = bf16_ulp(torch.maximum(got.float().abs(), ref32.abs()))
            over = (got.float() - ref32).abs() - (ulp + 1e-5 + 1e-5 * ref32.abs())
            if over.max().item() > 0:
                raise AssertionError(f"bf16 kernel off by more than one ulp: {over.max().item()}")
        ms = time_ms(lambda: bp.bev_pool_pooled(vals, rk, num_cells, pool_r, dt))
        plain_ms = time_ms(lambda: bp.bev_pool_pooled_plain(vals, rk, num_cells, pool_r, dt))
        acc = torch.zeros(num_cells + 1, C, dtype=torch.float32, device=dev)
        idx = rk.long().clamp(max=num_cells)
        vals32 = vals.float()

        def library():
            acc.index_add_(0, idx, vals32)
            return acc[:num_cells].view(-1, pool_r, C).amax(1)

        library_ms = time_ms(library)
        nbytes = p_cap * C * vals.element_size() + 4 * p_cap + num_cells // pool_r * C * vals.element_size()
        ops = n_valid * C
        bound_ms = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_OPS_PER_S) * 1e3
        bound_by = "bytes" if nbytes / PEAK_BYTES_PER_S >= ops / PEAK_FP32_OPS_PER_S else "operations"
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
        log(f"kernel bev_pool_pooled {name}: P_cap {p_cap} n_valid {n_valid} C {C}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library(index_add_+amax) "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e9:.3f} GB), "
            f"max|kernel-plain| {err:.3g}")
    return results


def small_parity_phase():
    """The serving path at the tiny preset in fp32: card vs CPU, same weights."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import entry
    from veon_tpu_torch.model.veon import VOXEL_OUTPUTS

    cfg = presets.veon_tiny_test()
    cpu, (imgs, depth_imgs) = entry(cfg, device="cpu", seed=3)
    gpu, (imgs_g, depth_g) = entry(cfg, device="cuda", seed=3)
    gpu.model.load_state_dict(cpu.model.state_dict())
    want = cpu.outputs(imgs, depth_imgs)
    got = gpu.outputs(imgs_g, depth_g)
    for k in ("order", "rk_pooled", "ranks"):
        if not torch.equal(cpu.metas["lift_sorted"][k], gpu.metas["lift_sorted"][k].cpu()):
            raise AssertionError(f"rig precompute {k} differs between CPU and card")
    worst = 0.0
    for k in VOXEL_OUTPUTS:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-3, atol=1e-3, msg=k)
        worst = max(worst, (got[k].cpu() - want[k]).abs().max().item())
    log(f"small-input parity (veon_tiny_test fp32, card vs CPU plain path): "
        f"max abs diff {worst:.3g} over {VOXEL_OUTPUTS}")
    return worst


def main_path(cfg, frames=3):
    from veon_tpu_torch.entry import entry
    from veon_tpu_torch.ops import bev_pool as bp

    t0 = time.perf_counter()
    server, (imgs, depth_imgs) = entry(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels = {"bev_pool_pooled": bp.bev_pool_pooled}
    for fn in kernels.values():
        fn.launches = 0
    times, grid = [], None
    for _ in range(frames):
        t = time.perf_counter()
        grid = server(imgs, depth_imgs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    if tuple(grid.shape) != (1, 200, 200, 16) or grid.dtype != torch.int32:
        raise AssertionError(f"class grid {tuple(grid.shape)} {grid.dtype}")
    lo, hi = int(grid.min()), int(grid.max())
    if lo < 0 or hi > 17:
        raise AssertionError(f"class ids outside [0, 17]: {lo}..{hi}")
    for k, n in launches.items():
        if n != frames:
            raise AssertionError(f"{k} launched {n} times in {frames} frames")
    out = server.outputs(imgs, depth_imgs)
    for k, v in out.items():
        if v.dtype != torch.float32 or not torch.isfinite(v).all():
            raise AssertionError(f"output {k} not finite fp32")
    classes = torch.bincount(grid.flatten().long(), minlength=18).tolist()
    log(f"main path veon_b bf16: setup {setup_s:.1f} s, frames ms {[round(t, 3) for t in times]}, "
        f"median {statistics.median(times):.3f} ms/frame, peak memory {peak / 2**30:.3f} GiB, "
        f"launches {launches}, class histogram {classes}")
    return server, (imgs, depth_imgs), dict(
        frame_ms=times, median_ms=statistics.median(times), peak_bytes=peak,
        launches=launches, setup_s=setup_s, classes=classes)


STAGES = ("depth", "clip_visual", "side_adapter", "rec_head", "hsa", "lift_fusion", "alignnet")


def breakdown(server, imgs, depth_imgs, frame_ms):
    """Where a frame's time goes, from two more frames after the counted run:
    CUDA events around each tower's forward (device timeline; the rest of
    the graph, including the deep-CLIP rerun, the lift and the heads' tail,
    is "other"), and torch.profiler's device time by kernel, whose sum over
    the frame time is the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    marks, hooks = {}, []
    for name in STAGES:
        mod = getattr(server.model, name)
        hooks.append(mod.register_forward_pre_hook(
            lambda m, a, name=name: marks.setdefault(name, []).append(_event())))
        hooks.append(mod.register_forward_hook(
            lambda m, a, o, name=name: marks[name].append(_event())))
    start = _event()
    server(imgs, depth_imgs)
    end = _event()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    total = start.elapsed_time(end)
    stages = {k: sum(ev[i].elapsed_time(ev[i + 1]) for i in range(0, len(ev), 2))
              for k, ev in marks.items()}
    stages["other"] = total - sum(stages.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server(imgs, depth_imgs)
        torch.cuda.synchronize()
    dev_time = lambda e: e.self_device_time_total / 1e3  # noqa: E731
    # device-side events only: an aten op's row repeats its kernels' time
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(dev_time(e) for e in events)
    top = [(e.key[:70], round(dev_time(e), 3), e.count)
           for e in sorted(events, key=dev_time, reverse=True)[:12]]
    busy = device_ms / frame_ms if device_ms > 0 else None
    log(f"stage ms (device timeline, frame {total:.3f} ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    log(f"profiler: device kernel time {device_ms:.3f} ms per frame, busy share "
        f"{'not measured' if busy is None else f'{busy:.3f}'} of {frame_ms:.3f} ms; top kernels {top}")
    return dict(stage_ms=stages, frame_events_ms=total, device_kernel_ms=device_ms,
                busy_share=busy, top_kernels=top)


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.ops import native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    builds = native.build("bev_pool_pooled")
    log(f"build: {time.perf_counter() - t0:.1f} s wall, "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in builds.items()))
    for k, v in builds.items():
        log(v["log"].strip()[-1500:])

    cfg = presets.veon_b(compute_dtype="bfloat16")
    kern = kernel_phase(cfg)
    small = small_parity_phase()
    server, inputs, main_res = main_path(cfg)
    where = breakdown(server, *inputs, main_res["median_ms"])

    b = kern["bf16"]
    table = {"kernels": [{
        "name": "bev_pool_pooled", "route": "cuda",
        "source": "veon_tpu_torch/csrc/bev_pool_pooled.cu",
        "replaces": "veon_tpu/ops/bev_pool.py:223",
        "launches": main_res["launches"]["bev_pool_pooled"],
        "max_abs_err": b["max_abs_err"], "ms": b["ms"], "plain_ms": b["plain_ms"],
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": b["library_ms"],
    }]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "kind": kind, "kernel": kern, "small_parity_max_abs": small,
                   "main_path": main_res, "breakdown": where,
                   "builds": {k: v["seconds"] for k, v in builds.items()}}, f, indent=1)
    if not all(math.isfinite(v) for v in (b["ms"], b["plain_ms"], b["bound_ms"])):
        raise AssertionError("non-finite timing")
    log(smi)
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
