"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases; any failed check raises, so the exit code is non-zero:
  1. build every CUDA kernel from `veon_tpu_torch/csrc` (one nvcc per
     source, started together);
  2. hold each kernel against its plain PyTorch version on the card at the
     flagship shapes and time kernel, plain version and the PyTorch library
     equivalent with CUDA events (`time_ms`: many launches per event pair):
     #1 (the pooled pool with its gather fused in) on the serving rig, the
     whole op's forward with L2 flushed and warm, against the plain
     version, the library and the gather alone, in turns, with the op's and
     the plain version's peak-memory deltas; #2 (one sorted stream) on the
     full frustum, on the K-band and as the pooled op's backward recompute
     (with that backward as a whole); #3 (two streams) on the K-band plus
     the far-depth spray; #4 (fused LayerNorm -> Dense) at the HSA qkv, HSA
     MLP and SAN qkv shapes, in turns with the library pair, with each
     time's share of the bound; fp32 and bf16;
  3. the stage-2 train step at a small size on the card against the same
     model on the CPU (plain versions), same weights and batch;
  4. training, a main path: `veon_tpu_torch.entry.train_entry` at full
     VEON-B width in bf16 with seeded random weights, 3 steps with the
     banded lift (kernel #3), then 1 step with lss_banded=False (kernel #2),
     launch counts read around exactly those steps, and the in-grid rows
     of the lift's streams on the step's own depth; then where a step's
     time goes (a profiled step and three steps timed in stages);
  5. the serving path at a small size on the card against the CPU;
  6. serving, a main path: `veon_tpu_torch.entry` at full VEON-B width in
     bf16, 3 frames, kernel #1's launches read around exactly that run;
  7. where a frame's time goes: per-tower device time and the profiler's
     kernel time (two more frames, not counted above);
  8. temporal serving at the tiny preset (T=2 and T=3, fp32) on the card
     against the CPU, 3 calls of the synthetic drive each;
  9. temporal serving, a main path: `veon_tpu_torch.entry.temporal_entry`
     at full VEON-B width, T=2, bf16, 4 calls of the drive, launches read
     around exactly those calls (kernel #1 once per call); then where a
     steady call's time goes (per-tower, temporal fusion and warp device
     time, one profiled call) and one batched F=2 forward on two frames
     without the presorted lift (kernel #3 once per frame).
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
Without a card it exits non-zero and prints no result.
"""

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM rate, the fp32 rate outside the
# tensor cores (the pools' adds, kernel #4's fp32 FMAs) and the dense bf16
# tensor-core rate (kernel #4's bf16 product)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_BF16_TC_OPS_PER_S = 989e12
OUT_DIR = "chiprun_out"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "bev_pool_pooled": ("veon_tpu_torch/csrc/bev_pool_pooled.cu", "veon_tpu/ops/bev_pool.py:223"),
    "bev_pool_sorted": ("veon_tpu_torch/csrc/bev_pool_sorted.cu", "veon_tpu/ops/bev_pool.py:211"),
    "bev_pool_sorted2": ("veon_tpu_torch/csrc/bev_pool_sorted.cu", "veon_tpu/ops/bev_pool.py:244"),
    "ln_dense": ("veon_tpu_torch/csrc/ln_dense.cu", "veon_tpu/ops/fused_ln.py:36"),
}


def log(*a):
    print(*a, flush=True)


def kernel_fns():
    """{name: wrapper} of every kernel in KERNELS (each counts its launches)."""
    from veon_tpu_torch.ops import bev_pool as bp
    from veon_tpu_torch.ops import fused_ln

    mods = {"ln_dense": fused_ln}
    return {k: getattr(mods.get(k, bp), k) for k in KERNELS}


def reset_launches():
    fns = kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    return fns


def time_ms(fn, warmup=3, iters=10, reps=10):
    """Median over `iters` samples of the CUDA-event time of `reps`
    back-to-back calls, per call, after `warmup` calls: the device time
    wherever the host enqueues faster than the device runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


FLUSH_BYTES = 128 * 2**20  # written between cold launches: over twice the 50 MB L2


def cold_times(fn, flush, iters=10):
    """CUDA-event times of single calls of fn, each after a 128 MB write that
    evicts L2 and a device-side wait that keeps the card busy while the host
    enqueues the call (so the host's own time stays out)."""
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(200_000)  # ~0.1 ms of device spin
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def peak_delta(fn):
    """Device bytes fn allocates at its peak beyond what is live before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    delta = torch.cuda.max_memory_allocated() - base
    del out
    return delta


def bf16_ulp(x):
    """One bf16 ulp at each value of x (fp32)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def check_kernel(got, plain, ref32, dt, what):
    """fp32: 1e-5 (sums in another order). bf16: one bf16 ulp (at the larger
    magnitude: the two sums may round to either side of a power of two) on
    top of the fp32 tolerance, which cancelling sums near 0 need."""
    if dt == torch.float32:
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5, msg=what)
        return
    ulp = bf16_ulp(torch.maximum(got.float().abs(), ref32.abs()))
    over = (got.float() - ref32).abs() - (ulp + 1e-5 + 1e-5 * ref32.abs())
    if over.max().item() > 0:
        raise AssertionError(f"{what}: bf16 kernel off by more than one ulp: {over.max().item()}")


def bound(nbytes, ops, ops_per_s=PEAK_FP32_OPS_PER_S):
    """(bound_ms, bound_by): bytes over the HBM rate vs operations over their
    type's peak rate (default fp32 outside the tensor cores)."""
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / ops_per_s
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def kernel_phase(cfg):
    """Kernel #1 (gather, weights, fine-cell sums and max in one kernel) vs
    its plain version (`presorted_vals` + `bev_pool_pooled_plain`) on the
    flagship rig precompute (which must equal the CPU's, integer for
    integer), fp32 at 1e-5 and bf16 within one ulp. Times, in turns (plain,
    kernel, kernel, plain) with L2 flushed before each call: the op's whole
    forward (`bev_pool_presorted_pooled`, its CSR starts included), the
    plain version, the library (`presorted_vals` + `index_add_` + `amax`) and
    the gather `presorted_vals` alone; then the same warm. The byte bound
    counts the in-grid rows' order, rank and weight, the feature rows of the
    pixels they use, the CSR starts and the output, each once."""
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
    D = cfg.grid.num_depth_bins
    order, rk, ranks = pre["order"], pre["rk_pooled"], pre["ranks"]
    p_cap = int(order.shape[0])
    valid = rk < num_cells
    n_valid = int(valid.sum())
    n_pix = int(torch.unique(order[valid].long() // D).numel())
    h, w = cfg.feat_hw
    g = torch.Generator(device=dev).manual_seed(7)
    feat = torch.randn(1, cfg.data.num_cams, h, w, C, generator=g, device=dev)
    metric = torch.rand(1, cfg.data.num_cams, h, w, generator=g, device=dev) * 58.0 + 1.5
    dist = two_hot_depth(metric, cfg.grid)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    n_coarse = num_cells // pool_r
    results = {"p_cap": p_cap, "n_valid": n_valid, "pixels_used": n_pix, "C": C,
               "num_cells": num_cells}
    for dt, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        d, f = dist.to(dt), feat.to(dt)
        got = bp.bev_pool_pooled(d, f, order, rk, num_cells, pool_r)
        vals = bp.presorted_vals(d, f, order)
        plain = bp.bev_pool_pooled_plain(vals, rk, num_cells, pool_r, dt)
        ref32 = bp.bev_pool_pooled_plain(vals, rk, num_cells, pool_r, torch.float32)
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        check_kernel(got, plain, ref32, dt, f"bev_pool_pooled {name}")
        del got, vals, plain, ref32
        idx = rk.long().clamp(max=num_cells)
        acc = torch.zeros(num_cells + 1, C, dtype=torch.float32, device=dev)

        def op():
            with torch.no_grad():
                return bp.bev_pool_presorted_pooled(d, f, order, rk, ranks, cfg.grid.size,
                                                    (2, 2, 2))

        def plain_op():
            return bp.bev_pool_pooled_plain(bp.presorted_vals(d, f, order), rk, num_cells,
                                            pool_r, dt)

        def library():
            acc.zero_()
            acc.index_add_(0, idx, bp.presorted_vals(d, f, order).float())
            return acc[:num_cells].view(-1, pool_r, C).amax(1)

        def gather():
            return bp.presorted_vals(d, f, order)

        calls = {"kernel": op, "plain": plain_op, "library": library, "gather": gather}
        for fn in calls.values():  # warm-up (and first-use build) before any timing
            fn()
        cold = {k: [] for k in calls}
        for k in ("plain", "kernel", "kernel", "plain", "library", "gather", "gather", "library"):
            cold[k] += cold_times(calls[k], flush)
        cold = {k: statistics.median(v) for k, v in cold.items()}
        warm = {k: time_ms(fn) for k, fn in calls.items()}
        peak = {k: peak_delta(calls[k]) for k in ("kernel", "plain")}
        elt = f.element_size()
        nbytes = n_valid * (8 + elt) + n_pix * C * elt + n_coarse * C * elt + (n_coarse + 1) * 4
        bound_ms, bound_by = bound(nbytes, 2 * n_valid * C)
        results[name] = dict(
            max_abs_err=err, ms=cold["kernel"], plain_ms=cold["plain"],
            library_ms=cold["library"], gather_ms=cold["gather"], warm_ms=warm["kernel"],
            warm_plain_ms=warm["plain"], warm_library_ms=warm["library"],
            warm_gather_ms=warm["gather"], bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
            peak_delta_bytes=peak["kernel"], plain_peak_delta_bytes=peak["plain"])
        log(f"kernel bev_pool_pooled {name} (gather fused): P_cap {p_cap} n_valid {n_valid} "
            f"pixels {n_pix} C {C}: L2 flushed: op forward {cold['kernel']:.4f} ms, plain "
            f"{cold['plain']:.4f} ms, library(presorted_vals + index_add_ + amax) "
            f"{cold['library']:.4f} ms, presorted_vals alone {cold['gather']:.4f} ms; warm: op "
            f"{warm['kernel']:.4f}, plain {warm['plain']:.4f}, library {warm['library']:.4f}, "
            f"presorted_vals {warm['gather']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
            f"{nbytes / 1e6:.1f} MB), share {bound_ms / cold['kernel']:.3f}; peak memory delta "
            f"op {peak['kernel'] / 2**20:.1f} MiB, plain {peak['plain'] / 2**20:.1f} MiB; "
            f"max|kernel-plain| {err:.3g}")
        del acc, idx
    del flush
    torch.cuda.empty_cache()
    return results, (metas, pre, feat, metric, dist)


def _time_case(name, call, plain_call, streams, num_cells, C, elt):
    """Time a sorted-stream kernel, its plain version and the library call
    (index_add_ of every stream into an fp32 grid); the byte bound counts
    the in-grid rows read once with their int32 ranks, and the whole output
    written once."""
    dev = streams[0][0].device
    acc = torch.zeros(num_cells + 1, C, dtype=torch.float32, device=dev)
    idx = [rk.long().clamp(max=num_cells) for _v, rk in streams]
    v32 = [v.float() for v, _rk in streams]

    def library():
        for i, v in zip(idx, v32):
            acc.index_add_(0, i, v)

    rows = [int((rk < num_cells).sum()) for _v, rk in streams]
    nbytes = sum(rows) * (C * elt + 4) + num_cells * C * elt
    bound_ms, bound_by = bound(nbytes, sum(rows) * C)
    out = dict(ms=time_ms(call), plain_ms=time_ms(plain_call), library_ms=time_ms(library),
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, in_grid_rows=rows,
               stream_rows=[int(rk.shape[0]) for _v, rk in streams])
    del acc, idx, v32
    log(f"kernel {name}: rows {out['stream_rows']} in-grid {rows} C {C}: kernel "
        f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, library(index_add_) "
        f"{out['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e9:.3f} GB)")
    return out


def lift_streams(cfg, metas, feat, metric, device):
    """The flagship lift's point streams on `device`: the full frustum's
    (two-hot weights and frustum ranks, pixel-major) and the banded lift's
    (K-band main stream and far-depth spray)."""
    from veon_tpu_torch.geometry.frustum import sensor2keyego_chain
    from veon_tpu_torch.lift.lss import LSSLift, two_hot_depth

    metas = {k: v.to(device) for k, v in metas.items()}
    N = cfg.data.num_cams
    s2k = sensor2keyego_chain(metas["sensor2egos"].reshape(1, -1, 4, 4),
                              metas["ego2globals"].reshape(1, -1, 4, 4), 1, N)
    args = (s2k[:, 0], metas["intrins"][:, 0], metas["post_rots"][:, 0],
            metas["post_trans"][:, 0], metas["bda"])
    lift = LSSLift.from_config(cfg)
    metric = metric.to(device)
    full_w = two_hot_depth(metric, cfg.grid).permute(0, 1, 3, 4, 2)
    full_r = lift.precompute_ranks(*args).permute(0, 1, 3, 4, 2)
    band_w, band_r, spray_w, spray_r = lift.banded_streams(metric, *args)
    return {"full": [(full_w, full_r)], "band": [(band_w, band_r)],
            "band_spray": [(band_w, band_r), (spray_w, spray_r)]}


def sorted_kernel_phase(cfg, metas, feat, metric):
    """Kernels #2 and #3 against their plain versions on the flagship lift's
    streams (whose ranks must equal the CPU's, integer for integer): #2 on
    the full frustum and on the K-band, #3 on the K-band plus the spray."""
    from veon_tpu_torch.ops import bev_pool as bp

    streams = lift_streams(cfg, metas, feat, metric, feat.device)
    cpu = lift_streams(cfg, metas, feat, metric.cpu(), "cpu")
    for case, pts in streams.items():
        for (_w, r), (_wc, rc) in zip(pts, cpu[case]):
            if not torch.equal(r.cpu(), rc):
                raise AssertionError(f"{case} ranks differ between the card and the CPU in "
                                     f"{int((r.cpu() != rc).sum())} points")
    nx, ny, nz = cfg.grid.size
    num_cells, C = nx * ny * nz, feat.shape[-1]
    results = {}
    for case, pts in streams.items():
        kname = "bev_pool_sorted" if len(pts) == 1 else "bev_pool_sorted2"
        kernel = getattr(bp, kname)
        for dt, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            feat_flat = feat.to(dt).reshape(-1, C)
            pairs = [(vals, rk) for rk, vals in
                     (bp.sorted_stream(w.to(dt), feat_flat, r) for w, r in pts)]
            flat = [t for pair in pairs for t in pair]
            got = kernel(*flat, num_cells)
            plain = bp.bev_pool_sorted_plain(pairs, num_cells, dt)
            ref32 = bp.bev_pool_sorted_plain(pairs, num_cells, torch.float32)
            torch.cuda.synchronize()
            err = (got.float() - plain.float()).abs().max().item()
            check_kernel(got, plain, ref32, dt, f"{kname} {case} {dname}")
            res = _time_case(f"{kname} {case} {dname}", lambda: kernel(*flat, num_cells),
                             lambda: bp.bev_pool_sorted_plain(pairs, num_cells, dt), pairs,
                             num_cells, C, got.element_size())
            results[f"{case}_{dname}"] = dict(res, kernel=kname, max_abs_err=err)
            del got, plain, ref32, pairs, flat
    return results


def pooled_backward_phase(cfg, pre, feat, dist):
    """The pooled op's backward: its fine-grid recompute through kernel #2
    against the plain version, and its gradients against a reference that
    routes the cotangent through that same fine grid (amax, ties split
    evenly) and applies the gather adjoints; every gradient entry."""
    from veon_tpu_torch.ops import bev_pool as bp

    nx, ny, nz = cfg.grid.size
    num_cells, C, R = nx * ny * nz, feat.shape[-1], 8
    G = num_cells // R
    rk, order, ranks = pre["rk_pooled"], pre["order"], pre["ranks"]
    gen = torch.Generator(device=feat.device).manual_seed(11)
    results = {}
    for dt, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        vals = bp.presorted_vals(dist.to(dt), feat.to(dt), order).contiguous()
        got = bp.bev_pool_sorted(vals, rk, num_cells)
        plain = bp.bev_pool_sorted_plain([(vals, rk)], num_cells, dt)
        ref32 = bp.bev_pool_sorted_plain([(vals, rk)], num_cells, torch.float32)
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        check_kernel(got, plain, ref32, dt, f"pooled backward recompute {dname}")
        res = _time_case(f"bev_pool_sorted pooled-backward {dname}",
                         lambda: bp.bev_pool_sorted(vals, rk, num_cells),
                         lambda: bp.bev_pool_sorted_plain([(vals, rk)], num_cells, dt),
                         [(vals, rk)], num_cells, C, got.element_size())
        d = dist.to(dt).requires_grad_()
        f = feat.to(dt).requires_grad_()
        shape = (1, nz // 2, ny // 2, nx // 2, C)
        cot = torch.randn(shape, generator=gen, device=feat.device).to(dt)

        def op_grads():
            out = bp.bev_pool_presorted_pooled(d, f, order, rk, ranks, cfg.grid.size, (2, 2, 2))
            return torch.autograd.grad(out, (d, f), cot)

        gd, gf = op_grads()
        fine = got.reshape(G, R, C).requires_grad_()
        (g_fine,) = torch.autograd.grad(fine.amax(1), fine, cot.reshape(G, C))
        gd_p, gf_p = bp._gather_adjoint(g_fine.reshape(num_cells, C), d.detach().permute(0, 1, 3, 4, 2),
                                        f.detach(), ranks.permute(0, 1, 3, 4, 2), num_cells,
                                        True, True)
        gd_p = gd_p.permute(0, 1, 4, 2, 3)
        grad_err = []
        for a, b, what in ((gd, gd_p, "d_depth"), (gf, gf_p, "d_feat")):
            check_kernel(a, b, b.float(), dt, f"pooled backward {what} {dname}")
            grad_err.append((a.float() - b.float()).abs().max().item())
        results[dname] = dict(res, kernel="bev_pool_sorted", max_abs_err=err,
                              op_fwd_bwd_ms=time_ms(op_grads, warmup=2, iters=10),
                              grad_max_abs_err=grad_err)
        log(f"pooled op forward+backward {dname}: {results[dname]['op_fwd_bwd_ms']:.4f} ms; "
            f"max |op - reference| d_depth/d_feat {grad_err} over every entry")
        del vals, got, plain, ref32, d, f, gd, gf, gd_p, gf_p, fine, g_fine
    return results


def far_depth(cfg, B=1):
    """Metric depth U(1.5, 59.5) m at half input resolution, constant over
    each 8x8 block (the lift's min-pool keeps it): a quarter of the pixels
    lie past the ~45.8 m spray threshold."""
    import numpy as np

    h, w = cfg.feat_hw
    d = np.random.default_rng(17).uniform(1.5, 59.5, (B, 1, cfg.data.num_cams, h, w))
    return torch.from_numpy(np.repeat(np.repeat(d.astype(np.float32), 8, 3), 8, 4))


def train_parity_phase():
    """One stage-2 step at the tiny preset (0.5 m depth bins, so the banded
    lift runs its spray) in fp32: card vs CPU, same weights and batch. The
    rank streams are integer-equal; losses within 1e-4, every gradient (as
    Adam's first moment) within 1e-3 of the step's largest."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import train_entry
    from veon_tpu_torch.geometry.frustum import sensor2keyego_chain
    from veon_tpu_torch.lift.lss import LSSLift, min_pool_depth
    from veon_tpu_torch.train.step import AdamW, create_train_state

    cfg = presets.veon_tiny_test()
    cfg = dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid, depth=(1.0, 45.0, 0.5)))
    # both models are built, and the card's given the CPU's weights, before either steps
    built = {dev: train_entry(cfg, device=dev, seed=3) for dev in ("cpu", "cuda")}
    gpu_model = built["cuda"][0].model
    gpu_model.load_state_dict(built["cpu"][0].model.state_dict())
    built["cuda"][0].state = create_train_state(gpu_model, AdamW())
    runs = {}
    for dev, (trainer, batch) in built.items():
        del batch["depth_imgs"]
        batch["depth"] = far_depth(cfg).to(dev)
        m = batch["metas"]
        s2k = sensor2keyego_chain(m["sensor2egos"].reshape(1, -1, 4, 4),
                                  m["ego2globals"].reshape(1, -1, 4, 4), 1, cfg.data.num_cams)
        streams = LSSLift.from_config(cfg).banded_streams(
            min_pool_depth(batch["depth"][:, 0], 8), s2k[:, 0], m["intrins"][:, 0],
            m["post_rots"][:, 0], m["post_trans"][:, 0], m["bda"])
        runs[dev] = (trainer, trainer(batch), streams)
    (cpu, lc, sc), (gpu, lg, sg) = runs["cpu"], runs["cuda"]
    for i in (1, 3):
        if not torch.equal(sc[i], sg[i].cpu()):
            raise AssertionError("train-step rank streams differ between the card and the CPU")
    for k in lc:
        torch.testing.assert_close(lg[k].cpu(), lc[k], rtol=1e-4, atol=1e-4, msg=k)
    mu_c, mu_g = cpu.state.opt_state.mu, gpu.state.opt_state.mu
    scale = max(v.abs().max().item() for v in mu_c.values())
    worst = max((mu_g[n].cpu() - v).abs().max().item() for n, v in mu_c.items()) / scale
    if worst > 1e-3:
        raise AssertionError(f"train-step gradients: card vs CPU off by {worst:.3g} of the largest")
    in_grid = [int((sc[i] < sc[i].max()).sum()) for i in (1, 3)]
    log(f"small train-step parity (tiny fp32, 0.5 m bins, card vs CPU): losses "
        f"{ {k: round(float(v), 6) for k, v in lc.items()} }, max loss diff "
        f"{max(abs(float(lg[k]) - float(lc[k])) for k in lc):.3g}, max grad diff {worst:.3g} of "
        f"the largest, rank streams equal (in-grid main/spray {in_grid})")
    return dict(losses={k: float(v) for k, v in lc.items()}, grad_rel_err=worst,
                in_grid_rows=in_grid)


def train_phase(cfg, steps=3):
    """The stage-2 train step at full VEON-B width: `steps` steps with the
    banded lift (kernel #3 once per step), then one step with
    lss_banded=False (kernel #2 once); launch counts read around exactly
    those steps. Then a profiled step (busy share, top kernels) and steps
    timed in stages (depth tower, forward + loss, backward, optimizer + EMA)."""
    from veon_tpu_torch.entry import train_entry
    from veon_tpu_torch.train import step as tstep

    out = {}
    for name, c, n in (("banded", cfg, steps), ("full", dataclasses.replace(cfg, lss_banded=False), 1)):
        t0 = time.perf_counter()
        trainer, batch = train_entry(c, device="cuda", seed=0)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        kernels = reset_launches()
        times, losses = [], []
        for _ in range(n):
            t = time.perf_counter()
            loss = trainer(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append({k: float(v) for k, v in loss.items()})
        launches = {k: fn.launches for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        rows = lift_rows(trainer, batch, c)
        want = {"bev_pool_sorted2": n if name == "banded" else 0,
                "bev_pool_sorted": 0 if name == "banded" else n, "bev_pool_pooled": 0,
                "ln_dense": 0}
        if launches != want:
            raise AssertionError(f"train ({name}) launches {launches}, expected {want}")
        if not all(math.isfinite(v) for d in losses for v in d.values()):
            raise AssertionError(f"train ({name}) losses not finite: {losses}")
        log(f"train {name} veon_b bf16: setup {setup_s:.1f} s, step ms {[round(t, 3) for t in times]}, "
            f"peak memory {peak / 2**30:.3f} GiB, launches {launches}, lift streams {rows}, "
            f"losses {losses[-1]}")
        out[name] = dict(step_ms=times, peak_bytes=peak, launches=launches, losses=losses,
                         setup_s=setup_s, lift_streams=rows)
        if name == "banded":
            out["breakdown"] = train_breakdown(trainer, batch, c, tstep)
        del trainer, batch
        torch.cuda.empty_cache()
    return out


def lift_rows(trainer, batch, cfg):
    """The rows and in-grid rows of each stream the step's lift pools, from
    the depth the step itself uses (the frozen tower on depth_imgs): the
    K-band main stream and the far-depth spray (banded lift), or the full
    frustum."""
    from veon_tpu_torch.geometry.frustum import sensor2keyego_chain
    from veon_tpu_torch.lift.lss import min_pool_depth

    model, m = trainer.model, batch["metas"]
    nx, ny, nz = cfg.grid.size
    with torch.no_grad():
        d_ds = min_pool_depth(model.estimate_depth(batch["depth_imgs"])[:, 0], 8)
    s2k = sensor2keyego_chain(m["sensor2egos"].reshape(1, -1, 4, 4),
                              m["ego2globals"].reshape(1, -1, 4, 4), 1, cfg.data.num_cams)
    args = (s2k[:, 0], m["intrins"][:, 0], m["post_rots"][:, 0], m["post_trans"][:, 0], m["bda"])
    if cfg.lss_banded:
        _w, r1, _w2, r2 = model.lift.banded_streams(d_ds, *args)
        ranks = {"main": r1} if r2 is None else {"main": r1, "spray": r2}
    else:
        ranks = {"full": model.lift.precompute_ranks(*args)}
    return {k: dict(rows=int(r.numel()), in_grid=int((r < nx * ny * nz).sum()))
            for k, r in ranks.items()}


def profiled(fn, top_n):
    """One call of fn under torch.profiler: (device kernel ms, host ms of
    that same call, busy share = their ratio, the top_n kernels). The
    profiler's host overhead lengthens the call, so the share is low if
    anything."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
    dev_time = lambda e: e.self_device_time_total / 1e3  # noqa: E731
    # device-side events only: an aten op's row repeats its kernels' time
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(dev_time(e) for e in events)
    top = [(e.key[:70], round(dev_time(e), 3), e.count)
           for e in sorted(events, key=dev_time, reverse=True)[:top_n]]
    busy = device_ms / host_ms if device_ms > 0 else None
    log(f"profiler: device kernel time {device_ms:.3f} ms, busy share "
        f"{'not measured' if busy is None else f'{busy:.3f}'} of the profiled call's "
        f"{host_ms:.3f} ms; top kernels {top}")
    return dict(device_kernel_ms=device_ms, profiled_host_ms=host_ms, busy_share=busy,
                top_kernels=top)


def train_breakdown(trainer, batch, cfg, tstep, steps=3):
    """One profiled step, then `steps` steps timed in stages with CUDA
    events that the step itself records as each stage ends
    (`make_train_step`'s `mark`); per stage the median and every value."""
    prof = profiled(lambda: trainer(batch), 15)
    marks = []
    trainer.step = tstep.make_train_step(trainer.model, tstep.AdamW(), cfg, trainer.membership,
                                         mark=lambda stage: marks.append((stage, _event())))
    runs = []
    for _ in range(steps):
        marks.clear()
        marks.append(("start", _event()))
        trainer(batch)
        torch.cuda.synchronize()
        runs.append({k: marks[i][1].elapsed_time(ev) for i, (k, ev) in enumerate(marks[1:])})
    stages = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    log(f"train stage ms (device timeline, median of {steps} steps): "
        + ", ".join(f"{k} {v:.3f} {[round(r[k], 3) for r in runs]}" for k, v in stages.items()))
    return dict(prof, stage_ms=stages, stage_ms_each=runs)


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

    t0 = time.perf_counter()
    server, (imgs, depth_imgs) = entry(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
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
    want = {k: frames if k == "bev_pool_pooled" else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"serving launches {launches} in {frames} frames, expected {want}")
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


def hook_stages(mods, marks):
    """A CUDA event before and after every forward of each module in
    {name: module}, appended to marks[name]; returns the hook handles."""
    hooks = []
    for name, mod in mods.items():
        hooks.append(mod.register_forward_pre_hook(
            lambda m, a, name=name: marks.setdefault(name, []).append(_event())))
        hooks.append(mod.register_forward_hook(
            lambda m, a, o, name=name: marks[name].append(_event())))
    return hooks


def stage_ms(marks):
    """{name: device ms summed over its (before, after) event pairs}."""
    return {k: sum(ev[i].elapsed_time(ev[i + 1]) for i in range(0, len(ev), 2))
            for k, ev in marks.items()}


def breakdown(server, imgs, depth_imgs):
    """Where a frame's time goes, from two more frames after the counted run:
    CUDA events around each tower's forward (device timeline; the rest of
    the graph, including the deep-CLIP rerun, the lift and the heads' tail,
    is "other"), and one profiled frame (device time by kernel, busy share)."""
    marks = {}
    hooks = hook_stages({name: getattr(server.model, name) for name in STAGES}, marks)
    start = _event()
    server(imgs, depth_imgs)
    end = _event()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    total = start.elapsed_time(end)
    stages = stage_ms(marks)
    stages["other"] = total - sum(stages.values())
    log(f"stage ms (device timeline, frame {total:.3f} ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return dict(profiled(lambda: server(imgs, depth_imgs), 12), stage_ms=stages,
                frame_events_ms=total)


LN_DENSE_SHAPES = {"hsa_qkv": (67584, 384, 1152), "hsa_mlp": (67584, 384, 384),
                   "san_qkv": (17536, 256, 768)}


def ln_dense_phase():
    """Kernel #4 against its plain version at the three production shapes
    the JAX docstring names, bf16 and fp32, seeded inputs on the card:
    bf16 within 2e-2, fp32 within 1e-5. Times: kernel, plain version and
    the library pair (F.layer_norm then F.linear, two calls). Bound: x, W,
    the vectors and out moved once over the HBM rate, against 2 M C N
    product operations (+ ~8 M C for the normalisation) over the dense bf16
    tensor-core rate (bf16) or the fp32 rate outside the tensor cores."""
    import torch.nn.functional as F

    from veon_tpu_torch.ops import fused_ln as fl

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    fl.ln_dense.launches = 0
    results = {}
    for shape, (M, C, N) in LN_DENSE_SHAPES.items():
        for dt, dname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            x = (2.0 * torch.randn(M, C, generator=g, device=dev) + 0.5).to(dt)
            s = 1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
            sh = 0.1 * torch.randn(C, generator=g, device=dev)
            w = (torch.randn(C, N, generator=g, device=dev) / math.sqrt(C)).to(dt)
            b = 0.1 * torch.randn(N, generator=g, device=dev)
            got = fl.ln_dense(x, s, sh, w, b)
            plain = fl.ln_dense_plain(x, s, sh, w, b)
            torch.cuda.synchronize()
            err = (got.float() - plain.float()).abs().max().item()
            tol = 2e-2 if dt == torch.bfloat16 else 1e-5
            torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol,
                                       msg=f"ln_dense {shape} {dname}")
            s_dt, sh_dt, b_dt, w_t = s.to(dt), sh.to(dt), b.to(dt), w.t()
            kernel = lambda: fl.ln_dense(x, s, sh, w, b)  # noqa: E731
            library = lambda: F.linear(F.layer_norm(x, (C,), s_dt, sh_dt, 1e-5), w_t, b_dt)  # noqa: E731
            # in turns: kernel, library, library, kernel
            k1, l1, l2, k2 = (time_ms(fn) for fn in (kernel, library, library, kernel))
            ms, library_ms = min(k1, k2), min(l1, l2)
            plain_ms = time_ms(lambda: fl.ln_dense_plain(x, s, sh, w, b))
            elt = x.element_size()
            nbytes = M * C * elt + C * N * elt + (2 * C + N) * 4 + M * N * elt
            ops = 2 * M * C * N + 8 * M * C
            bound_ms, bound_by = bound(nbytes, ops, PEAK_BF16_TC_OPS_PER_S
                                       if dt == torch.bfloat16 else PEAK_FP32_OPS_PER_S)
            results[f"{shape}_{dname}"] = dict(
                M=M, C=C, N=N, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
                bound_share=bound_ms / ms)
            log(f"kernel ln_dense {shape} {dname} {M}x{C} @ {C}x{N}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library(F.layer_norm + F.linear, two calls) "
                f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB, "
                f"{ops / 1e9:.1f} GFLOP), share of bound {bound_ms / ms:.3f}, max|kernel-plain| "
                f"{err:.3g} (tol {tol})")
            del x, w, got, plain
    results["phase_launches"] = fl.ln_dense.launches
    log(f"ln_dense launches in this phase (checks and timing): {fl.ln_dense.launches}")
    torch.cuda.empty_cache()
    return results


def temporal_parity_phase(calls=3):
    """Streaming temporal serving at the tiny preset in fp32, T=2 and T=3:
    a session on the card and one on the CPU (plain versions), the card's
    model given the CPU's weights before either runs, over `calls` calls of
    the synthetic drive; every float output of every call within 1e-3, the
    class grids equal in at least 99.9% of the voxels."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import temporal_entry

    worst, agree = {}, {}
    for T in (2, 3):
        cfg = presets.veon_tiny_test(num_temporal=T)
        built = {dev: temporal_entry(cfg, device=dev, seed=3, frames=calls)
                 for dev in ("cpu", "cuda")}
        built["cuda"][0].model.load_state_dict(built["cpu"][0].model.state_dict())
        outs = {dev: [sess.infer(r["imgs"], r["depth_imgs"],
                                 {"lidarego2global": r["lidarego2global"]}) for r in reqs]
                for dev, (sess, reqs) in built.items()}
        worst[T], agree[T] = 0.0, 1.0
        for i, (want, got) in enumerate(zip(outs["cpu"], outs["cuda"])):
            for k in want:
                g, w = got[k].cpu(), want[k]
                if k == "pred":  # a class id: equal off near-ties
                    agree[T] = min(agree[T], (g == w).float().mean().item())
                    continue
                torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3, msg=f"T={T} call {i} {k}")
                worst[T] = max(worst[T], (g - w).abs().max().item())
        if agree[T] < 0.999:
            raise AssertionError(f"T={T}: class grids agree in only {agree[T]:.4f} of the voxels")
    log(f"small temporal parity (veon_tiny_test fp32, T=2 and T=3, {calls} calls of the drive, "
        f"card vs CPU plain path): max abs diff {worst} over every float output, class grids "
        f"equal in {agree} of the voxels")
    return dict(max_abs_diff=worst, pred_agreement=agree)


def temporal_main_path(calls=4):
    """Streaming temporal serving at full VEON-B width: `temporal_entry()`
    (T=2, bf16, seeded random weights), `calls` calls of the drive, every
    launch count read around exactly those calls: kernel #1 once per call,
    no other kernel."""
    from veon_tpu_torch.entry import temporal_entry

    t0 = time.perf_counter()
    session, reqs = temporal_entry(device="cuda", seed=0, frames=calls)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    times, out = [], None
    for r in reqs:
        t = time.perf_counter()
        out = session.infer(r["imgs"], r["depth_imgs"], {"lidarego2global": r["lidarego2global"]})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {k: calls if k == "bev_pool_pooled" else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"temporal launches {launches} in {calls} calls, expected {want}")
    pred = out["pred"]
    if tuple(pred.shape) != (1, 200, 200, 16) or pred.dtype != torch.uint8:
        raise AssertionError(f"temporal pred {tuple(pred.shape)} {pred.dtype}")
    if int(pred.max()) > 17:
        raise AssertionError(f"class ids outside [0, 17]: max {int(pred.max())}")
    for k, v in out.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"temporal output {k} not finite")
    classes = torch.bincount(pred.flatten().long(), minlength=18).tolist()
    steady = statistics.median(times[1:])
    log(f"temporal main path veon_b T=2 bf16: setup {setup_s:.1f} s, call ms "
        f"{[round(t, 3) for t in times]} (call 1 cold), steady median {steady:.3f} ms/call, peak "
        f"memory {peak / 2**30:.3f} GiB, launches {launches}, class histogram {classes}")
    return session, reqs, dict(call_ms=times, steady_median_ms=steady, peak_bytes=peak,
                               launches=launches, setup_s=setup_s, classes=classes)


def temporal_breakdown(session, reqs):
    """Where a steady streaming call's time goes, from one more call after
    the counted run: CUDA events around each tower, the temporal fusion
    and the ego-motion warp (the rest is "other"); then one profiled call."""
    model = session.model
    marks = {}
    mods = {name: getattr(model, name) for name in STAGES}
    hooks = hook_stages(dict(mods, temporal_fusion=model.alignnet.temporal_fusion), marks)
    warp = model.align_to_prev

    def timed_warp(*a, **kw):
        marks.setdefault("warp", []).append(_event())
        r = warp(*a, **kw)
        marks["warp"].append(_event())
        return r

    model.align_to_prev = timed_warp  # instance attribute: shadows the method for this call
    r = reqs[-1]
    req = {"lidarego2global": r["lidarego2global"]}
    start = _event()
    session.infer(r["imgs"], r["depth_imgs"], req)
    end = _event()
    torch.cuda.synchronize()
    del model.align_to_prev
    for h in hooks:
        h.remove()
    total = start.elapsed_time(end)
    stages = stage_ms(marks)
    # the temporal fusion runs inside alignnet: report alignnet without it
    stages["alignnet_without_temporal_fusion"] = stages.pop("alignnet") - stages["temporal_fusion"]
    stages["other"] = total - sum(stages.values())
    log(f"temporal stage ms (device timeline, steady call {total:.3f} ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return dict(profiled(lambda: session.infer(r["imgs"], r["depth_imgs"], req), 12),
                stage_ms=stages, call_events_ms=total)


def batched_temporal_phase(session, reqs):
    """One batched F=2 forward on the drive's first two frames without the
    presorted lift: every frame lifts through the banded lift, kernel #3
    once per frame, no other kernel. Its outputs against the streaming
    session's second call on the same frames (bf16, the banded and
    presorted lifts summing in other orders) are recorded, not gated."""
    from veon_tpu_torch.cli.shapes import temporal_batch

    imgs, depth_imgs, metas = temporal_batch(session.rig_metas, reqs[:2])
    session.reset()
    for r in reqs[:2]:
        stream = session.infer(r["imgs"], r["depth_imgs"], {"lidarego2global": r["lidarego2global"]})
    kernels = reset_launches()
    t = time.perf_counter()
    with torch.no_grad():
        out = session.model.full_forward(imgs, depth_imgs, metas, session.ov_weight)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = {k: fn.launches for k, fn in kernels.items()}
    want = {k: 2 if k == "bev_pool_sorted2" else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"batched F=2 launches {launches}, expected {want}")
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"batched F=2 output {k} not finite")
    diff = {k: (out[k] - stream[k]).abs().max().item() for k in out}
    scale = {k: stream[k].abs().max().item() for k in out}
    log(f"batched F=2 veon_b bf16 (banded lift): {ms:.3f} ms, launches {launches}; max |batched - "
        f"streaming| {diff} against max |streaming| {scale}")
    return dict(ms=ms, launches=launches, max_abs_diff_vs_streaming=diff, streaming_scale=scale)


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
    builds = native.build(*sorted({os.path.basename(src)[:-3] for src, _ in KERNELS.values()}))
    log(f"build: {time.perf_counter() - t0:.1f} s wall, "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in builds.items()))
    for k, v in builds.items():
        log(v["log"].strip()[-1500:])

    # fp32 stays fp32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = presets.veon_b(compute_dtype="bfloat16")
    kern, (metas, pre, feat, metric, dist) = kernel_phase(cfg)
    sorted_res = sorted_kernel_phase(cfg, metas, feat, metric)
    backward = pooled_backward_phase(cfg, pre, feat, dist)
    del metas, pre, feat, metric, dist
    torch.cuda.empty_cache()
    ln = ln_dense_phase()
    train_small = train_parity_phase()
    train = train_phase(cfg)
    small = small_parity_phase()
    server, inputs, main_res = main_path(cfg)
    where = breakdown(server, *inputs)
    del server, inputs
    torch.cuda.empty_cache()
    temporal_small = temporal_parity_phase()
    session, reqs, temporal = temporal_main_path()
    temporal_where = temporal_breakdown(session, reqs)
    batched = batched_temporal_phase(session, reqs)
    del session, reqs

    rows = {"bev_pool_pooled": (kern["bf16"], main_res["launches"]["bev_pool_pooled"]),
            "bev_pool_sorted": (sorted_res["full_bf16"],
                                train["full"]["launches"]["bev_pool_sorted"]),
            "bev_pool_sorted2": (sorted_res["band_spray_bf16"],
                                 train["banded"]["launches"]["bev_pool_sorted2"]),
            # no main path calls kernel #4 (the model keeps LayerNorm + Dense)
            "ln_dense": (ln["hsa_qkv_bf16"], main_res["launches"]["ln_dense"]
                         + temporal["launches"]["ln_dense"])}
    table = {"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
        "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"]} for name, (r, launches) in rows.items()]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "kind": kind, "kernel": kern, "sorted_kernels": sorted_res,
                   "pooled_backward": backward, "train_small_parity": train_small,
                   "train": train, "small_parity_max_abs": small, "main_path": main_res,
                   "breakdown": where, "ln_dense": ln, "temporal_small_parity": temporal_small,
                   "temporal_main_path": temporal, "temporal_breakdown": temporal_where,
                   "batched_temporal": batched,
                   "builds": {k: v["seconds"] for k, v in builds.items()}},
                  f, indent=1)
    for r, _ in rows.values():
        if not all(math.isfinite(r[k]) for k in ("ms", "plain_ms", "library_ms", "bound_ms")):
            raise AssertionError("non-finite timing")
    log(smi)
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
