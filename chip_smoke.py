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
     without the presorted lift (kernel #3 once per frame);
 10. the text tower: the tiny one card vs CPU, then VEON-B's at full
     width in fp32 building the nuscenes_brief x vild classifier (924
     sequences of 77 tokens) on the card and on the CPU, with its time;
 11. F=1 socket serving, a main path: a `TensorServer` with the handler
     of `cli/main.py` `build_serve_handler` at VEON-B fp32 answers 3
     requests with text tokens through `TensorClient` (kernel #1 once per
     request), each equal to `FrameServer` and `retrieval_map` on the same
     inputs, the first request of a second connection, 5 requests from a
     client in a process of its own (the round trip without the server's
     GIL), where a steady request's time goes by stage, then one raw-uint8
     request;
 12. T=2 socket serving, a main path: 4 streaming requests of the drive,
     equal to a direct `TemporalSession` on the same frames, a reset, a
     second connection refused, and a steady request's stages;
 13. metrics: the served grid's confusion histogram on the card against
     numpy's, on seeded labels, and its mIoU;
 14. weights day at the tiny preset: reference-layout checkpoint files
     (`tests/test_torch_mirror.py`: the semantic dump with the text tower,
     DA-V2 with LoRA r=16, a learned BPE merges file) loaded through the
     CLI's handler on the card and on the CPU, every key read but the
     ignored ones, the outputs within phase 5's tolerance;
 15. weights day at full VEON-B width in fp32, a main path: full-width
     files read, converted and loaded (each timed), the classifier built
     from the loaded text tower, `selftest --weights-dir` (five step lines,
     kernel #3 once in its forward), then a `TensorServer` with the handler
     of `serve --load-from --depth-load-from --bpe-path` answering 3
     requests with text tokens (kernel #1 once per request), each equal to
     `FrameServer` on the loaded model;
 16. the new presets at full width: VEON-L in fp32 from converted
     full-width ViT-L files, 2 frames (kernel #1 once per frame), then
     `veon_b_fast` and `veon_b_fast2` in bf16, a cold and 3 warm frames;
 17. bf16 against fp32 at full VEON-B width on phase 15's converted
     weights: flip rate, feat_occ cosine and occupancy MAD within the CPU
     battery's bounds;
 18. the host data plane on a 16-frame shard of 900x1600 JPEGs
     (`utils/loader_bench.py` `make_frames`): the g++ library of
     `data/native.py` built, its depth projection and voxel ranks against
     numpy, loader frames/s with 2 and 4 workers in thread and in process
     mode (forked after the card's context exists);
 19. the eval loop, a main path: the tiny fixture's `test` with mirror
     files card vs CPU, then through `cli/main.py` `main` at full VEON-B
     width with seeded weights, fp32: `test` over 8 frames (kernel #3 once
     per frame), `--pipeline 2` and `--raw-uint8` (equal grids),
     `--num-temporal 2` (#3 twice per frame), `test --retrieval` on a
     3-item CSV, `cache-depth` on 2 frames (idempotent), and `benchmark
     --eval` in bf16 over 12 frames, whose JSON line is logged.
Phases 11-12 serve through the CLI's handler, which computes in the
preset's dtype: fp32 since the CLI keeps it.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
Without a card it exits non-zero and prints no result.
"""

import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
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


def expect_launches(got, want, what):
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def text_tower_phase():
    """The text tower in fp32 (TF32 off), seeded weights, card vs CPU: the
    tiny one on four prompts (one cut at 77 tokens), unit-norm embeddings
    within 1e-5; then VEON-B's (512 wide, 8 heads, 12 layers) building the
    nuscenes_brief x vild classifier, 66 prompts x 14 templates = 924
    sequences of 77 tokens, on each device, its unit rows (the classifier
    over exp(logit_scale)) within 5e-5 (fp32, 12 layers summed in other
    orders). Build times on the host clock: the card's first build (cold)
    and a second one, and the CPU's."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import build_text_tower
    from veon_tpu_torch.nn.text import (ClipTokenizer, build_vocabulary, get_templates,
                                        text_classifier)

    tiny = presets.veon_tiny_test()
    tokens = torch.from_numpy(ClipTokenizer().tokenize(
        ["a photo of a car.", "There is a large traffic cone in the scene", "", "x " * 90]))
    with torch.no_grad():
        want = build_text_tower(tiny, "cpu", seed=2)(tokens)
        got = build_text_tower(tiny, "cuda", seed=2)(tokens.cuda())
    tiny_err = (got.cpu() - want).abs().max().item()
    if not tiny_err <= 1e-5:
        raise AssertionError(f"tiny text tower: card vs CPU {tiny_err:.3g} > 1e-5")
    cfg = presets.veon_b(compute_dtype="bfloat16")
    prompts, _refl = build_vocabulary(cfg.vocabulary)
    n_seq = len(prompts) * len(get_templates(cfg.san.template_set))
    rng = np.random.default_rng(11)
    bg = rng.standard_normal((1, cfg.san.clip_embed_dim)).astype(np.float32)
    logit_scale = np.float32(np.log(1 / 0.07))
    ms, ovw = {}, {}
    for name, d in (("card_cold", "cuda"), ("card", "cuda"), ("cpu", "cpu")):
        tower = build_text_tower(cfg, d, seed=0)
        t = time.perf_counter()
        ovw[name] = text_classifier(cfg, prompts, tower, bg, logit_scale, require_bpe=False)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t) * 1e3
        del tower
    scale = float(np.exp(logit_scale))
    w = ovw["card"].cpu()
    if tuple(w.shape) != (len(prompts) + 1, cfg.san.clip_embed_dim) or not torch.isfinite(w).all():
        raise AssertionError(f"veon_b classifier {tuple(w.shape)} not finite or misshaped")
    err = ((w - ovw["cpu"]).abs().max() / scale).item()
    if not err <= 5e-5:
        raise AssertionError(f"veon_b text classifier: card vs CPU {err:.3g} of a unit row > 5e-5")
    log(f"text tower: tiny card vs CPU max abs diff {tiny_err:.3g}; veon_b fp32 classifier "
        f"nuscenes_brief x {cfg.san.template_set} ({n_seq} sequences of 77 tokens): build "
        f"{ms['card']:.3f} ms on the card ({ms['card_cold']:.3f} cold), {ms['cpu']:.3f} ms on "
        f"the CPU; card vs CPU max abs diff {err:.3g} of a unit row")
    return dict(tiny_max_abs_diff=tiny_err, sequences=n_seq, build_ms=ms["card"],
                build_cold_ms=ms["card_cold"], cpu_build_ms=ms["cpu"], unit_row_max_abs_diff=err)


def socket_dir():
    """A fresh directory for a unix socket whose path fits AF_UNIX's 108
    bytes: under the temporary directory, else under build/ (relative)."""
    d = tempfile.mkdtemp(prefix="veon")
    if len(os.path.join(d, "s.sock")) > 100:
        shutil.rmtree(d)
        os.makedirs("build", exist_ok=True)
        d = os.path.relpath(tempfile.mkdtemp(prefix="veon", dir="build"))
    return d


def serve_args(num_temporal, raw_uint8=False):
    """The parsed command line `serve --preset veon_b --num-temporal N
    [--raw-uint8]` of `veon_tpu_torch.cli.main` (on the card, in the preset's fp32)."""
    from veon_tpu_torch.cli.main import parser

    argv = ["serve", "--preset", "veon_b", "--num-temporal", str(num_temporal)]
    return parser().parse_args(argv + (["--raw-uint8"] if raw_uint8 else []))


def _nbytes(tensors):
    return sum(np.asarray(v).nbytes for v in tensors.values())


def _served(client, kernels, req, what):
    """One request through the socket: (response, round-trip ms, kernel
    #1 launches it made); any other kernel's launch raises."""
    before = {k: fn.launches for k, fn in kernels.items()}
    t = time.perf_counter()
    out = client.infer(**req)
    rt = (time.perf_counter() - t) * 1e3
    made = {k: fn.launches - before[k] for k, fn in kernels.items()}
    expect_launches(made, {k: int(k == "bev_pool_pooled") for k in made}, what)
    return out, rt, made["bev_pool_pooled"]


# A client in a process of its own: argv socket path, request .npz, request
# count, response .npy; sends the request that many times on one
# connection, saves the last response's pred and prints the round trips and
# server_ms as JSON.
_CLIENT_PROCESS = r"""
import json, sys, time
import numpy as np
from veon_tpu_torch.serve.client import TensorClient
req = dict(np.load(sys.argv[2]))
rt, sms = [], []
with TensorClient(sys.argv[1]) as c:
    for _ in range(int(sys.argv[3])):
        t = time.perf_counter()
        out = c.infer(**req)
        rt.append((time.perf_counter() - t) * 1e3)
        sms.append(float(out["server_ms"][0]))
np.save(sys.argv[4], out["pred"])
print(json.dumps({"round_trip_ms": rt, "server_ms": sms}))
"""


def client_process(socket_path, req, n, d):
    """`n` requests of `req` from a client in another process, as a real
    client is (the in-process client shares the server's GIL): (round trips
    ms, server_ms, the last pred, kernel #1 launches they made; any other
    kernel's launch raises). Loading the request is outside the timings."""
    npz, npy = os.path.join(d, "req.npz"), os.path.join(d, "pred.npy")
    np.savez(npz, **req)
    kernels = reset_launches()
    run = subprocess.run([sys.executable, "-c", _CLIENT_PROCESS, socket_path, npz, str(n), npy],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"client process failed ({run.returncode}): {run.stderr[-2000:]}")
    made = {k: fn.launches for k, fn in kernels.items()}
    expect_launches(made, {k: n * int(k == "bev_pool_pooled") for k in made}, "client process")
    res = json.loads(run.stdout.strip().splitlines()[-1])
    return res["round_trip_ms"], res["server_ms"], np.load(npy), made["bev_pool_pooled"]


def request_stages(handler, req):
    """Where a steady request's time goes, from two direct handler calls in
    this thread (the second one read): host clock per stage, each ended by
    a synchronize: the request's tensors to the card ("to_card"), the text
    tower pass, the model with the merge and fusion rule ("infer"), and the
    rest of the call (the dtype check, the response's copy back)."""
    marks = {}

    def timed(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            marks[name] = marks.get(name, 0.0) + (time.perf_counter() - t) * 1e3
            return r
        return call

    target = handler.server if handler.server is not None else handler.session
    tower = handler.text_tower
    handler._tensor = timed("to_card", handler._tensor)
    handler.text_tower = timed("text_tower", tower)
    target.infer = timed("infer", target.infer)
    try:
        for _ in range(2):
            marks.clear()
            t = time.perf_counter()
            handler(**req)
            total = (time.perf_counter() - t) * 1e3
    finally:  # _tensor and infer were instance attributes shadowing the methods
        del handler._tensor, target.infer
        handler.text_tower = tower
    marks["rest"] = total - sum(marks.values())
    marks["total"] = total
    return marks


def frame_server_phase():
    """F=1 socket serving at VEON-B fp32: the `cli/main.py` handler on a
    `TensorServer` answers 3 requests of the example frame, each with the
    text tokens of another prompt, through `TensorClient`, every launch
    count read around each request (kernel #1 once, no other kernel). Each
    `pred` is bit-equal to `FrameServer` on the same inputs and classifier
    and each `retrieval` to `retrieval_map` of its direct outputs and the
    tower's embedding of the same tokens. A client in a process of its own
    then sends 5 such requests (the last pred checked too). Then a
    raw-uint8 server takes one request of seeded uint8 frames, equal to the
    same model on those frames normalized first."""
    from veon_tpu_torch.cli.main import build_serve_handler
    from veon_tpu_torch.cli.shapes import example_batch_full
    from veon_tpu_torch.data.transforms import normalize_in_graph
    from veon_tpu_torch.model.veon import retrieval_map
    from veon_tpu_torch.nn.text import ClipTokenizer
    from veon_tpu_torch.serve.client import TensorClient
    from veon_tpu_torch.serve.server import TensorServer

    t0 = time.perf_counter()
    handler, required, _expect, exclusive = build_serve_handler(serve_args(1))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    imgs, depth_imgs, _ = example_batch_full(handler.cfg, device="cpu")
    frame = {"imgs": imgs.numpy(), "depth_imgs": depth_imgs.numpy()}
    prompts = ["a parked red car", "a pedestrian crossing the road", "a traffic cone"]
    tokens = [ClipTokenizer().tokenize([p]) for p in prompts]
    d = socket_dir()
    srv = TensorServer(handler, os.path.join(d, "s.sock"), required=required, exclusive=exclusive)
    srv.start()
    outs, rt, per_req = [], [], []
    try:
        with TensorClient(srv.socket_path) as c:
            kernels = reset_launches()
            for i, tok in enumerate(tokens):
                out, ms, n = _served(c, kernels, dict(frame, text_tokens=tok), f"F=1 request {i}")
                outs.append(out)
                rt.append(ms)
                per_req.append(n)
        # the first request of a second connection (its own server thread),
        # after the first connection closed
        with TensorClient(srv.socket_path) as c:
            second = _served(c, reset_launches(), dict(frame, text_tokens=tokens[0]),
                             "second connection")[0]
        proc_rt, proc_server_ms, proc_pred, proc_launches = client_process(
            srv.socket_path, dict(frame, text_tokens=tokens[0]), 5, d)
    finally:
        srv.stop()
    stages = request_stages(handler, dict(frame, text_tokens=tokens[0]))
    server = handler.server
    x, xd = imgs.cuda(), depth_imgs.cuda()
    want_pred = server(x, xd).to(torch.uint8).cpu().numpy()
    with torch.no_grad():
        feat = server.outputs(x, xd)["feat_occ"]
        retr_diff = []
        for out, tok in zip(outs, tokens):
            te = handler.text_tower(torch.from_numpy(tok).cuda())[0]
            want_r = retrieval_map(feat, te).cpu().numpy()
            retr_diff.append(float(np.abs(out["retrieval"] - want_r).max()))
            if not np.array_equal(out["retrieval"], want_r):
                raise AssertionError(f"served retrieval differs from retrieval_map by {retr_diff[-1]}")
            if not np.array_equal(out["pred"], want_pred):
                raise AssertionError(f"served pred differs from FrameServer in "
                                     f"{int((out['pred'] != want_pred).sum())} voxels")
    if not np.array_equal(proc_pred, want_pred):
        raise AssertionError("the client process's pred differs from FrameServer")
    del feat
    server_ms = [float(o["server_ms"][0]) for o in outs]
    req_bytes = _nbytes(dict(frame, text_tokens=tokens[0]))
    resp_bytes = _nbytes(outs[0])
    grid = outs[-1]["pred"]
    if grid.shape != (1,) + tuple(handler.cfg.grid.size) or int(grid.max()) > 17:
        raise AssertionError(f"served grid {grid.shape}, max class {int(grid.max())}")
    del handler, server, srv
    torch.cuda.empty_cache()

    raw, required, _expect, exclusive = build_serve_handler(serve_args(1, raw_uint8=True))
    rng = np.random.default_rng(13)
    u8 = {"imgs": rng.integers(0, 256, imgs.shape, dtype=np.uint8),
          "depth_imgs": rng.integers(0, 256, depth_imgs.shape, dtype=np.uint8)}
    srv = TensorServer(raw, os.path.join(d, "s.sock"), required=required, exclusive=exclusive)
    srv.start()
    try:
        with TensorClient(srv.socket_path) as c:
            kernels = reset_launches()
            out_u8, rt_u8, n_u8 = _served(c, kernels, u8, "raw-uint8 request")
    finally:
        srv.stop()
        shutil.rmtree(d, ignore_errors=True)
    want_u8 = raw.server(normalize_in_graph(torch.from_numpy(u8["imgs"]).cuda(), "clipsan"),
                         normalize_in_graph(torch.from_numpy(u8["depth_imgs"]).cuda(),
                                            raw.cfg.data.depth_norm_method))
    if not np.array_equal(out_u8["pred"], want_u8.to(torch.uint8).cpu().numpy()):
        raise AssertionError("raw-uint8 served pred differs from the model on normalized frames")
    u8_bytes = _nbytes(u8)
    del raw, srv
    torch.cuda.empty_cache()
    log(f"F=1 server: a second connection's first request server_ms "
        f"{float(second['server_ms'][0]):.3f}; a steady request in this thread, ms by stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    log(f"F=1 server, a client in its own process ({len(proc_rt)} requests): server_ms "
        f"{[round(v, 3) for v in proc_server_ms]}, round trip ms {[round(v, 3) for v in proc_rt]}, "
        f"round trip - server_ms {[round(a - b, 3) for a, b in zip(proc_rt, proc_server_ms)]}, "
        f"kernel #1 launches {proc_launches}, last pred bit-equal to FrameServer")
    log(f"F=1 server veon_b fp32 ({len(tokens)} requests with text tokens): setup {setup_s:.1f} s, "
        f"server_ms {[round(v, 3) for v in server_ms]}, round trip ms {[round(v, 3) for v in rt]}, "
        f"kernel #1 launches per request {per_req}, request {req_bytes} B, response {resp_bytes} B; "
        f"pred bit-equal to FrameServer, retrieval equal to retrieval_map (max diff {max(retr_diff)}); "
        f"raw-uint8 request: server_ms {float(out_u8['server_ms'][0]):.3f}, round trip "
        f"{rt_u8:.3f} ms, request {u8_bytes} B, kernel #1 launches {n_u8}, pred equal")
    return grid, dict(setup_s=setup_s, server_ms=server_ms, round_trip_ms=rt,
                      launches_per_request=per_req, request_bytes=req_bytes,
                      response_bytes=resp_bytes,
                      second_connection_server_ms=float(second["server_ms"][0]),
                      stage_ms=stages, client_process=dict(
                          server_ms=proc_server_ms, round_trip_ms=proc_rt,
                          launches=proc_launches), raw_uint8=dict(
                          server_ms=float(out_u8["server_ms"][0]), round_trip_ms=rt_u8,
                          request_bytes=u8_bytes, launches=n_u8))


def streaming_server_phase():
    """T=2 socket serving at VEON-B fp32: 4 requests of the seeded
    drive (text tokens on every other one) through the exclusive server,
    kernel #1 once per request, each `pred` and `retrieval` equal to a
    direct `TemporalSession` on the same model, rig and frames; then a
    reset frame, and a second connection refused while the first is open."""
    from veon_tpu_torch.cli.main import build_serve_handler
    from veon_tpu_torch.cli.shapes import example_drive
    from veon_tpu_torch.nn.text import ClipTokenizer
    from veon_tpu_torch.serve.client import TensorClient
    from veon_tpu_torch.serve.server import TensorServer
    from veon_tpu_torch.serve.streaming import TemporalSession

    t0 = time.perf_counter()
    handler, required, _expect, exclusive = build_serve_handler(serve_args(2))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _rig, drive = example_drive(handler.cfg, 4, device="cpu", seed=0)
    tok = ClipTokenizer().tokenize(["a bus stopped at the kerb"])
    reqs = [dict({k: v.numpy() for k, v in r.items()}, **({"text_tokens": tok} if i % 2 else {}))
            for i, r in enumerate(drive)]
    d = socket_dir()
    srv = TensorServer(handler, os.path.join(d, "s.sock"), required=required, exclusive=exclusive)
    srv.start()
    outs, rt, per_req = [], [], []
    try:
        with TensorClient(srv.socket_path) as c:
            kernels = reset_launches()
            for i, r in enumerate(reqs):
                out, ms, n = _served(c, kernels, r, f"T=2 request {i}")
                outs.append(out)
                rt.append(ms)
                per_req.append(n)
            ok = c.infer(reset=np.int32(1))
            if int(ok["ok"][0]) != 1 or handler.session.calls != 0:
                raise AssertionError("reset frame did not zero the session")
            refused = None
            with TensorClient(srv.socket_path) as c2:
                try:
                    c2.infer(reset=np.int32(1))
                except (RuntimeError, OSError) as e:
                    refused = f"{type(e).__name__}: {e}"
            if refused is None or ("busy" not in refused and "RuntimeError" in refused):
                raise AssertionError(f"second connection not refused: {refused}")
    finally:
        srv.stop()
        shutil.rmtree(d, ignore_errors=True)
    stages = request_stages(handler, reqs[1])
    s = handler.session
    direct = TemporalSession(s.model, s.ov_weight, s.membership, rig_metas=s.rig_metas)
    for i, (r, out) in enumerate(zip(reqs, outs)):
        te = None
        if "text_tokens" in r:
            with torch.no_grad():
                te = handler.text_tower(torch.from_numpy(r["text_tokens"]).cuda())[0]
        want = direct.infer(torch.from_numpy(r["imgs"]).cuda(),
                            torch.from_numpy(r["depth_imgs"]).cuda(),
                            {"lidarego2global": torch.from_numpy(r["lidarego2global"]).cuda()},
                            text_embed=te)
        if not np.array_equal(out["pred"], want["pred"].cpu().numpy()):
            raise AssertionError(f"T=2 request {i}: pred differs from the direct session")
        if te is not None and not np.array_equal(out["retrieval"], want["retrieval"].cpu().numpy()):
            raise AssertionError(f"T=2 request {i}: retrieval differs from the direct session")
        if ("retrieval" in out) != (te is not None):
            raise AssertionError(f"T=2 request {i}: retrieval without text or missing")
    server_ms = [float(o["server_ms"][0]) for o in outs]
    del handler, s, direct, srv
    torch.cuda.empty_cache()
    log(f"T=2 server veon_b fp32 ({len(reqs)} requests of the drive): setup {setup_s:.1f} s, server_ms "
        f"{[round(v, 3) for v in server_ms]}, round trip ms {[round(v, 3) for v in rt]}, kernel #1 "
        f"launches per request {per_req}, request {_nbytes(reqs[0])} B, response "
        f"{_nbytes(outs[0])} B; pred and retrieval equal to a direct TemporalSession; reset ok; "
        f"second connection refused ({refused}); a steady request in this thread, ms by stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return dict(setup_s=setup_s, server_ms=server_ms, round_trip_ms=rt, stage_ms=stages,
                launches_per_request=per_req, request_bytes=_nbytes(reqs[0]),
                response_bytes=_nbytes(outs[0]), refused=refused)


def metrics_phase(grid):
    """The served F=1 grid against seeded labels (0..17, a tenth 255) and a
    seeded camera mask: `confusion_hist` on the card equal to the numpy
    histogram of `MIoUMetric`, and the mIoU."""
    from veon_tpu_torch.eval import MIoUMetric, confusion_hist, per_class_iou

    rng = np.random.default_rng(12)
    gt = rng.integers(0, 18, grid.shape).astype(np.uint8)
    gt[rng.random(grid.shape) < 0.1] = 255
    mask = (rng.random(grid.shape) < 0.7).astype(np.uint8)
    hist = confusion_hist(*(torch.from_numpy(a).cuda() for a in (grid, gt, mask)))
    metric = MIoUMetric()
    metric.add_batch(grid, gt, mask_camera=mask)
    if hist.device.type != "cuda" or not np.array_equal(hist.cpu().numpy(), metric.hist):
        raise AssertionError("confusion_hist on the card differs from the numpy histogram")
    miou = float(np.nanmean(per_class_iou(metric.hist)[:17]) * 100)
    log(f"metrics: confusion_hist on the card equals numpy's over {int(metric.hist.sum())} voxels; "
        f"mIoU of the served grid against seeded labels {miou:.4f}")
    return dict(voxels=int(metric.hist.sum()), miou=miou)


# The reference's checkpoint keys that no converter reads: BatchNorm
# counters, the text tower's causal-mask buffer, and refinenet4's
# resConfUnit1 (built by the DPT head, never run: the top fusion block has
# no skip input)
IGNORED_SUFFIXES = ("num_batches_tracked",)
IGNORED_KEYS = ("ov_classifier.attn_mask",)
IGNORED_PREFIXES = ("depth_head.scratch.refinenet4.resConfUnit1.",)


class _ReadKeys(dict):
    """A state_dict that records every key a converter reads."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def __contains__(self, k):
        hit = super().__contains__(k)
        if hit:
            self.read.add(k)
        return hit


def unread_keys(cfg, paths):
    """The keys of the checkpoint files at `paths` ("san", "depth") that
    neither converter reads, the ignored ones left out; (count of keys,
    unread keys)."""
    from veon_tpu_torch.ckpt import convert as C

    san = _ReadKeys(C.load_torch_state_dict(paths["san"]))
    depth = _ReadKeys(C.load_torch_state_dict(paths["depth"]))
    C.convert_san_semantic(san, cfg)
    C.convert_dav2(depth, cfg.depth)
    unread = sorted(k for sd in (san, depth) for k in sd if k not in sd.read
                    and not k.endswith(IGNORED_SUFFIXES) and k not in IGNORED_KEYS
                    and not k.startswith(IGNORED_PREFIXES))
    return len(san) + len(depth), unread


def mirror_weights(cfg, root):
    """Reference-layout checkpoint files for `cfg` under `root` (a
    semantic dump with the text tower, a DA-V2 dump with LoRA adapters of
    rank 16, a learned BPE merges file: `tests/test_torch_mirror.py`);
    (paths, seconds, bytes)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from test_torch_mirror import write_weights_dir

    t = time.perf_counter()
    paths = write_weights_dir(cfg, root)
    return paths, time.perf_counter() - t, {k: os.path.getsize(p) for k, p in paths.items()}


def weights_args(preset, paths, device="cuda"):
    """The parsed command line `serve --preset P --load-from SAN
    --depth-load-from DEPTH --bpe-path BPE --device D`."""
    from veon_tpu_torch.cli.main import parser

    return parser().parse_args(["serve", "--preset", preset, "--load-from", paths["san"],
                                "--depth-load-from", paths["depth"], "--bpe-path", paths["bpe"],
                                "--device", device])


def near_ties(out, membership, margin=1e-3):
    """Voxels (B, X, Y, Z) whose class decision is a near-tie: top-2 merged
    logits or the two occupancy logits closer than `margin`."""
    from veon_tpu_torch.nn.text import merge_classes_max

    merged = merge_classes_max(out["sem_occ_raw"], membership, axis=-1)
    top2 = merged.topk(2, dim=-1).values
    b = out["bin_occ"]
    tie = ((top2[..., 0] - top2[..., 1]) <= margin) | ((b[..., 0] - b[..., 1]).abs() <= margin)
    return tie.permute(0, 3, 2, 1)


def phase_base():
    """Device bytes allocated when a phase starts, after what earlier phases
    left for the collector is freed: its peaks are read above this."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def weights_tiny_phase():
    """Weights day at the tiny preset: mirror checkpoint files (the
    semantic dump with `ov_classifier`, DA-V2 with LoRA r=16) loaded through
    the CLI's `build_serve_handler` on the card and on the CPU (plain
    versions); every key read but the ignored ones; the card's voxel
    outputs and served retrieval within phase 5's 1e-3 of the CPU's, the
    served class grids equal off near-ties (margin 1e-3)."""
    from veon_tpu_torch.cli.main import build_serve_handler
    from veon_tpu_torch.cli.shapes import example_batch_full
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.model.veon import VOXEL_OUTPUTS
    from veon_tpu_torch.nn.text import ClipTokenizer

    cfg = presets.veon_tiny_test()
    root = tempfile.mkdtemp(prefix="veon_tiny_ckpts")
    try:
        paths, _s, _b = mirror_weights(cfg, root)
        n_keys, unread = unread_keys(cfg, paths)
        if unread:
            raise AssertionError(f"tiny checkpoint keys no converter reads: {unread[:8]}")
        handlers = {d: build_serve_handler(weights_args("veon_tiny_test", paths, d))[0]
                    for d in ("cpu", "cuda")}
        tokens = ClipTokenizer(paths["bpe"]).tokenize(["a parked red car"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    imgs, depth_imgs, _ = example_batch_full(cfg, device="cpu")
    req = {"imgs": imgs.numpy(), "depth_imgs": depth_imgs.numpy(), "text_tokens": tokens}
    served = {d: h(**req) for d, h in handlers.items()}
    cpu, gpu = handlers["cpu"].server, handlers["cuda"].server
    want, got = cpu.outputs(imgs, depth_imgs), gpu.outputs(imgs.cuda(), depth_imgs.cuda())
    worst = 0.0
    for k in VOXEL_OUTPUTS:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-3, atol=1e-3, msg=k)
        worst = max(worst, (got[k].cpu() - want[k]).abs().max().item())
    torch.testing.assert_close(torch.from_numpy(served["cuda"]["retrieval"]),
                               torch.from_numpy(served["cpu"]["retrieval"]), rtol=1e-3, atol=1e-3)
    retr = float(np.abs(served["cuda"]["retrieval"] - served["cpu"]["retrieval"]).max())
    differ = served["cuda"]["pred"] != served["cpu"]["pred"]
    ties = near_ties(want, cpu.membership).numpy()
    if (differ & ~ties).any():
        raise AssertionError(f"tiny weights day: {int((differ & ~ties).sum())} served classes "
                             "differ between card and CPU off near-ties")
    log(f"weights day, tiny: {n_keys} checkpoint keys, all read but the ignored; card vs CPU max "
        f"abs diff {worst:.3g} over {VOXEL_OUTPUTS}, retrieval {retr:.3g}, served classes differ "
        f"in {int(differ.sum())} voxels ({int(ties.sum())} near-ties)")
    return dict(keys=n_keys, max_abs_diff=worst, retrieval_max_abs_diff=retr,
                pred_differ=int(differ.sum()), near_ties=int(ties.sum()))


def weights_main_path(frame_ms):
    """Weights day at full VEON-B width (fp32, the preset's dtype), a main
    path: full-width reference-layout files (SAN ViT-B with the text tower,
    DA-V2-L with LoRA r=16), every key read but the ignored ones; the
    files read and converted, the model loaded (timed apart); `selftest
    --weights-dir` with its five step lines, kernel #3 once in its forward
    and no other launch; then a `TensorServer` with the handler of `serve
    --load-from --depth-load-from --bpe-path` answering 3 requests with text
    tokens, kernel #1 once per request, each `pred` equal to `FrameServer`
    on the same loaded model and the classifier equal to `text_classifier`
    on the loaded tower. Returns the converted variables for phase 17."""
    import contextlib
    import io

    from veon_tpu_torch.cli.main import build_serve_handler, load_checkpoints, main as cli_main
    from veon_tpu_torch.cli.shapes import example_batch_full
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import build_model, build_text_tower
    from veon_tpu_torch.nn.text import ClipTokenizer, build_vocabulary, text_classifier
    from veon_tpu_torch.serve.client import TensorClient
    from veon_tpu_torch.serve.server import TensorServer

    cfg = presets.veon_b()
    base = phase_base()
    root = tempfile.mkdtemp(prefix="veon_b_ckpts")
    d = socket_dir()
    try:
        paths, write_s, nbytes = mirror_weights(cfg, root)
        n_keys, unread = unread_keys(cfg, paths)
        if unread:
            raise AssertionError(f"veon_b checkpoint keys no converter reads: {unread[:8]}")
        t = time.perf_counter()
        variables, extras = load_checkpoints(cfg, paths["san"], paths["depth"])
        convert_s = time.perf_counter() - t
        t = time.perf_counter()
        model = build_model(cfg, torch.device("cuda"), 0, variables)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        del model
        tower = build_text_tower(cfg, "cuda", params=extras["text_tower"])
        prompts, _refl = build_vocabulary(cfg.vocabulary)
        classifier_ms = []
        for _ in range(2):  # cold, then warm
            t = time.perf_counter()
            ovw = text_classifier(cfg, prompts, tower, extras["bg_embed"], extras["logit_scale"],
                                  paths["bpe"])
            torch.cuda.synchronize()
            classifier_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.empty_cache()

        kernels = reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            drill = cli_main(["selftest", "--preset", "veon_b", "--weights-dir", root])
        drill_launches = {k: fn.launches for k, fn in kernels.items()}
        expect_launches(drill_launches, {k: int(k == "bev_pool_sorted2") for k in kernels},
                        "selftest --weights-dir")
        steps = [ln for ln in out.getvalue().splitlines() if ln.startswith("[")]
        if [s[:5] for s in steps] != ["[1/5]", "[2/5]", "[4/5]", "[5/5]"] or "WARNING" in out.getvalue():
            raise AssertionError(f"selftest --weights-dir step lines: {steps}")
        torch.cuda.empty_cache()

        t = time.perf_counter()
        handler, required, _expect, exclusive = build_serve_handler(weights_args("veon_b", paths))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        tok = ClipTokenizer(paths["bpe"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if handler.cfg.compute_dtype != "float32":
        raise AssertionError(f"the CLI serves {handler.cfg.compute_dtype}, not the preset's fp32")
    if not torch.equal(handler.server.ov_weight, ovw):
        raise AssertionError("served classifier differs from text_classifier on the loaded tower")
    imgs, depth_imgs, _ = example_batch_full(cfg, device="cpu")
    frame = {"imgs": imgs.numpy(), "depth_imgs": depth_imgs.numpy()}
    texts = ["a parked red car", "a pedestrian crossing the road", "a traffic cone"]
    srv = TensorServer(handler, os.path.join(d, "s.sock"), required=required, exclusive=exclusive)
    srv.start()
    outs, rt, per_req = [], [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        with TensorClient(srv.socket_path) as c:
            kernels = reset_launches()
            for i, text in enumerate(texts):
                o, ms, n = _served(c, kernels, dict(frame, text_tokens=tok.tokenize([text])),
                                   f"weights-day request {i}")
                outs.append(o)
                rt.append(ms)
                per_req.append(n)
    finally:
        srv.stop()
        shutil.rmtree(d, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() - base
    want = handler.server(imgs.cuda(), depth_imgs.cuda()).to(torch.uint8).cpu().numpy()
    for i, o in enumerate(outs):
        if not np.array_equal(o["pred"], want):
            raise AssertionError(f"weights-day request {i}: pred differs from FrameServer in "
                                 f"{int((o['pred'] != want).sum())} voxels")
        if not np.isfinite(o["retrieval"]).all():
            raise AssertionError(f"weights-day request {i}: retrieval not finite")
    server_ms = [float(o["server_ms"][0]) for o in outs]
    classes = np.bincount(want.reshape(-1), minlength=18).tolist()
    del handler, srv
    torch.cuda.empty_cache()
    log(f"weights day veon_b fp32: files written in {write_s:.1f} s ({nbytes} B), {n_keys} keys all "
        f"read but the ignored; read + convert {convert_s:.3f} s, load onto the card "
        f"{load_s:.3f} s, classifier build ms {[round(v, 3) for v in classifier_ms]} (cold, warm); "
        f"selftest --weights-dir: {len(steps)} step lines, mIoU {drill['miou']:.4f}, launches "
        f"{drill_launches}; server setup {setup_s:.1f} s, server_ms {[round(v, 3) for v in server_ms]}, "
        f"round trip ms {[round(v, 3) for v in rt]}, kernel #1 launches per request {per_req}, peak "
        f"memory above the phase's start {peak / 2**30:.3f} GiB (the F=1 bf16 main path: "
        f"{frame_ms:.3f} ms/frame); pred equal to FrameServer, classifier equal to "
        f"text_classifier; class histogram {classes}")
    for ln in steps:
        log("  " + ln)
    return variables, dict(write_s=write_s, file_bytes=nbytes, keys=n_keys, convert_s=convert_s,
                           load_s=load_s, classifier_ms=classifier_ms, drill_miou=drill["miou"],
                           drill_steps=steps, drill_launches=drill_launches, setup_s=setup_s,
                           server_ms=server_ms, round_trip_ms=rt, launches_per_request=per_req,
                           peak_bytes=peak, classes=classes)


def _frames(server, imgs, depth_imgs, n):
    """n frames of `server` on the card: (ms per frame, kernel launches)."""
    kernels = reset_launches()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        grid = server(imgs, depth_imgs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    if int(grid.min()) < 0 or int(grid.max()) > 17:
        raise AssertionError(f"class ids outside [0, 17]: {int(grid.min())}..{int(grid.max())}")
    return times, {k: fn.launches for k, fn in kernels.items()}


def presets_phase(frame_ms):
    """The new presets at full width: VEON-L in fp32 loaded from converted
    full-width mirror files (SAN ViT-L-14-336 with the text tower, DA-V2-L
    with LoRA r=16), 2 frames with the presorted lift (kernel #1 once per
    frame, no other kernel) and its peak memory; then `veon_b_fast` and
    `veon_b_fast2` in bf16 with seeded weights, a cold frame then 3 warm
    ones (kernel #1 once per frame; the warm median), beside the F=1
    veon_b bf16 main path's ms/frame."""
    from veon_tpu_torch.cli.main import load_checkpoints
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import entry

    cfg = presets.veon_l()
    base = phase_base()
    root = tempfile.mkdtemp(prefix="veon_l_ckpts")
    try:
        paths, write_s, nbytes = mirror_weights(cfg, root)
        n_keys, unread = unread_keys(cfg, paths)
        if unread:
            raise AssertionError(f"veon_l checkpoint keys no converter reads: {unread[:8]}")
        t = time.perf_counter()
        variables, _extras = load_checkpoints(cfg, paths["san"], paths["depth"])
        convert_s = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    server, (imgs, depth_imgs) = entry(cfg, device="cuda", variables=variables)
    del variables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    l_ms, l_launches = _frames(server, imgs, depth_imgs, 2)
    peak = torch.cuda.max_memory_allocated() - base
    expect_launches(l_launches, {k: 2 * int(k == "bev_pool_pooled") for k in l_launches}, "veon_l")
    out = server.outputs(imgs, depth_imgs)
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"veon_l output {k} not finite")
    clip_hw = tuple(out["clip_feat"].shape[2:4])
    del server, out
    torch.cuda.empty_cache()
    fast = {}
    for name in ("veon_b_fast", "veon_b_fast2"):
        fcfg = getattr(presets, name)(compute_dtype="bfloat16")
        server, (imgs, depth_imgs) = entry(fcfg, device="cuda")
        ms, launches = _frames(server, imgs, depth_imgs, 4)
        expect_launches(launches, {k: 4 * int(k == "bev_pool_pooled") for k in launches}, name)
        fast[name] = dict(frame_ms=ms, warm_ms=statistics.median(ms[1:]), launches=launches,
                          dav2_input=tuple(depth_imgs.shape[3:5]))
        del server
        torch.cuda.empty_cache()
    launches = {k: l_launches[k] + sum(f["launches"][k] for f in fast.values()) for k in l_launches}
    log(f"veon_l fp32 from converted files ({n_keys} keys, {nbytes} B written in {write_s:.1f} s, "
        f"read + convert {convert_s:.3f} s): frames ms {[round(v, 3) for v in l_ms]}, peak memory "
        f"above the phase's start {peak / 2**30:.3f} GiB, CLIP token grid {clip_hw}, launches "
        f"{l_launches}; "
        + "; ".join(f"{k} bf16 (DA-V2 input {v['dav2_input']}): frames ms "
                    f"{[round(x, 3) for x in v['frame_ms']]} (warm median {v['warm_ms']:.3f})"
                    for k, v in fast.items())
        + f"; veon_b bf16 main path {frame_ms:.3f} ms/frame")
    return dict(veon_l=dict(frame_ms=l_ms, peak_bytes=peak, keys=n_keys, file_bytes=nbytes,
                            write_s=write_s, convert_s=convert_s, clip_token_grid=clip_hw,
                            launches=l_launches), fast=fast, launches=launches)


def precision_phase(variables):
    """The bf16 forward against the fp32 one at full VEON-B width on the
    card, the converted weights of phase 15 in both, the same example
    frame: flip rate < 0.15, feat_occ cosine > 0.98, occupancy-probability
    MAD < 0.05 (the CPU battery's bounds, `tests/test_precision.py`)."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import entry
    from veon_tpu_torch.eval.precision import precision_battery

    outs = {}
    for dt in ("float32", "bfloat16"):
        server, (imgs, depth_imgs) = entry(presets.veon_b(compute_dtype=dt), device="cuda",
                                           variables=variables)
        outs[dt] = server.outputs(imgs, depth_imgs)
        membership = server.membership
        del server
        torch.cuda.empty_cache()
    r = precision_battery(outs["float32"], outs["bfloat16"], membership)
    log(f"bf16 vs fp32, veon_b full width, converted weights: {r} (bounds: flip < 0.15, "
        f"cos > 0.98, MAD < 0.05)")
    if not (r["flip_rate"] < 0.15 and r["feat_cos"] > 0.98 and r["occ_prob_mad"] < 0.05):
        raise AssertionError(f"bf16 divergence beyond the CPU battery's bounds: {r}")
    return r


# ---------------------------------------------------------------------------
# Phases 18-19: the data plane and the dataset-driven loops
# ---------------------------------------------------------------------------

CAMS = ("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_LEFT", "CAM_BACK",
        "CAM_BACK_RIGHT")


def run_cli(argv):
    """(result, captured stdout, host s, launches) of `cli/main.py` `main(argv)`;
    the launch counts read around exactly that call."""
    import contextlib
    import io

    from veon_tpu_torch.cli.main import main as cli_main

    kernels = reset_launches()
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = cli_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in kernels.items()}
    gc.collect()
    torch.cuda.empty_cache()
    return res, buf.getvalue(), seconds, launches


class captured:
    """Records, while active, the class grids each `test` run hands
    `NuScenesOccDataset.evaluate` (a (samples, X, Y, Z) uint8 array per run)
    and, with outputs=True, the model outputs of every prediction."""

    def __init__(self, outputs=False):
        from veon_tpu_torch.cli import main as cli_mod
        from veon_tpu_torch.data import nuscenes as pns

        self.cli, self.ds, self.outputs = cli_mod, pns.NuScenesOccDataset, outputs
        self.grids, self.outs = [], []

    def __enter__(self):
        self._evaluate, self._fused = self.ds.evaluate, self.cli.fused_classes
        grids, outs, evaluate, fused = self.grids, self.outs, self._evaluate, self._fused

        def record_evaluate(ds, results, **kw):
            grids.append(np.stack([np.asarray(r) for r in results]))
            return evaluate(ds, results, **kw)

        def record_fused(out, membership):
            outs.append(({k: out[k].cpu() for k in ("bin_occ", "sem_occ_raw")}, membership))
            return fused(out, membership)

        self.ds.evaluate = record_evaluate
        if self.outputs:
            self.cli.fused_classes = record_fused
        return self

    def __exit__(self, *exc):
        self.ds.evaluate, self.cli.fused_classes = self._evaluate, self._fused


def shard_paths(root, n, name):
    """An infos pkl of the first n frames of the shard under root."""
    import pickle

    with open(os.path.join(root, "infos.pkl"), "rb") as f:
        data = pickle.load(f)
    path = os.path.join(root, f"{name}.pkl")
    with open(path, "wb") as f:
        pickle.dump({"infos": data["infos"][:n], "metadata": data["metadata"]}, f)
    return path


def data_plane_phase(root):
    """Phase 18, the host data plane at nuScenes scale: the C++ library built
    with g++ (`data/native.py`); its depth projection of a 34,720-point
    sweep into six 512x1408 augmented views held against the numpy one
    (1e-6 where both fill a pixel; a point may change pixel only on a
    pixel boundary), its voxel ranks of a VEON-B frustum (6 x 88 x 32 x 88 points)
    equal to numpy's division; then `loader_bench.loader_fps` on the
    16-frame 900x1600 JPEG shard under root with 2 and 4 workers, in thread
    and in process mode (forked after the card's context exists)."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.data import native, transforms as T
    from veon_tpu_torch.data.depth_gt import (lidar2img_matrices, points_to_depth_map,
                                              project_points)
    from veon_tpu_torch.utils.loader_bench import loader_fps

    t = time.perf_counter()
    if not native.available():
        raise AssertionError("the data plane's C++ library did not build with g++")
    build_s = time.perf_counter() - t
    cfg = presets.veon_b()
    H, W = cfg.data.input_size
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-50, 50, (34720, 2)), rng.uniform(-2, 4, (34720, 1))],
                         1).astype(np.float32)
    s2e = np.stack([T.se3([np.cos(c * np.pi / 6), 0, 0, np.sin(c * np.pi / 6)], [0, 0, 1.5])
                    @ T.se3([0.5, -0.5, 0.5, -0.5], [0, 0, 0]) for c in range(6)])
    K = np.tile(np.array([[1266.0, 0, 800], [0, 1266.0, 450], [0, 0, 1]], np.float32), (6, 1, 1))
    eye = np.eye(4, dtype=np.float32)
    l2i = lidar2img_matrices(T.se3([1, 0, 0, 0], [0, 0, 1.8]), eye, s2e, np.tile(eye, (6, 1, 1)),
                             K)
    rot, tran = T.aug_homography(T.sample_augmentation(cfg.data, (900, 1600)))
    rots, trans = np.tile(rot, (6, 1, 1)), np.tile(tran, (6, 1))
    t = time.perf_counter()
    got = native.points_to_depth_native(pts, l2i, rots, trans, (H, W), cfg.grid.depth[:2])
    native_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    uvd = [project_points(pts, l2i[n], rots[n], trans[n]) for n in range(6)]
    want = np.stack([points_to_depth_map(u, H, W, cfg.grid) for u in uvd])
    numpy_ms = (time.perf_counter() - t) * 1e3
    # a pixel both fill holds the same depth within 1e-6; which pixel a point
    # lands in may differ only where its u or v lies within float32 rounding
    # (1e-3 px here) of a pixel boundary, each such point moving at most 2 pixels
    both = (got > 0) & (want > 0)
    depth_err = float(np.abs(got - want)[both].max())
    moved = int((~np.isclose(got, want, rtol=1e-6, atol=1e-6)).sum())
    edge = sum(int(((np.abs(np.abs(u[:, :2] - np.floor(u[:, :2])) - 0.5) < 1e-3).any(1)
                    & (u[:, 2] >= cfg.grid.depth[0]) & (u[:, 2] < cfg.grid.depth[1])).sum())
               for u in uvd)
    if not np.allclose(got[both], want[both], rtol=1e-6, atol=1e-6) or moved > 2 * edge:
        raise AssertionError(f"native depth projection: max diff {depth_err} where both fill a "
                             f"pixel, {moved} pixels moved for {edge} points on a boundary")
    filled = int((got > 0).sum())
    if filled < 1000:
        raise AssertionError(f"only {filled} depth pixels: the test rig sees no points")
    grid = cfg.grid
    coor = rng.uniform(-45, 45, (1, 6, 88, 32, 88, 3)).astype(np.float32)
    coor[..., 2] = rng.uniform(-2, 6, coor.shape[:-1])
    t = time.perf_counter()
    ranks = native.voxel_ranks_native(coor, grid.lower_bound, grid.interval, grid.size)
    ranks_ms = (time.perf_counter() - t) * 1e3
    nx, ny, nz = grid.size
    sc = (coor - np.float32(grid.lower_bound)) / np.float32(grid.interval)
    v = sc.astype(np.int32)
    ok = (sc >= 0).all(-1) & (v < np.array([nx, ny, nz])).all(-1)
    ref = np.where(ok, (v[..., 2] * ny + v[..., 1]) * nx + v[..., 0], nx * ny * nz)
    if not np.array_equal(ranks, ref):
        raise AssertionError(f"native voxel ranks differ in {int((ranks != ref).sum())} points")
    log(f"data plane: g++ library {'with' if native.has_jpeg() else 'without'} libjpeg, "
        f"built and loaded in {build_s:.3f} s; depth of {len(pts)} points into 6 x {H}x{W}: "
        f"native {native_ms:.3f} ms, numpy {numpy_ms:.3f} ms, max diff {depth_err:.3g}, "
        f"{filled} pixels, {moved} moved ({edge} points on a boundary); ranks of {ranks.size} frustum points {ranks_ms:.3f} ms, equal, "
        f"{int(ok.sum())} in the grid")
    pkl = os.path.join(root, "infos.pkl")
    fps = {}
    for mode in ("thread", "process"):
        for workers in (2, 4):
            fps[f"{mode}_{workers}"] = loader_fps(pkl, root, workers, mode)
    log(f"loader frames/s on the 16-frame 900x1600 shard (VEON-B eval samples, "
        f"{os.cpu_count()} cores): {fps}")
    return dict(native_jpeg=native.has_jpeg(), build_s=build_s, depth_native_ms=native_ms,
                depth_numpy_ms=numpy_ms, depth_max_diff=depth_err, depth_pixels=filled,
                depth_pixels_moved=moved, boundary_points=edge,
                ranks_ms=ranks_ms, loader_fps=fps)


def eval_tiny_parity_phase(root):
    """The tiny fixture's `test` (a 3-frame 90x160 shard, 20x20x4 labels)
    with mirror checkpoint files on the card and on the CPU: the class
    grids equal off near-ties (phase 5's margin 1e-3 on the CPU's logits)
    and the mIoU dicts equal where the grids are."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.utils.loader_bench import make_frames

    pkl = make_frames(os.path.join(root, "tiny"), 3, hw=(90, 160), grid_shape=(20, 20, 4))
    paths, _s, _b = mirror_weights(presets.veon_tiny_test(), os.path.join(root, "tiny_ckpts"))
    argv = ["test", "--preset", "veon_tiny_test", "--data-root", os.path.join(root, "tiny"),
            "--ann", pkl, "--workers", "1", "--load-from", paths["san"], "--depth-load-from",
            paths["depth"], "--bpe-path", paths["bpe"]]
    res, grids = {}, {}
    for dev in ("cpu", "cuda"):
        with captured(outputs=dev == "cpu") as rec:
            res[dev] = run_cli(argv + ["--device", dev])[0]
        grids[dev] = rec.grids[0]
        if dev == "cpu":
            ties = np.concatenate([near_ties(o, m).numpy() for o, m in rec.outs])
    differ = grids["cuda"] != grids["cpu"]
    if (differ & ~ties).any():
        raise AssertionError(f"tiny test: {int((differ & ~ties).sum())} classes differ between "
                             "card and CPU off near-ties")
    if not differ.any() and res["cuda"] != res["cpu"]:
        raise AssertionError("tiny test: equal grids but different mIoU dicts")
    log(f"tiny test card vs CPU: classes differ in {int(differ.sum())} of {differ.size} voxels "
        f"({int(ties.sum())} near-ties), mIoU {res['cuda']['mIoU']:.4f} / {res['cpu']['mIoU']:.4f}")
    return dict(differ=int(differ.sum()), near_ties=int(ties.sum()),
                miou_card=res["cuda"]["mIoU"], miou_cpu=res["cpu"]["mIoU"])


def retrieval_shard(root, tokens):
    """The shard's infos with a LiDAR sweep per frame (34,720 points, the
    lidar 1.8 m above the ego) and a POP-3D CSV over `tokens`: per item a
    binary annotation of every point and the camera-visible half."""
    import pickle

    with open(os.path.join(root, "infos.pkl"), "rb") as f:
        data = pickle.load(f)
    rng = np.random.default_rng(5)
    rows = []
    for info in data["infos"]:
        pts = np.concatenate([rng.uniform(-40, 40, (34720, 2)), rng.uniform(-3, 3, (34720, 1)),
                              rng.uniform(0, 1, (34720, 2))], 1).astype(np.float32)
        info["lidar_path"] = os.path.join(root, f"lidar_{info['token']}.bin")
        pts.tofile(info["lidar_path"])
        info["lidar2ego_rotation"], info["lidar2ego_translation"] = [1.0, 0, 0, 0], [0, 0, 1.8]
        if info["token"] in tokens:
            anno = (rng.uniform(size=34720) < 0.1).astype(np.uint8)
            np.save(os.path.join(root, f"anno_{info['token']}.npy"), anno)
            np.save(os.path.join(root, f"match_{info['token']}.npy"), np.arange(0, 34720, 2))
            rows.append(f"{info['token']};val;anno_{info['token']}.npy;"
                        f"match_{info['token']}.npy;a parked red car")
    pkl = os.path.join(root, "infos_lidar.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(data, f)
    csv_path = os.path.join(root, "retrieval_anns_val.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return pkl, csv_path


def eval_loop_phase(root, frames=8):
    """Phase 19, the eval loop at full VEON-B width with seeded weights, a
    main path: `cli/main.py` `main` runs `test` (fp32, the preset's dtype)
    on the first `frames` frames of the shard (200x200x16 labels), kernel
    #3 once per frame read around exactly that run; then `--pipeline 2`
    (equal grids and mIoU dict), `--raw-uint8` (equal grids),
    `--num-temporal 2` (#3 twice per frame), `test --retrieval` on a
    3-item CSV (finite mAP, #3 once per item), `cache-depth` on 2 frames
    (token[:2]/token/token-CAM.npy, idempotent) and `benchmark --eval` in
    bf16 over 12 frames of its own shard, whose JSON line is logged."""
    pkl = shard_paths(root, frames, "eval")
    base = ["--data-root", root, "--ann", pkl, "--workers", "2"]
    runs, grids = {}, {}
    for name, extra in (("plain", []), ("pipeline2", ["--pipeline", "2"]),
                        ("raw_uint8", ["--raw-uint8"]), ("t2", ["--num-temporal", "2"])):
        with captured() as rec:
            res, out, s, launches = run_cli(["test", "--preset", "veon_b", *base, *extra])
        grids[name] = rec.grids[0]
        line = next(ln for ln in out.splitlines() if ln.startswith("inference done"))
        k = 2 * frames if name == "t2" else frames
        expect_launches(launches, {n: k if n == "bev_pool_sorted2" else 0 for n in launches},
                        f"test {name}")
        g = grids[name]
        if g.shape != (frames, 200, 200, 16) or g.dtype != np.uint8 or g.max() > 17:
            raise AssertionError(f"test {name}: grids {g.shape} {g.dtype} max {g.max()}")
        if not np.isfinite(res["mIoU"]):
            raise AssertionError(f"test {name}: mIoU {res['mIoU']}")
        runs[name] = dict(miou=res["mIoU"], seconds=s, line=line, launches=launches,
                          classes=np.bincount(g.reshape(-1), minlength=18).tolist())
        log(f"test veon_b fp32 {name}: {line}; {s:.3f} s with the model build; mIoU "
            f"{res['mIoU']:.4f}; launches {launches}")
        if name == "plain":
            plain = res
        elif name == "pipeline2" and res != plain:
            raise AssertionError("--pipeline 2 gave another mIoU dict")
        if name in ("pipeline2", "raw_uint8") and not np.array_equal(g, grids["plain"]):
            raise AssertionError(f"test {name}: grids differ from the serial run in "
                                 f"{int((g != grids['plain']).sum())} voxels")
    tokens = ("tok0", "tok3", "tok6")
    lidar_pkl, csv_path = retrieval_shard(root, tokens)
    res, out, s, launches = run_cli(["test", "--retrieval", "--preset", "veon_b",
                                     "--data-root", root, "--ann", lidar_pkl, "--workers", "2",
                                     "--retrieval-items", csv_path])
    expect_launches(launches, {n: len(tokens) if n == "bev_pool_sorted2" else 0
                               for n in launches}, "test --retrieval")
    if res["num_prompts"] != len(tokens) or not np.isfinite(res["mAP"]):
        raise AssertionError(f"test --retrieval: {res}")
    runs["retrieval"] = dict(summary=res, seconds=s, launches=launches)
    log(f"test --retrieval veon_b fp32: {res}, {s:.3f} s")
    cache = os.path.join(root, "depth_cache")
    argv = ["cache-depth", "--preset", "veon_b", "--data-root", root, "--ann",
            shard_paths(root, 2, "cache"), "--workers", "2", "--cache-dir", cache]
    n, _out, s, _l = run_cli(argv)
    files = [os.path.join(cache, t[:2], t, f"{t}-{c}.npy") for t in ("tok0", "tok1") for c in CAMS]
    for f in files:
        d = np.load(f)
        if d.shape != (256, 704) or d.dtype != np.float32 or not np.isfinite(d).all():
            raise AssertionError(f"cache-depth {f}: {d.shape} {d.dtype}")
    again = run_cli(argv)[0]
    if n != len(files) or again != 0:
        raise AssertionError(f"cache-depth wrote {n} then {again} files, expected 12 then 0")
    runs["cache_depth"] = dict(files=n, seconds=s, rerun_files=again)
    log(f"cache-depth veon_b fp32: {n} files in {s:.3f} s, token[:2]/token/token-CAM.npy, "
        f"(256, 704) float32; a second run wrote {again}")
    os.environ.pop("VEON_ENTRY_DTYPE", None)
    bench, _out, s, launches = run_cli(["benchmark", "--eval", "--frames", "12"])
    expect_launches(launches, {n: 37 if n == "bev_pool_sorted2" else 0 for n in launches},
                    "benchmark --eval (1 cold + 12 + 12 pipelined + 12 e2e frames)")
    d = bench["detail"]
    if d["dtype"] != "bfloat16" or not all(d[k] > 0 for k in (
            "device_path_fps", "pipelined_fps", "e2e_fps", "hist_ms_per_frame")):
        raise AssertionError(f"benchmark --eval: {bench}")
    log(json.dumps(bench))
    runs["benchmark_eval"] = dict(result=bench, seconds=s, launches=launches)
    runs["launches_sorted2"] = sum(r["launches"]["bev_pool_sorted2"] for r in runs.values()
                                   if isinstance(r, dict) and "launches" in r)
    return runs


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
    torch.cuda.empty_cache()
    text = text_tower_phase()
    grid, serve_f1 = frame_server_phase()
    serve_t2 = streaming_server_phase()
    metrics = metrics_phase(grid)
    weights_tiny = weights_tiny_phase()
    variables, weights = weights_main_path(main_res["median_ms"])
    new_presets = presets_phase(main_res["median_ms"])
    precision = precision_phase(variables)
    del variables
    gc.collect()
    torch.cuda.empty_cache()
    from veon_tpu_torch.utils.loader_bench import make_frames

    shard = tempfile.mkdtemp(prefix="veon_shard")
    try:
        t = time.perf_counter()
        make_frames(shard, 16)
        log(f"shard: 16 frames x 6 cams of 900x1600 JPEGs in {time.perf_counter() - t:.1f} s")
        data_plane = data_plane_phase(shard)
        eval_tiny = eval_tiny_parity_phase(shard)
        eval_loop = eval_loop_phase(shard)
    finally:
        shutil.rmtree(shard, ignore_errors=True)

    # launches on the main paths: the F=1 frames, the requests served from
    # converted weights and the new presets' frames (#1); the train steps
    # (#2, #3), the weights drill's forward and the eval loop's frames (#3)
    rows = {"bev_pool_pooled": (kern["bf16"], main_res["launches"]["bev_pool_pooled"]
                                + sum(weights["launches_per_request"])
                                + new_presets["launches"]["bev_pool_pooled"]),
            "bev_pool_sorted": (sorted_res["full_bf16"],
                                train["full"]["launches"]["bev_pool_sorted"]),
            "bev_pool_sorted2": (sorted_res["band_spray_bf16"],
                                 train["banded"]["launches"]["bev_pool_sorted2"]
                                 + weights["drill_launches"]["bev_pool_sorted2"]
                                 + eval_loop["launches_sorted2"]),
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
                   "batched_temporal": batched, "text_tower": text, "serve_f1": serve_f1,
                   "serve_t2": serve_t2, "metrics": metrics, "weights_tiny": weights_tiny,
                   "weights": weights, "presets": new_presets, "precision": precision,
                   "data_plane": data_plane, "eval_tiny_parity": eval_tiny,
                   "eval_loop": eval_loop,
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
