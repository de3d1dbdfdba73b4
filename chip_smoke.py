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
  5. the serving path at a small size on the card against the CPU (depth,
     voxel outputs, class grids off near-ties);
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
     sequences of 77 tokens) on the card, with its time, held against the
     CPU's rows of 11 prompts and the bg row;
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
     numpy, loader frames/s over 8 frames with 2 and 4 workers in thread
     and in process mode (forked after the card's context exists);
 19. the eval loop, a main path: the tiny fixture's `test` with mirror
     files card vs CPU, then through `cli/main.py` `main` at full VEON-B
     width with seeded weights, fp32: `test` over 4 frames (kernel #3 once
     per frame), `--pipeline 2` and `--raw-uint8` (equal grids),
     `--num-temporal 2` (#3 twice per frame), `test --retrieval` on a
     3-item CSV, `cache-depth` on 2 frames (idempotent), and `benchmark
     --eval` in bf16 over 12 frames, whose JSON line is logged;
 20. phase 5 on the ZoeDepth-NK branch (the tiny preset with the JAX
     tests' tiny zoe tower), card vs CPU;
 21. zoe serving, a main path: phase 6 on `presets.veon_b_zoe(
     compute_dtype="bfloat16")` at full width (256x704 midas depth input,
     kernel #1 once per frame), then the stage breakdown with the depth
     tower split into BEiT trunk, MiDaS decoder and bins head, a profiled
     frame, and the attention kernels of the depth tower (the SDPA backend
     that takes BEiT's float bias);
 22. zoe streaming, a main path: phase 9 on `veon_b_zoe(num_temporal=2,
     compute_dtype="bfloat16")`, 4 calls, #1 once per call;
 23. zoe weights day, a main path: full-width files (SAN ViT-B, a
     ZoeDepth-NK dump with LoRA r=8 at trained scales, BPE), every key read
     but the ignored ones, read + convert and load timed; `serve --preset
     veon_b_zoe` F=1 (2 requests) and T=2 (3 requests) on the socket, equal
     to the direct calls; `selftest --weights-dir` (#3 once); 2 veon_l_zoe
     fp32 frames with the converted tower;
 24. veon_b_zoe bf16 against fp32 on the converted weights (the battery);
 25. zoe evaluation, a main path (run with phase 19's shard): `test
     --preset veon_b_zoe` on 4 frames (#3 once per frame), `cache-depth`
     on 2 frames;
 26. the training recipe at tiny size, card vs CPU: two stage-1 steps of
     the tiny DA-V2 (LoRA r=2) and the tiny zoe tower, `train_epochs` over
     one epoch of a 3-frame fixture, and a save/resume step against the
     straight run on the card;
 27. stage 2 through the CLI, a main path: `train --preset veon_b` fp32 on
     2 frames of phase 19's shard with its LiDAR sweeps, `--epochs 1`
     then `--epochs 2 --auto-resume` (epoch 2 alone), #3 once per step;
     `--accum-steps 2` (params move every second step); `publish --ema`,
     `test --ckpt` on it (#3 once per frame), `test --all-ckpts
     --sweep-from 1` over both checkpoints, `--ema` on the published one
     refused;
 28. stage 1 through the CLI, a main path: `pretrain-depth --preset
     veon_b` on 4 frames and `--preset veon_b_zoe` on 2, fp32, at the full
     input resolution: the base trunk bit-unchanged, adapters and head
     moved;
 29. the overfit drill `stage2_overfit` on the card and on the CPU, from
     CPU-seeded and card-seeded weights: the JAX test's loss margins
     everywhere, the mIoU margin's verdict the CPU's;
 30. temporal training at the tiny preset, card vs CPU: one F=2 step on
     each route of the deformable attention (stencil, grid_sample) from
     the same CPU-seeded weights, phase 26's tolerances, #3 twice;
 31. temporal training through the CLI, a main path: `train --preset
     veon_b --num-temporal 2 --temporal-start-epoch 1 --epochs 2` fp32 on
     2 frames of the shard with LiDAR sweeps (#3 once per epoch-0 step,
     twice per epoch-1 step), one `--auto-resume` epoch, `test
     --num-temporal 2 --ckpt` on its checkpoint; ms/step and peak per
     epoch; `train_entry` bf16 at F=2 and F=4 (peaks, the temporal
     fusion's autograd bytes on both routes) and one F=2 step with
     lss_banded=False (#2 twice);
 32. data parallel on the card (run with phase 19's shard): (a) VEON-B
     bf16 under a one-rank NCCL group against the plain step (bit-equal
     where the plain step repeats bit for bit), then 12 warm steps of
     each, alternating, medians with their spread; (b) two gloo ranks
     sharing the card, tiny, one step, against the same two ranks on the
     CPU; (c) a main path: `train --preset veon_b --dist-num-processes 2
     --dist-coordinator` fp32 as two processes sharing the card over gloo
     on 4 frames of the shard with LiDAR sweeps, 2 steps per rank: #3 once
     per step per rank, rank 0 alone writes, the ranks end bit-equal. The
     ranks are this script's own processes (`--dp-worker`). Phases 27, 31
     and 32(c) pass `--remat none`, the step they measured before the
     CLI's default `full` recomputed;
 33. weights-day parity, a main path (run after phase 17, on phase 15's
     files): the example batch through the converted VEON-B model with the
     pools' plain versions, written as a reference dump in the reference's
     torch layouts; `parity --preset veon_b --dumps` fp32 on the card, every
     row ok, #3 once; one boundary x 1.05 through the CLI in a process of
     its own: exit 1, that row alone; the T=2 and zoe legs at the tiny
     preset; dump bytes, compare s, peak host memory;
 34. `vis --preset veon_b` through the CLI (run with phase 19's shard), a
     main path: the synthetic frame and the shard's first through --ann,
     image shapes, one PLY point per non-free voxel, six overlays, #3 once
     per run;
 35. `train --preset veon_b --remat none|full|dots_saveable` fp32 through
     the CLI on 2 frames of the shard, a main path (#3 once per step), and
     `train_entry` bf16 per policy: losses and running stats against
     none's, ms/step and peaks;
 36. REC_CROSS_ATTN=False with the bilinear rec downsample: the tiny preset
     card vs CPU, then a main path at VEON-B bf16 through `entry` (#1 once
     per frame), unit-norm mask embeddings, the dense mask's bytes;
 37. the profiling tools: `lift_microbench` at VEON-B lift shapes (#2 once
     per call), `flops` of the F=1 bf16 forward, a parsed Chrome trace of
     one frame.
Phases 11-12 serve through the CLI's handler, which computes in the
preset's dtype: fp32 since the CLI keeps it.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
Without a card it exits non-zero and prints no result.
"""

import contextlib
import copy
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
    """Metric depth U(1.5, 59.5) m at half input resolution for each of the
    cfg's frames, constant over each 8x8 block (the lift's min-pool keeps
    it): a quarter of the pixels lie past the ~45.8 m spray threshold."""
    import numpy as np

    h, w = cfg.feat_hw
    d = np.random.default_rng(17).uniform(1.5, 59.5, (B, cfg.num_temporal, cfg.data.num_cams,
                                                      h, w))
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


def small_parity_phase(cfg=None):
    """A serving path at a small size in fp32 (default: the tiny preset):
    card vs CPU, same weights: the rig precompute equal, the depth estimate
    and voxel outputs within 1e-3, the class grids equal off near-ties."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import entry
    from veon_tpu_torch.model.veon import VOXEL_OUTPUTS

    cfg = cfg or presets.veon_tiny_test()
    cpu, (imgs, depth_imgs) = entry(cfg, device="cpu", seed=3)
    gpu, (imgs_g, depth_g) = entry(cfg, device="cuda", seed=3)
    gpu.model.load_state_dict(cpu.model.state_dict())
    for k in ("order", "rk_pooled", "ranks"):
        if not torch.equal(cpu.metas["lift_sorted"][k], gpu.metas["lift_sorted"][k].cpu()):
            raise AssertionError(f"rig precompute {k} differs between CPU and card")
    with torch.no_grad():
        d_cpu, d_gpu = cpu.model.estimate_depth(depth_imgs), gpu.model.estimate_depth(depth_g)
    torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=1e-3, atol=1e-3, msg="depth")
    depth_diff = (d_gpu.cpu() - d_cpu).abs().max().item()
    want, got = cpu.outputs(imgs, depth_imgs), gpu.outputs(imgs_g, depth_g)
    worst = 0.0
    for k in VOXEL_OUTPUTS:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-3, atol=1e-3, msg=k)
        worst = max(worst, (got[k].cpu() - want[k]).abs().max().item())
    differ = (gpu(imgs_g, depth_g).cpu() != cpu(imgs, depth_imgs)).numpy()
    ties = near_ties(want, cpu.membership).numpy()
    if (differ & ~ties).any():
        raise AssertionError(f"{int((differ & ~ties).sum())} classes differ between card and "
                             "CPU off near-ties")
    log(f"small-input parity ({type(cpu.model.depth).__name__} depth tower, depth input "
        f"{tuple(depth_imgs.shape)}, fp32, card vs CPU plain path): depth max abs diff "
        f"{depth_diff:.3g}, {worst:.3g} over {VOXEL_OUTPUTS}, classes differ in "
        f"{int(differ.sum())} voxels ({int(ties.sum())} near-ties)")
    return dict(depth_max_abs=depth_diff, max_abs=worst, differ=int(differ.sum()),
                near_ties=int(ties.sum()))


def label(cfg):
    """"veon_b bf16", "veon_b_zoe T=2 fp32", ...: a full-width config's name."""
    name = "veon_b_zoe" if cfg.depth_mode == "zoedepth" else "veon_b"
    T = f" T={cfg.num_temporal}" if cfg.num_temporal > 1 else ""
    return f"{name}{T} {'bf16' if cfg.compute_dtype == 'bfloat16' else 'fp32'}"


def main_path(cfg, frames=3):
    """F=1 serving, a main path: `entry(cfg)` on the card with seeded
    weights, `frames` frames, kernel #1 exactly once per frame and no
    other launch read around exactly those frames."""
    from veon_tpu_torch.entry import entry

    base = phase_base()
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
    above = peak - base
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
    log(f"main path {label(cfg)}: setup {setup_s:.1f} s, frames ms {[round(t, 3) for t in times]}, "
        f"median {statistics.median(times):.3f} ms/frame, peak memory {peak / 2**30:.3f} GiB "
        f"({above / 2**30:.3f} above the phase's start), launches {launches}, class histogram "
        f"{classes}")
    return server, (imgs, depth_imgs), dict(
        frame_ms=times, median_ms=statistics.median(times), peak_bytes=peak,
        peak_above_start_bytes=above, launches=launches, setup_s=setup_s, classes=classes)


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


def temporal_main_path(cfg=None, calls=4):
    """Streaming temporal serving at full width: `temporal_entry(cfg)`
    (default VEON-B T=2 bf16; seeded random weights), `calls` calls of the
    drive, every launch count read around exactly those calls: kernel #1
    once per call, no other kernel."""
    from veon_tpu_torch.entry import temporal_entry

    base = phase_base()
    t0 = time.perf_counter()
    session, reqs = temporal_entry(cfg, device="cuda", seed=0, frames=calls)
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
    log(f"temporal main path {label(session.model.cfg)}: setup {setup_s:.1f} s, call ms "
        f"{[round(t, 3) for t in times]} (call 1 cold), steady median {steady:.3f} ms/call, peak "
        f"memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} above the phase's start), "
        f"launches {launches}, class histogram {classes}")
    return session, reqs, dict(call_ms=times, steady_median_ms=steady, peak_bytes=peak,
                               peak_above_start_bytes=peak - base,
                               launches=launches, setup_s=setup_s, classes=classes,
                               depth_input=tuple(reqs[0]["depth_imgs"].shape[3:5]))


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
    sequences of 77 tokens, on the card; the CPU builds the rows of the
    first 11 prompts (154 sequences; a row depends on its prompt alone)
    and the bg row, and the card's rows are held to those unit rows (the
    classifier over exp(logit_scale)) within 5e-5 (fp32, 12 layers summed
    in other orders). Build times on the host clock: the card's first
    build (cold) and a second one, and the CPU's of its 11 rows."""
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
    ms, ovw, cpu_prompts = {}, {}, prompts[:11]
    for name, d, ps in (("card_cold", "cuda", prompts), ("card", "cuda", prompts),
                        ("cpu", "cpu", cpu_prompts)):
        tower = build_text_tower(cfg, d, seed=0)
        t = time.perf_counter()
        ovw[name] = text_classifier(cfg, ps, tower, bg, logit_scale, require_bpe=False)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t) * 1e3
        del tower
    scale = float(np.exp(logit_scale))
    w = ovw["card"].cpu()
    if tuple(w.shape) != (len(prompts) + 1, cfg.san.clip_embed_dim) or not torch.isfinite(w).all():
        raise AssertionError(f"veon_b classifier {tuple(w.shape)} not finite or misshaped")
    err = ((w[list(range(len(cpu_prompts))) + [-1]] - ovw["cpu"]).abs().max() / scale).item()
    if not err <= 5e-5:
        raise AssertionError(f"veon_b text classifier: card vs CPU {err:.3g} of a unit row > 5e-5")
    log(f"text tower: tiny card vs CPU max abs diff {tiny_err:.3g}; veon_b fp32 classifier "
        f"nuscenes_brief x {cfg.san.template_set} ({n_seq} sequences of 77 tokens): build "
        f"{ms['card']:.3f} ms on the card ({ms['card_cold']:.3f} cold); the CPU's rows of "
        f"{len(cpu_prompts)} prompts and bg in {ms['cpu']:.3f} ms, card vs CPU max abs diff "
        f"{err:.3g} of a unit row")
    return dict(tiny_max_abs_diff=tiny_err, sequences=n_seq, build_ms=ms["card"],
                cpu_prompts=len(cpu_prompts),
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
# a ZoeDepth-NK dump's BEiT blocks also carry their index buffers
ZOE_IGNORED_SUFFIXES = ("num_batches_tracked", "relative_position_index")
IGNORED_KEYS = ("ov_classifier.attn_mask",)
IGNORED_PREFIXES = ("depth_head.scratch.refinenet4.resConfUnit1.",
                    "core.core.scratch.refinenet4.resConfUnit1.")


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
    neither converter reads (the depth dump's of `cfg`'s branch), the
    ignored ones left out; (count of keys, unread keys)."""
    from veon_tpu_torch.ckpt import convert as C

    san = _ReadKeys(C.load_torch_state_dict(paths["san"]))
    depth = _ReadKeys(C.load_torch_state_dict(paths["depth"]))
    C.convert_san_semantic(san, cfg)
    zoe = cfg.depth_mode == "zoedepth"
    if zoe:
        C.convert_zoedepth(depth, cfg.zoe)
    else:
        C.convert_dav2(depth, cfg.depth)
    suffixes = ZOE_IGNORED_SUFFIXES if zoe else IGNORED_SUFFIXES
    unread = sorted(k for sd in (san, depth) for k in sd if k not in sd.read
                    and not k.endswith(suffixes) and k not in IGNORED_KEYS
                    and not k.startswith(IGNORED_PREFIXES))
    return len(san) + len(depth), unread


def with_tiny_zoe(cfg):
    """`cfg` on the zoe branch with the JAX tests' tiny ZoeDepth-NK tower
    (`tests/test_torch_mirror.py`)."""
    _tests_on_path()
    from test_torch_mirror import with_tiny_zoe as tiny

    return tiny(cfg)


def _tests_on_path():
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)


def mirror_weights(cfg, root):
    """Reference-layout checkpoint files for `cfg` under `root` (a
    semantic dump with the text tower, a depth dump of cfg's branch with
    LoRA adapters, DA-V2 r=16 or ZoeDepth-NK r=8, a learned BPE merges
    file: `tests/test_torch_mirror.py`); (paths, seconds, bytes)."""
    _tests_on_path()
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


def weights_main_path(frame_ms, root):
    """Weights day at full VEON-B width (fp32, the preset's dtype), a main
    path: full-width reference-layout files (SAN ViT-B with the text tower,
    DA-V2-L with LoRA r=16), every key read but the ignored ones; the
    files read and converted, the model loaded (timed apart); `selftest
    --weights-dir` with its five step lines, kernel #3 once in its forward
    and no other launch; then a `TensorServer` with the handler of `serve
    --load-from --depth-load-from --bpe-path` answering 3 requests with text
    tokens, kernel #1 once per request, each `pred` equal to `FrameServer`
    on the same loaded model and the classifier equal to `text_classifier`
    on the loaded tower. The files stay in `root` for phase 33. Returns the
    converted variables for phase 17."""
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
    except BaseException:
        shutil.rmtree(d, ignore_errors=True)
        raise
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


def precision_phase(variables, preset="veon_b"):
    """The bf16 forward against the fp32 one at full width on the card
    (VEON-B, or `preset`), the converted weights of phase 15 (23 for
    veon_b_zoe) in both, the same example frame: flip rate < 0.15,
    feat_occ cosine > 0.98, occupancy-probability MAD < 0.05 (the CPU
    battery's bounds, `tests/test_precision.py`); and the depth
    estimates' median relative difference, reported."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import entry
    from veon_tpu_torch.eval.precision import precision_battery

    outs, depth = {}, {}
    for dt in ("float32", "bfloat16"):
        server, (imgs, depth_imgs) = entry(getattr(presets, preset)(compute_dtype=dt),
                                           device="cuda", variables=variables)
        outs[dt] = server.outputs(imgs, depth_imgs)
        with torch.no_grad():
            depth[dt] = server.model.estimate_depth(depth_imgs).float()
        membership = server.membership
        del server
        torch.cuda.empty_cache()
    depth_rel = float(((depth["bfloat16"] - depth["float32"]).abs()
                       / depth["float32"].abs().clamp_min(1e-3)).median())
    r = precision_battery(outs["float32"], outs["bfloat16"], membership)
    log(f"bf16 vs fp32, {preset} full width, converted weights: {r}, depth median relative "
        f"difference {depth_rel:.4g} (bounds: flip < 0.15, cos > 0.98, MAD < 0.05)")
    if not (r["flip_rate"] < 0.15 and r["feat_cos"] > 0.98 and r["occ_prob_mad"] < 0.05):
        raise AssertionError(f"{preset} bf16 divergence beyond the CPU battery's bounds: {r}")
    return dict(r, depth_median_rel=depth_rel)


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
    equal to numpy's division; then `loader_bench.loader_fps` over the
    first 8 frames of the 900x1600 JPEG shard under root with 2 and 4
    workers in thread and in process mode (forked after the card's context
    exists; at 0.9-3 frames/s the rates need no more frames, and the
    script's time does)."""
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
    pkl = shard_paths(root, 8, "loader")
    fps = {}
    for mode in ("thread", "process"):
        for workers in (2, 4):
            fps[f"{mode}_{workers}"] = loader_fps(pkl, root, workers, mode)
    log(f"loader frames/s on the 900x1600 shard (VEON-B eval samples, 8 frames, "
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


# ---------------------------------------------------------------------------
# Phases 20-25: the ZoeDepth-NK depth branch (veon_b_zoe / veon_l_zoe)
# ---------------------------------------------------------------------------


def attention_kernels(fn):
    """The fused attention kernels one call of fn runs (names with fmha,
    flash, sdpa or attention in them), with their device ms, from the
    profiler; SDPA's math backend runs none (a bmm, softmax, bmm)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = {}
    for e in prof.key_averages():
        name = e.key.lower()
        if e.device_type == torch.autograd.DeviceType.CUDA and any(
                s in name for s in ("fmha", "flash", "sdpa", "attention")):
            found[e.key[:90]] = (round(e.self_device_time_total / 1e3, 3), e.count)
    return found


def zoe_breakdown(server, imgs, depth_imgs):
    """Where a zoe frame's time goes, from one more frame: CUDA events around
    each tower, the depth tower split into the BEiT trunk, the MiDaS decoder
    and the bins head; then one profiled frame (busy share, top kernels) and
    the attention kernels of one depth-tower call (the SDPA backend that
    takes BEiT's float bias)."""
    model = server.model
    marks = {}
    mods = {name: getattr(model, name) for name in STAGES}
    hooks = hook_stages(dict(mods, zoe_trunk=model.depth.core.pretrained,
                             zoe_core=model.depth.core), marks)
    start = _event()
    server(imgs, depth_imgs)
    end = _event()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    total = start.elapsed_time(end)
    s = stage_ms(marks)
    stages = {k: s[k] for k in STAGES}
    stages["other"] = total - sum(stages.values())
    stages["depth_trunk"] = s["zoe_trunk"]
    stages["depth_decoder"] = s["zoe_core"] - s["zoe_trunk"]
    stages["depth_bins_head"] = s["depth"] - s["zoe_core"]
    log(f"zoe stage ms (device timeline, frame {total:.3f} ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    prof = profiled(lambda: server(imgs, depth_imgs), 12)
    with torch.no_grad():
        attn = attention_kernels(lambda: model.estimate_depth(depth_imgs))
    log(f"zoe depth tower's attention kernels (name: device ms, count): {attn or 'none: math'}")
    return dict(prof, stage_ms=stages, frame_events_ms=total, depth_attention_kernels=attn)


def zoe_main_path():
    """Phase 21, a main path: `main_path` on `presets.veon_b_zoe(compute_dtype=
    "bfloat16")` (3 frames, kernel #1 once each), its depth input 256x704
    and depth estimate finite, then where a frame's time goes
    (`zoe_breakdown`)."""
    from veon_tpu_torch.configs import presets

    server, (imgs, depth_imgs), res = main_path(presets.veon_b_zoe(compute_dtype="bfloat16"))
    if tuple(depth_imgs.shape) != (1, 1, 6, 256, 704, 3):
        raise AssertionError(f"zoe depth input {tuple(depth_imgs.shape)}, expected 256x704")
    with torch.no_grad():
        depth = server.model.estimate_depth(depth_imgs).float()
    if not torch.isfinite(depth).all() or tuple(depth.shape) != (1, 1, 6, 256, 704):
        raise AssertionError(f"zoe depth {tuple(depth.shape)} not finite")
    res["depth_range_m"] = (float(depth.min()), float(depth.max()))
    res["breakdown"] = zoe_breakdown(server, imgs, depth_imgs)
    del server
    torch.cuda.empty_cache()
    return res


def zoe_weights_phase():
    """Phase 23, weights day for zoe, a main path: full-width
    reference-layout files for veon_b_zoe (the SAN ViT-B dump with the text
    tower, a ZoeDepth-NK dump with LoRA r=8 at trained scales under
    depth_pretrain/zoedepth_pretrain.pth, the BPE merges), every key read
    but the ignored ones (the BEiT index buffers among them); read +
    convert and load timed; a `TensorServer` with the handler of `serve
    --preset veon_b_zoe` (fp32) answering 2 F=1 requests (kernel #1 once
    each, pred equal to its `FrameServer`), then one of `serve --preset
    veon_b_zoe --num-temporal 2` with the zoe dump alone (the semantic dump
    is a T=1 one) answering 3 drive requests (#1 once each, pred equal to
    a direct `TemporalSession` replay); `selftest --preset
    veon_b_zoe --weights-dir` (#3 once); then 2 veon_l_zoe fp32 frames with
    the converted zoe tower and seeded SAN-L families (#1 once each).
    Returns the converted variables for phase 24 (`precision_phase`)."""
    import contextlib
    import io

    from veon_tpu_torch.ckpt.from_jax import load_families
    from veon_tpu_torch.cli.main import build_serve_handler, load_checkpoints, main as cli_main
    from veon_tpu_torch.cli.main import parser
    from veon_tpu_torch.cli.shapes import example_batch_full, example_drive
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import build_model, entry
    from veon_tpu_torch.nn.text import ClipTokenizer
    from veon_tpu_torch.serve.client import TensorClient
    from veon_tpu_torch.serve.server import TensorServer
    from veon_tpu_torch.serve.streaming import TemporalSession

    cfg = presets.veon_b_zoe()
    base = phase_base()
    root = tempfile.mkdtemp(prefix="veon_zoe_ckpts")

    def args(T):
        # the semantic dump holds a T=1 occupancy head: at T=2 the CLI seeds
        # the semantic families and loads the zoe dump alone
        san = ["--load-from", paths["san"]] if T == 1 else []
        return parser().parse_args(["serve", "--preset", "veon_b_zoe", "--num-temporal", str(T),
                                    *san, "--depth-load-from", paths["depth"],
                                    "--bpe-path", paths["bpe"]])

    served = {}
    try:
        paths, write_s, nbytes = mirror_weights(cfg, root)
        if not paths["depth"].endswith(os.path.join("depth_pretrain", "zoedepth_pretrain.pth")):
            raise AssertionError(f"zoe depth file {paths['depth']}")
        n_keys, unread = unread_keys(cfg, paths)
        if unread:
            raise AssertionError(f"veon_b_zoe checkpoint keys no converter reads: {unread[:8]}")
        t = time.perf_counter()
        variables, _extras = load_checkpoints(cfg, paths["san"], paths["depth"])
        convert_s = time.perf_counter() - t
        t = time.perf_counter()
        model = build_model(cfg, torch.device("cuda"), 0, variables)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        del model
        torch.cuda.empty_cache()
        tok = ClipTokenizer(paths["bpe"])
        for T in (1, 2):
            t = time.perf_counter()
            handler, required, expect, exclusive = build_serve_handler(args(T))
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t
            if handler.cfg.compute_dtype != "float32" or "(1, 1, 6, 256, 704, 3)" not in expect:
                raise AssertionError(f"zoe T={T} handler: {handler.cfg.compute_dtype}, {expect}")
            if T == 1:
                imgs, depth_imgs, _ = example_batch_full(cfg, device="cpu")
                reqs = [{"imgs": imgs.numpy(), "depth_imgs": depth_imgs.numpy()}] * 2
            else:
                _rig, drive = example_drive(handler.cfg, 3, device="cpu", seed=0)
                reqs = [{k: v.numpy() for k, v in r.items()} for r in drive]
            reqs = [dict(r, text_tokens=tok.tokenize(["a parked red car"])) for r in reqs]
            d = socket_dir()
            srv = TensorServer(handler, os.path.join(d, "s.sock"), required=required,
                               exclusive=exclusive)
            srv.start()
            outs, rt, per_req = [], [], []
            try:
                with TensorClient(srv.socket_path) as c:
                    kernels = reset_launches()
                    for i, r in enumerate(reqs):
                        o, ms, n = _served(c, kernels, r, f"zoe T={T} request {i}")
                        outs.append(o)
                        rt.append(ms)
                        per_req.append(n)
            finally:
                srv.stop()
                shutil.rmtree(d, ignore_errors=True)
            if T == 1:
                want = [handler.server(imgs.cuda(), depth_imgs.cuda()).to(torch.uint8).cpu()
                        .numpy()] * len(reqs)
                with torch.no_grad():
                    attn32 = attention_kernels(
                        lambda: handler.server.model.estimate_depth(depth_imgs.cuda()))
            else:
                s = handler.session
                direct = TemporalSession(s.model, s.ov_weight, s.membership, rig_metas=s.rig_metas)
                want = [direct.infer(torch.from_numpy(r["imgs"]).cuda(),
                                     torch.from_numpy(r["depth_imgs"]).cuda(),
                                     {"lidarego2global": torch.from_numpy(
                                         r["lidarego2global"]).cuda()})["pred"].cpu().numpy()
                        for r in reqs]
                del s, direct
            for i, (o, w) in enumerate(zip(outs, want)):
                if not np.array_equal(o["pred"], w):
                    raise AssertionError(f"zoe T={T} request {i}: pred differs from the direct "
                                         f"call in {int((o['pred'] != w).sum())} voxels")
                if not np.isfinite(o["retrieval"]).all():
                    raise AssertionError(f"zoe T={T} request {i}: retrieval not finite")
            served[f"t{T}"] = dict(setup_s=setup_s, server_ms=[float(o["server_ms"][0])
                                                               for o in outs],
                                   round_trip_ms=rt, launches_per_request=per_req,
                                   classes=np.bincount(outs[-1]["pred"].reshape(-1),
                                                       minlength=18).tolist())
            del handler, srv
            gc.collect()
            torch.cuda.empty_cache()
        kernels = reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            drill = cli_main(["selftest", "--preset", "veon_b_zoe", "--weights-dir", root])
        drill_launches = {k: fn.launches for k, fn in kernels.items()}
        expect_launches(drill_launches, {k: int(k == "bev_pool_sorted2") for k in kernels},
                        "selftest --preset veon_b_zoe --weights-dir")
        steps = [ln for ln in out.getvalue().splitlines() if ln.startswith("[")]
        if [s[:5] for s in steps] != ["[1/5]", "[2/5]", "[4/5]", "[5/5]"] \
                or "zoedepth_pretrain.pth" not in steps[0] or "WARNING" in out.getvalue():
            raise AssertionError(f"zoe selftest --weights-dir step lines: {steps}")
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lcfg = presets.veon_l_zoe()
    server, (imgs, depth_imgs) = entry(lcfg, device="cuda", seed=0)
    load_families(server.model, {"params": {"depth": variables["params"]["depth"]}})
    l_ms, l_launches = _frames(server, imgs, depth_imgs, 2)
    expect_launches(l_launches, {k: 2 * int(k == "bev_pool_pooled") for k in l_launches},
                    "veon_l_zoe")
    for k, v in server.outputs(imgs, depth_imgs).items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"veon_l_zoe output {k} not finite")
    del server
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"zoe weights day veon_b_zoe fp32: files written in {write_s:.1f} s ({nbytes} B), "
        f"{n_keys} keys all read but the ignored (relative_position_index, "
        f"num_batches_tracked, refinenet4's resConfUnit1, the text mask); read + convert "
        f"{convert_s:.3f} s, load onto the card {load_s:.3f} s; "
        + "; ".join(f"{k} server: setup {v['setup_s']:.1f} s, server_ms "
                    f"{[round(x, 3) for x in v['server_ms']]}, round trip ms "
                    f"{[round(x, 3) for x in v['round_trip_ms']]}, kernel #1 per request "
                    f"{v['launches_per_request']}" for k, v in served.items())
        + f"; pred equal to the direct calls; the fp32 depth tower's attention kernels "
        f"{attn32 or 'none: math'}; selftest --weights-dir: mIoU {drill['miou']:.4f}, "
        f"launches {drill_launches}; veon_l_zoe fp32 frames ms {[round(x, 3) for x in l_ms]}, "
        f"launches {l_launches}")
    for ln in steps:
        log("  " + ln)
    return variables, dict(write_s=write_s, file_bytes=nbytes, keys=n_keys, convert_s=convert_s,
                           load_s=load_s, served=served, depth_attention_kernels_fp32=attn32,
                           drill_miou=drill["miou"],
                           drill_steps=steps, drill_launches=drill_launches,
                           veon_l_zoe=dict(frame_ms=l_ms, launches=l_launches), peak_bytes=peak,
                           launches_pooled=sum(sum(v["launches_per_request"])
                                               for v in served.values())
                           + l_launches["bev_pool_pooled"])


def zoe_eval_phase(root, frames=4):
    """Phase 25, a main path: `test --preset veon_b_zoe` (fp32, seeded
    weights) on the first `frames` frames of the shard, kernel #3 exactly
    once per frame; then `cache-depth --preset veon_b_zoe` on 2 frames
    ((256, 704) float32 per camera, idempotent)."""
    pkl = shard_paths(root, frames, "zoe_eval")
    with captured() as rec:
        res, out, s, launches = run_cli(["test", "--preset", "veon_b_zoe", "--data-root", root,
                                         "--ann", pkl, "--workers", "2"])
    line = next(ln for ln in out.splitlines() if ln.startswith("inference done"))
    expect_launches(launches, {n: frames if n == "bev_pool_sorted2" else 0 for n in launches},
                    "test --preset veon_b_zoe")
    g = rec.grids[0]
    if g.shape != (frames, 200, 200, 16) or g.max() > 17 or not np.isfinite(res["mIoU"]):
        raise AssertionError(f"zoe test: grids {g.shape} max {g.max()}, mIoU {res['mIoU']}")
    log(f"test veon_b_zoe fp32 ({frames} frames): {line}; {s:.3f} s with the model build; "
        f"mIoU {res['mIoU']:.4f}; launches {launches}")
    cache = os.path.join(root, "zoe_depth_cache")
    argv = ["cache-depth", "--preset", "veon_b_zoe", "--data-root", root, "--ann",
            shard_paths(root, 2, "zoe_cache"), "--workers", "2", "--cache-dir", cache]
    n, _out, cs, _l = run_cli(argv)
    files = [os.path.join(cache, t[:2], t, f"{t}-{c}.npy") for t in ("tok0", "tok1") for c in CAMS]
    for f in files:
        d = np.load(f)
        if d.shape != (256, 704) or d.dtype != np.float32 or not np.isfinite(d).all():
            raise AssertionError(f"zoe cache-depth {f}: {d.shape} {d.dtype}")
    again = run_cli(argv)[0]
    if n != len(files) or again != 0:
        raise AssertionError(f"zoe cache-depth wrote {n} then {again} files, expected 12 then 0")
    log(f"cache-depth veon_b_zoe fp32: {n} files in {cs:.3f} s, (256, 704) float32; a second "
        f"run wrote {again}")
    return dict(miou=res["mIoU"], seconds=s, line=line, launches=launches,
                cache_files=n, cache_seconds=cs)


# ---------------------------------------------------------------------------
# Phases 26-29: the two-stage training recipe
# ---------------------------------------------------------------------------


def _moves_agree(want, got, start, names, what):
    """The move from `start` of the `names` entries as one vector, card
    against CPU: cosine > 0.999 and norm within 1%. Adam's first steps move
    each entry by about lr * sign(g), so an entry whose gradient is at
    rounding level may go either way: no per-entry bound."""
    w, g = (torch.cat([(src[n].detach().cpu() - start[n]).reshape(-1) for n in sorted(names)])
            .double() for src in (want, got))
    cos = float(w @ g / (w.norm() * g.norm()))
    ratio = float(g.norm() / w.norm())
    if not (w.abs().max() > 0 and cos > 0.999 and abs(ratio - 1) < 1e-2):
        raise AssertionError(f"{what}: moves card vs CPU cosine {cos}, norm ratio {ratio}")
    return cos, ratio


def _stage1_tiny(mode):
    """(tower on the CPU, trainable predicate, frames, GT): the JAX drill's
    tiny DA-V2 (r=2) or tiny zoe tower, seeded, and GT near its own first
    prediction (x U(0.7, 1.4), 30% missing) so SILog stays below its clip."""
    from veon_tpu_torch.configs.base import DepthConfig, ZoeConfig
    from veon_tpu_torch.nn.dpt import DepthAnythingV2
    from veon_tpu_torch.nn.layers import init_random_
    from veon_tpu_torch.nn.zoedepth import ZoeDepthNK
    from veon_tpu_torch.ops.resize import resize_bilinear
    from veon_tpu_torch.train.depth_pretrain import depth_trainable, zoe_trainable
    from veon_tpu_torch.utils.overfit import TINY_ZOE

    if mode == "zoe":
        tower, pred, hw, ghw = ZoeDepthNK(ZoeConfig(**TINY_ZOE), lora=True), zoe_trainable, \
            (64, 96), (64, 96)
    else:
        tower = DepthAnythingV2(DepthConfig(encoder="vits", features=8, out_channels=(4, 8, 8, 8),
                                            lora_r=2), lora=True)
        pred, hw, ghw = depth_trainable, (28, 42), (32, 48)
    init_random_(tower, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(11)
    imgs = torch.from_numpy(rng.standard_normal((1, 1, 2) + hw + (3,)).astype(np.float32))
    with torch.no_grad():
        p = tower(imgs[:, 0].reshape((-1,) + imgs.shape[3:]))
        p = resize_bilinear(p[..., None], (ghw[0] // 2, ghw[1] // 2), align_corners=True)[..., 0]
    gt = np.repeat(np.repeat(p.numpy()[None], 2, -2), 2, -1)
    gt = gt * rng.uniform(0.7, 1.4, gt.shape)
    gt[rng.random(gt.shape) < 0.3] = 0.0
    return tower, pred, imgs, torch.from_numpy(gt.astype(np.float32))


def train_stages_parity_phase(root):
    """Phase 26, the training recipe at tiny size, card vs CPU (plain
    versions), fp32, same weights: (a) two stage-1 steps of the JAX
    drill's tiny DA-V2 (LoRA r=2) and tiny zoe: losses within 1e-4, the
    first gradient (Adam's moments) within 1e-3 of its largest entry, the
    trainable params' move as one vector at cosine > 0.999 and norm within
    1%, the frozen trunk bit-unchanged on both; (b) `train_epochs` over one
    epoch of the tiny 3-frame fixture: three log lines each, the losses
    of every step within 1e-4, params and EMA within 1e-5, running stats
    within 1e-4, relative where above 1; (c) on the card, two
    steps, a checkpoint, a model of another seed loaded from it and one more
    step against three straight steps: every param, running stat, EMA entry
    and Adam moment and the last losses within 1e-5 (relative above 1),
    and bit-equal where two straight runs on the card are (the backward's
    atomic sums may make them differ)."""
    from veon_tpu_torch.ckpt import io as tio
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.configs.base import GridConfig, LossConfig
    from veon_tpu_torch.data.loader import DataLoader
    from veon_tpu_torch.data.nuscenes import NuScenesOccDataset, load_infos
    from veon_tpu_torch.entry import build_model, train_batch
    from veon_tpu_torch.nn import text as text_mod
    from veon_tpu_torch.train import step as tstep
    from veon_tpu_torch.train.depth_pretrain import make_depth_pretrain_step
    from veon_tpu_torch.train.loop import train_epochs

    out = {}
    for mode in ("dav2", "zoe"):
        cpu_tower, pred, imgs, gt = _stage1_tiny(mode)
        start = {n: p.detach().clone() for n, p in cpu_tower.named_parameters()}
        towers = {"cpu": cpu_tower, "cuda": copy.deepcopy(cpu_tower).cuda()}
        runs = {}
        for dev, tower in towers.items():
            tx = tstep.AdamW(lr=2e-4, warmup_iters=2, warmup_ratio=0.5)
            state = tstep.create_train_state(tower, tx, init_updates=0, predicate=pred)
            step = make_depth_pretrain_step(tower, tx, GridConfig(), LossConfig())
            batch = {"depth_imgs": imgs.to(dev), "gt_depth": gt.to(dev)}
            losses, mu1 = [], None
            for i in range(2):
                state, lo = step(state, batch)
                losses.append({k: float(v) for k, v in lo.items()})
                if i == 0:
                    mu1 = {n: v.detach().cpu().clone() for n, v in state.opt_state.mu.items()}
            runs[dev] = (tower, state, losses, mu1)
        (tc, sc, lc, mc), (tg, sg, lg, mg) = runs["cpu"], runs["cuda"]
        for a, b in zip(lc, lg):
            for k in a:
                if not math.isclose(a[k], b[k], rel_tol=1e-4, abs_tol=1e-5):
                    raise AssertionError(f"stage-1 {mode} {k}: card {b[k]} vs CPU {a[k]}")
        scale = max(v.abs().max().item() for v in mc.values())
        grad = max((mg[n] - v).abs().max().item() for n, v in mc.items()) / scale
        if grad > 1e-3:
            raise AssertionError(f"stage-1 {mode}: first gradient off by {grad:.3g} of the largest")
        trained = {n for n, p in tc.named_parameters() if p.requires_grad}
        cos, ratio = _moves_agree(dict(tc.named_parameters()), dict(tg.named_parameters()),
                                  start, trained, f"stage-1 {mode}")
        for t in (tc, tg):
            for n, p in t.named_parameters():
                if n not in trained and not torch.equal(p.detach().cpu(), start[n]):
                    raise AssertionError(f"stage-1 {mode}: frozen {n} moved")
        out[f"stage1_{mode}"] = dict(losses_cpu=lc, losses_card=lg, grad_rel_err=grad,
                                     move_cos=cos, move_norm_ratio=ratio,
                                     trainable=len(trained))
        log(f"stage-1 tiny {mode} card vs CPU: losses {lg[-1]} (CPU {lc[-1]}), first gradient "
            f"{grad:.3g} of the largest, move cosine {cos:.7f} norm ratio {ratio:.6f}, "
            f"{len(trained)} trainable tensors, frozen trunk bit-unchanged")

    from veon_tpu_torch.utils.loader_bench import make_frames

    pkl = make_frames(os.path.join(root, "tiny_train"), 3, hw=(90, 160), grid_shape=(20, 20, 4))
    cfg = presets.veon_tiny_test()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, src_size=(90, 160)))
    _, refl = text_mod.build_vocabulary(cfg.vocabulary)
    membership = text_mod.merge_matrix(refl)
    ovw = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (len(refl) + 1, cfg.san.clip_embed_dim)).astype(np.float32))
    # both models are built, the card's given the CPU's weights, before either trains
    models = {dev: build_model(cfg, torch.device(dev), 3, None) for dev in ("cpu", "cuda")}
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    runs = {}
    for dev, model in models.items():
        tx = tstep.AdamW()
        ds = NuScenesOccDataset(infos=load_infos(pkl), data_cfg=cfg.data, grid=cfg.grid,
                                num_temporal=1, is_train=True,
                                data_root=os.path.join(root, "tiny_train"))
        lines, losses = [], []
        step = tstep.make_train_step(model, tx, cfg, membership)

        def recorded(state, batch, step=step, losses=losses):
            state, lo = step(state, batch)
            losses.append({k: float(v) for k, v in lo.items()})
            return state, lo

        state = train_epochs(tstep.create_train_state(model, tx), recorded,
                             DataLoader(ds, shuffle=True, num_workers=1), ovw.to(dev),
                             max_epochs=1, work_dir=os.path.join(root, f"tiny_work_{dev}"),
                             log_interval=1, log_fn=lines.append)
        runs[dev] = (state, lines, losses)
    (sc, lc, lo_c), (sg, lg, lo_g) = runs["cpu"], runs["cuda"]
    if len(_loss_lines(lc)) != 3 or len(_loss_lines(lg)) != 3 or len(lo_c) != 3:
        raise AssertionError(f"train_epochs lines: {lc} / {lg}")
    loss_diff = {k: max(abs(a[k] - b[k]) / max(abs(a[k]), 1.0) for a, b in zip(lo_c, lo_g))
                 for k in lo_c[0]}
    bad = [k for k, d in loss_diff.items() if d > 1e-4]
    diffs = {}
    for what, a, b, tol in (
            ("params", dict(sc.model.named_parameters()), dict(sg.model.named_parameters()), 1e-5),
            ("ema", {**sc.ema_params}, {**sg.ema_params}, 1e-5),
            ("batch_stats", tstep.batch_stats(sc.model), tstep.batch_stats(sg.model), 1e-4)):
        diffs[what] = max(((b[n].detach().cpu() - v.detach()).abs()
                           / v.detach().abs().clamp_min(1.0)).max().item() for n, v in a.items())
        if diffs[what] > tol:
            bad.append(what)
    out["train_epochs"] = dict(lines_card=lg, lines_cpu=lc, losses_cpu=lo_c, losses_card=lo_g,
                               loss_diff=loss_diff, **diffs)
    log(f"train_epochs tiny, one epoch of 3 frames, card vs CPU (relative above 1): max loss "
        f"diffs {loss_diff}, per step {[[round(b[k] - a[k], 7) for k in a] for a, b in zip(lo_c, lo_g)]}, "
        f"params {diffs['params']:.3g}, EMA {diffs['ema']:.3g}, running stats "
        f"{diffs['batch_stats']:.3g}")
    if bad:
        raise AssertionError(f"train_epochs card vs CPU outside tolerance: {bad}")

    batch = train_batch(cfg, device="cuda")

    def fresh(seed):
        model = build_model(cfg, torch.device("cuda"), seed, None)
        tx = tstep.AdamW()
        return tstep.create_train_state(model, tx), tstep.make_train_step(model, tx, cfg,
                                                                            membership)

    runs = []
    for _ in range(2):  # two straight runs: the card's own run-to-run spread
        straight, step = fresh(3)
        for _ in range(3):
            straight, want = step(straight, batch)
        runs.append((straight, want))
    part, step = fresh(3)
    for _ in range(2):
        part, _ = step(part, batch)
    path = tio.save_checkpoint(os.path.join(root, "tiny_resume"), part.step, part, next_epoch=1)
    resumed, step = fresh(9)
    resumed = tio.load_checkpoint(path, target=resumed)
    resumed, got = step(resumed, batch)

    def compare(x, lx, y, ly):
        """(max difference, relative where above 1; bit-equal) of two runs."""
        pairs = [(x.model.state_dict(), y.model.state_dict()), (x.ema_params, y.ema_params),
                 (x.ema_batch_stats, y.ema_batch_stats), (x.opt_state.mu, y.opt_state.mu),
                 (x.opt_state.nu, y.opt_state.nu), (lx, ly)]
        worst = max(((b[n].float() - a[n].float()).abs() / a[n].float().abs().clamp_min(1.0))
                    .max().item() for a, b in pairs for n in a)
        return worst, all(torch.equal(a[n], b[n]) for a, b in pairs for n in a)

    spread, spread_exact = compare(*runs[0], *runs[1])
    worst, exact = compare(*runs[0], resumed, got)
    straight = runs[0][0]
    if worst > 1e-5 or (spread_exact and not exact) or straight.step != resumed.step or \
            not torch.equal(straight.ema_updates, resumed.ema_updates):
        raise AssertionError(f"resume on the card: off by {worst} from the straight run (two "
                             f"straight runs: {spread}, bit-equal {spread_exact})")
    out["resume"] = dict(max_diff=worst, bit_equal=exact, run_to_run=spread,
                         run_to_run_bit_equal=spread_exact)
    log(f"save/resume on the card (tiny, 2 steps + checkpoint + 1 step vs 3 straight): max "
        f"diff {worst:.3g} (relative above 1), bit-equal {exact}; two straight runs differ "
        f"by {spread:.3g}, bit-equal {spread_exact}")
    return out


def _loss_lines(lines):
    """The loss dicts of train_epochs' log lines."""
    import re

    out = []
    for ln in lines:
        m = re.match(r"epoch \d+ iter \d+/\d+ \([\d.]+s/iter\) (.*)", ln)
        if m:
            out.append({k: float(v) for k, v in (kv.split(": ") for kv in m.group(1).split(", "))})
    return out


class step_probe:
    """While active, wraps the step factory `name` of `cli/main.py`: each
    step of the CLI's run is synchronized and timed, its launches read
    around it (the counters are not reset), its losses and frame count
    kept, with peaks=True its peak device memory (the peak counter reset
    before each step), and with `watch(state) -> tensor` whether that
    tensor moved."""

    def __init__(self, name, watch=None, peaks=False):
        from veon_tpu_torch.cli import main as cli_mod

        self.mod, self.name, self.watch, self.track_peaks = cli_mod, name, watch, peaks
        self.ms, self.launches, self.losses, self.moved = [], [], [], []
        self.frames, self.peaks = [], []

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)
        probe, fns = self, kernel_fns()

        def factory(*a, **kw):
            step = probe.orig(*a, **kw)

            def timed(state, batch):
                before = probe.watch(state).clone() if probe.watch else None
                torch.cuda.synchronize()
                if probe.track_peaks:
                    torch.cuda.reset_peak_memory_stats()
                counts = {k: fn.launches for k, fn in fns.items()}
                t = time.perf_counter()
                state, losses = step(state, batch)
                torch.cuda.synchronize()
                probe.ms.append((time.perf_counter() - t) * 1e3)
                if probe.track_peaks:
                    probe.peaks.append(torch.cuda.max_memory_allocated())
                imgs = batch.get("imgs", batch.get("depth_imgs"))
                probe.frames.append(int(imgs.shape[1]) if imgs is not None else 1)
                probe.launches.append({k: fn.launches - counts[k] for k, fn in fns.items()})
                probe.losses.append({k: float(v) for k, v in losses.items()})
                if before is not None:
                    probe.moved.append(not torch.equal(before, probe.watch(state)))
                return state, losses

            return timed

        setattr(self.mod, self.name, factory)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)

    def warm_ms(self):
        """The median of the steps after the first (cuDNN's plans, the
        allocator's first growth)."""
        return statistics.median(self.ms[1:] if len(self.ms) > 1 else self.ms)


class io_probe:
    """While active, times every checkpoint save (`train/loop.py`) and
    load (`cli/main.py`), with the saved file's bytes."""

    def __init__(self):
        from veon_tpu_torch.cli import main as cli_mod
        from veon_tpu_torch.train import loop

        self.targets = ((loop, "save_checkpoint", "save"), (cli_mod, "save_checkpoint", "save"),
                        (cli_mod, "load_checkpoint", "load"))
        self.times = {"save": [], "load": []}
        self.bytes = []

    def __enter__(self):
        self.orig = []
        for mod, name, kind in self.targets:
            fn = getattr(mod, name)
            self.orig.append((mod, name, fn))
            setattr(mod, name, self._timed(fn, kind))
        return self

    def _timed(self, fn, kind):
        from veon_tpu_torch.ckpt.io import STATE_FILE

        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            self.times[kind].append(time.perf_counter() - t)
            if kind == "save":
                self.bytes.append(os.path.getsize(os.path.join(res, STATE_FILE)))
            return res

        return call

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)


def _trainable_probe(state):
    """The first trainable param of a train state (it moves on every update)."""
    return next(p for p in state.model.parameters() if p.requires_grad).detach()


def train_shard(root, n):
    """An infos pkl of the first n frames of the shard with a 34,720-point
    LiDAR sweep each that the rig sees (its cameras look along the ego z
    axis, so phase 19's ground-level sweep lands in few pixels): points
    U(-30, 30) m across, 1.7-38 m above the lidar, 1.8 m above the ego."""
    import pickle

    with open(os.path.join(root, "infos.pkl"), "rb") as f:
        data = pickle.load(f)
    rng = np.random.default_rng(8)
    infos = data["infos"][:n]
    for info in infos:
        pts = np.concatenate([rng.uniform(-30, 30, (34720, 2)), rng.uniform(1.7, 38, (34720, 1)),
                              rng.uniform(0, 1, (34720, 2))], 1).astype(np.float32)
        info["lidar_path"] = os.path.join(root, f"lidar_train_{info['token']}.bin")
        pts.tofile(info["lidar_path"])
        info["lidar2ego_rotation"], info["lidar2ego_translation"] = [1.0, 0, 0, 0], [0, 0, 1.8]
    path = os.path.join(root, f"infos_train_{n}.pkl")
    with open(path, "wb") as f:
        pickle.dump({"infos": infos, "metadata": data["metadata"]}, f)
    return path


def train_cli_phase(root, frames=4):
    """Phase 27, stage 2 through the CLI, a main path: `train --preset
    veon_b` at full width in fp32 (the preset's dtype), seeded weights, on
    the first `frames` frames of the shard with LiDAR sweeps (`train_shard`): `--epochs
    1`, then `--epochs 2 --auto-resume`, which must start at NEXT_EPOCH 1
    and run epoch 2 alone; kernel #3 exactly once per step, read around
    each step. Reported: ms/step (median of the warm steps), peak memory
    above the phase's start, checkpoint bytes, save and load seconds. Then
    `--accum-steps 2` over one epoch (the params move on every second step
    only), `publish --ema`, `test --ckpt <published>` (#3 once per frame),
    `test --all-ckpts --sweep-from 1` over both checkpoints (#3 once per
    frame and checkpoint), and `--ema` on the published one refused."""
    pkl = train_shard(root, frames)
    work = tempfile.mkdtemp(prefix="veon_train", dir=root)
    # --remat none: the step these phases measured before the CLI's default
    # `full` recomputed (phase 35 compares the policies)
    base = ["--preset", "veon_b", "--data-root", root, "--ann", pkl, "--workers", "2",
            "--remat", "none"]
    res = {}
    start = phase_base()
    torch.cuda.reset_peak_memory_stats()
    with step_probe("make_train_step") as probe, io_probe() as io:
        first, out1, s1, l1 = run_cli(["train", *base, "--epochs", "1", "--work-dir", work])
        n1 = len(probe.ms)
        second, out2, s2, l2 = run_cli(["train", *base, "--epochs", "2", "--auto-resume",
                                        "--work-dir", work])
    peak = torch.cuda.max_memory_allocated() - start
    if first != {"start_epoch": 0, "step": frames} or \
            second != {"start_epoch": 1, "step": 2 * frames} or n1 != frames or \
            len(probe.ms) != 2 * frames or f"(epoch 1)" not in out2:
        raise AssertionError(f"train / --auto-resume: {first}, {second}, steps {len(probe.ms)}")
    want = {k: 1 if k == "bev_pool_sorted2" else 0 for k in probe.launches[0]}
    for i, got in enumerate(probe.launches):
        expect_launches(got, want, f"train step {i + 1}")
    expect_launches(l1, {k: frames * v for k, v in want.items()}, "train --epochs 1")
    expect_launches(l2, {k: frames * v for k, v in want.items()}, "train --auto-resume")
    if not all(math.isfinite(v) for d in probe.losses for v in d.values()):
        raise AssertionError(f"train losses {probe.losses}")
    res["stage2"] = dict(step_ms=probe.ms, warm_ms=probe.warm_ms(), peak_bytes=peak,
                         losses=probe.losses, ckpt_bytes=io.bytes, save_s=io.times["save"],
                         load_s=io.times["load"], cli_s=[s1, s2], launches=probe.launches)
    log(f"train --preset veon_b fp32, {frames} frames x 2 epochs (the second by --auto-resume "
        f"from NEXT_EPOCH 1): step ms {[round(t, 3) for t in probe.ms]}, warm median "
        f"{probe.warm_ms():.3f} ms, peak memory above the phase's start {peak / 2**30:.3f} GiB, "
        f"checkpoint {[round(b / 2**30, 3) for b in io.bytes]} GiB, save s "
        f"{[round(t, 3) for t in io.times['save']]}, load s "
        f"{[round(t, 3) for t in io.times['load']]}, CLI s {[round(s1, 1), round(s2, 1)]}; "
        f"#3 once per step; last losses {probe.losses[-1]}")
    accum_dir = tempfile.mkdtemp(prefix="veon_accum", dir=root)
    with step_probe("make_train_step", watch=_trainable_probe) as acc:
        run_cli(["train", *base, "--epochs", "1", "--accum-steps", "2", "--work-dir", accum_dir])
    if acc.moved != [i % 2 == 1 for i in range(frames)]:
        raise AssertionError(f"--accum-steps 2: params moved on steps {acc.moved}")
    shutil.rmtree(accum_dir, ignore_errors=True)
    res["accum2"] = dict(moved=acc.moved, step_ms=acc.ms)
    log(f"train --accum-steps 2: params moved {acc.moved}, step ms "
        f"{[round(t, 3) for t in acc.ms]}")
    t = time.perf_counter()
    pub, _o, _s, _l = run_cli(["publish", "--ckpt", os.path.join(work, f"step_{2 * frames}"),
                               "--out-prefix", os.path.join(root, "veon_b_pub"), "--ema"])
    pub_s = time.perf_counter() - t
    test_pkl = shard_paths(root, frames, "train_test")
    tbase = ["--preset", "veon_b", "--data-root", root, "--ann", test_pkl, "--workers", "2"]
    r, _o, ts, lt = run_cli(["test", *tbase, "--ckpt", pub])
    expect_launches(lt, {k: frames * v for k, v in want.items()}, "test --ckpt")
    sweep, _o, ss, ls = run_cli(["test", *tbase, "--all-ckpts", "--work-dir", work,
                                 "--sweep-from", "1"])
    expect_launches(ls, {k: 2 * frames * v for k, v in want.items()}, "test --all-ckpts")
    if list(sweep["sweep"]) != [frames, 2 * frames] or not np.isfinite(r["mIoU"]):
        raise AssertionError(f"test on checkpoints: {r['mIoU']}, sweep {list(sweep['sweep'])}")
    try:
        run_cli(["test", *tbase, "--ckpt", pub, "--ema"])
    except SystemExit as e:
        if "published" not in str(e):
            raise
    else:
        raise AssertionError("test --ema on a published checkpoint was not refused")
    res["checkpoints"] = dict(publish_s=pub_s, published=os.path.basename(pub),
                              test_miou=r["mIoU"], test_s=ts,
                              sweep={k: v["mIoU"] for k, v in sweep["sweep"].items()},
                              sweep_s=ss, launches=dict(test=lt, sweep=ls))
    log(f"publish --ema {os.path.basename(pub)} in {pub_s:.3f} s; test --ckpt (published) mIoU "
        f"{r['mIoU']:.4f} in {ts:.1f} s; --all-ckpts --sweep-from 1 "
        f"{ {k: round(v['mIoU'], 4) for k, v in sweep['sweep'].items()} } in {ss:.1f} s; --ema "
        "on the published checkpoint refused")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(pub, ignore_errors=True)
    res["launches_sorted2"] = (sum(d["bev_pool_sorted2"] for d in probe.launches)
                               + sum(acc.launches[i]["bev_pool_sorted2"] for i in range(frames))
                               + lt["bev_pool_sorted2"] + ls["bev_pool_sorted2"])
    return res


def pretrain_cli_phase(root, preset, frames):
    """Phase 28, stage 1 through the CLI, a main path: `pretrain-depth
    --preset P` (fp32, seeded tower with LoRA) on the first `frames`
    frames of the shard with LiDAR sweeps (`train_shard`) at the full input
    resolution, one epoch: ms/step,
    peak memory above the phase's start, the loss of every step, the
    checkpoint's save; the base trunk bit-unchanged, the adapters and the
    head (zoe: decoder and bins head) moved; no kernel launched (the depth
    tower has none)."""
    from veon_tpu_torch.cli import main as cli_mod

    pkl = train_shard(root, frames)
    work = tempfile.mkdtemp(prefix="veon_pretrain", dir=root)
    seen = {}
    orig = cli_mod.depth_tower

    def capture(cfg, device="cuda", seed=0):
        tower, trainable, convert = orig(cfg, device, seed)
        seen["tower"], seen["input"] = tower, cfg.data.depth_input_size
        seen["start"] = {n: p.detach().cpu().clone() for n, p in tower.named_parameters()}
        return tower, trainable, convert

    start = phase_base()
    torch.cuda.reset_peak_memory_stats()
    cli_mod.depth_tower = capture
    try:
        with step_probe("make_depth_pretrain_step") as probe, io_probe() as io:
            res, _out, s, launches = run_cli(["pretrain-depth", "--preset", preset,
                                              "--data-root", root, "--ann", pkl, "--workers", "2",
                                              "--epochs", "1", "--work-dir", work])
    finally:
        cli_mod.depth_tower = orig
    peak = torch.cuda.max_memory_allocated() - start
    tower = seen.pop("tower")
    moved, frozen_moved = [], []
    for n, p in tower.named_parameters():
        if not torch.equal(p.detach().cpu(), seen["start"][n]):
            (moved if p.requires_grad else frozen_moved).append(n)
    trainable = [n for n, p in tower.named_parameters() if p.requires_grad]
    lora = [n for n in moved if "lora_" in n]
    if frozen_moved or len(probe.ms) != frames or not lora or len(moved) < len(trainable) // 2:
        raise AssertionError(f"pretrain-depth {preset}: frozen moved {frozen_moved[:4]}, "
                             f"{len(moved)} of {len(trainable)} trainable moved, "
                             f"steps {len(probe.ms)}")
    expect_launches(launches, {k: 0 for k in launches}, f"pretrain-depth {preset}")
    if res["checkpoint"] != os.path.join(work, f"step_{frames}"):
        raise AssertionError(f"pretrain-depth checkpoint {res['checkpoint']}")
    if not all(math.isfinite(v) for d in probe.losses for v in d.values()):
        raise AssertionError(f"pretrain-depth losses {probe.losses}")
    del tower
    shutil.rmtree(work, ignore_errors=True)
    out = dict(step_ms=probe.ms, warm_ms=probe.warm_ms(), peak_bytes=peak, losses=probe.losses,
               depth_input=list(seen["input"]), trainable=len(trainable), moved=len(moved),
               lora_moved=len(lora), save_s=io.times["save"], ckpt_bytes=io.bytes, cli_s=s)
    log(f"pretrain-depth --preset {preset} fp32, {frames} frames at the full input "
        f"{tuple(seen['input'])}: step ms {[round(t, 3) for t in probe.ms]}, warm median "
        f"{probe.warm_ms():.3f} ms, peak memory above the phase's start {peak / 2**30:.3f} GiB, "
        f"losses {[{k: round(v, 5) for k, v in d.items()} for d in probe.losses]}, "
        f"{len(moved)} of {len(trainable)} trainable tensors moved ({len(lora)} adapters), "
        f"base trunk bit-unchanged, checkpoint {[round(b / 2**30, 3) for b in io.bytes]} GiB "
        f"saved in {[round(t, 3) for t in io.times['save']]} s, CLI {s:.1f} s")
    return out


def overfit_phase():
    """Phase 29, the overfit drill on the card: `stage2_overfit` at its
    default size (tiny preset, 40 steps, lr 1e-3, seed 0) on the card and
    on the CPU, from weights seeded by the CPU's generator (those of
    `tests/test_torch_overfit.py`) and from weights seeded by the card's
    (other weights for the same seed). Every run holds the JAX test's loss
    margins (total loss down >= 28%, the occupancy term down), and the
    card's first loss is the CPU's within 1e-4 on the same weights. The
    JAX test's mIoU margin (up > 0.10) belongs to the weights, not the
    device: the CPU misses it at 5 of seeds 0-11 (`python -m
    veon_tpu_torch.utils.overfit --stage 2 --steps 40 --seed 0 ... 11
    --device cpu`), the card-seeded seed-0 weights among them. So the card
    must reach the CPU's verdict on the same weights, and both must pass it
    on the CPU-seeded weights, as the CPU test does."""
    import contextlib
    import io

    from veon_tpu_torch.utils.overfit import stage2_overfit

    out = {}
    for init in ("cpu", "cuda"):
        runs = {}
        for dev in ("cuda", "cpu"):
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):  # the metric's per-class table
                r = stage2_overfit(device=dev, log_every=10, init_device=init)
            s = time.perf_counter() - t
            if not (r["loss1"] < 0.72 * r["loss0"] and
                    r["final_losses"]["loss_binocc"] < r["first_losses"]["loss_binocc"]):
                raise AssertionError(f"stage2_overfit on {dev} from {init} weights: "
                                     f"{r['curve']}")
            runs[dev] = dict(curve=r["curve"], miou0=r["miou0"], miou1=r["miou1"],
                             miou_margin=r["miou1"] > r["miou0"] + 0.10, seconds=s)
            log(f"stage2_overfit on {dev} from {init}-seeded weights: loss {r['loss0']:.4f} -> "
                f"{r['loss1']:.4f} ({100 * (1 - r['loss1'] / r['loss0']):.1f}% down), mIoU "
                f"{r['miou0']:.3f} -> {r['miou1']:.3f}, {s:.1f} s")
        card, cpu = runs["cuda"], runs["cpu"]
        if abs(card["curve"][0][1] - cpu["curve"][0][1]) > 1e-4 * abs(cpu["curve"][0][1]):
            raise AssertionError(f"first loss from {init} weights: card {card['curve'][0]}, "
                                 f"cpu {cpu['curve'][0]}")
        if card["miou_margin"] != cpu["miou_margin"] or (init == "cpu" and not cpu["miou_margin"]):
            raise AssertionError(f"mIoU from {init} weights: card {card['miou0']} -> "
                                 f"{card['miou1']}, cpu {cpu['miou0']} -> {cpu['miou1']}")
        out[init] = runs
    return out


def _compare_runs(want, got, what):
    """Phase 26's tolerances, card (got) against CPU (want), each a dict of
    losses (floats) and tensors by kind: losses within 1e-4 (relative above
    1), the gradient (Adam's first moment) within 1e-3 of its largest
    entry, params and EMA within 1e-5 and running stats within 1e-4
    (relative above 1). Returns the differences."""
    diffs = {"loss": max(abs(got["losses"][k] - v) / max(abs(v), 1.0)
                         for k, v in want["losses"].items())}
    scale = max(v.abs().max().item() for v in want["mu"].values())
    diffs["grad"] = max((got["mu"][n].cpu() - v).abs().max().item()
                        for n, v in want["mu"].items()) / scale
    for kind in ("params", "ema", "buffers"):
        diffs[kind] = max(((got[kind][n].cpu().float() - v.float()).abs()
                           / v.float().abs().clamp_min(1.0)).max().item()
                          for n, v in want[kind].items())
    tol = {"loss": 1e-4, "grad": 1e-3, "params": 1e-5, "ema": 1e-5, "buffers": 1e-4}
    bad = {k: v for k, v in diffs.items() if not v <= tol[k]}
    if bad:
        raise AssertionError(f"{what}: card vs CPU outside phase 26's tolerance: {bad}")
    return diffs


def _run_state(trainer, losses):
    """A step's losses and the trained state: trainable params, running
    stats, Adam's first moment and the EMA of the trainable params."""
    s, model = trainer.state, trainer.model
    return dict(losses={k: float(v) for k, v in losses.items()},
                params={n: p.detach().clone() for n, p in model.named_parameters()
                        if p.requires_grad},
                buffers={n: b.clone() for n, b in model.named_buffers()},
                mu={n: t.clone() for n, t in s.opt_state.mu.items()},
                ema={n: s.ema_params[n].clone() for n in s.opt_state.mu})


def tiny_train_cfg(num_temporal=1):
    """The tiny preset with 0.5 m depth bins: the banded lift sprays."""
    from veon_tpu_torch.configs import presets

    cfg = presets.veon_tiny_test(num_temporal=num_temporal)
    return dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid, depth=(1.0, 45.0, 0.5)))


def temporal_train_parity_phase():
    """Phase 30, temporal training at the tiny preset, card vs CPU: one F=2
    step on each route of the deformable attention (the 3x3x3 stencil, the
    model's, and the grid_sample gather) from the same CPU-seeded weights,
    far depths on both frames (the spray runs): phase 26's tolerances
    (`_compare_runs`); #3 twice in the card's step, once per frame."""
    from veon_tpu_torch.entry import train_entry
    from veon_tpu_torch.train import step as tstep

    cfg = tiny_train_cfg(2)
    out = {}
    for route in ("stencil", "gather"):
        built = {dev: train_entry(cfg, device=dev, seed=3) for dev in ("cpu", "cuda")}
        card = built["cuda"][0]
        card.model.load_state_dict(built["cpu"][0].model.state_dict())
        card.state = tstep.create_train_state(card.model, tstep.AdamW())
        runs = {}
        for dev, (trainer, batch) in built.items():
            trainer.model.alignnet.temporal_fusion.t_deform.use_stencil = route == "stencil"
            del batch["depth_imgs"]
            batch["depth"] = far_depth(cfg).to(dev)
            kernels = reset_launches()
            losses = trainer(batch)
            torch.cuda.synchronize()
            runs[dev] = _run_state(trainer, losses)
            runs[dev]["launches"] = {k: fn.launches for k, fn in kernels.items()}
        expect_launches(runs["cuda"]["launches"], {"bev_pool_pooled": 0, "bev_pool_sorted": 0,
                                                   "bev_pool_sorted2": 2, "ln_dense": 0},
                        f"tiny F=2 train step ({route})")
        diffs = _compare_runs(runs["cpu"], runs["cuda"], f"tiny F=2 train step ({route})")
        out[route] = dict(diffs, losses=runs["cpu"]["losses"])
        log(f"temporal train step tiny F=2 fp32 ({route}) card vs CPU: losses "
            f"{ {k: round(v, 6) for k, v in runs['cpu']['losses'].items()} }, differences "
            f"{ {k: float(f'{v:.3g}') for k, v in diffs.items()} }; #3 twice")
        del built, runs
    return out


def _fusion_memory(model):
    """Hooks on the temporal fusion and its deformable attention recording
    the device bytes each train-mode call leaves allocated (its output and
    what autograd saved for the backward). Returns ({name: [bytes]},
    remove)."""
    tf = model.alignnet.temporal_fusion
    seen, handles = {"temporal_fusion": [], "t_deform": []}, []
    for name, mod in (("temporal_fusion", tf), ("t_deform", tf.t_deform)):
        start = []
        handles.append(mod.register_forward_pre_hook(
            lambda *_a, start=start: start.append(torch.cuda.memory_allocated())))
        handles.append(mod.register_forward_hook(
            lambda *_a, start=start, name=name: seen[name].append(
                torch.cuda.memory_allocated() - start.pop())))
    return seen, lambda: [h.remove() for h in handles]


def temporal_cli_phase(root, frames=4):
    """Phase 31, temporal training through the CLI, a main path: `train
    --preset veon_b --num-temporal 2 --temporal-start-epoch 1 --epochs 2`
    fp32 on the first `frames` frames of the shard with LiDAR sweeps
    (`train_shard`): epoch 0 on the current frame (#3 once per step),
    epoch 1 on two frames (#3 twice per step), then `--epochs 3
    --auto-resume` (epoch 3 alone, two frames) and `test --num-temporal 2
    --ckpt` on its checkpoint (#3 twice per frame). Per epoch: ms/step and
    the steps' peak device memory above the phase's start. Then
    `train_entry` in bf16 at F=2 and F=4, 3 steps each (#3 F times per
    step), with the peak above the start of each (its model included), the device
    bytes the temporal fusion's train-mode forward leaves for its backward
    (stencil route, and the gather route on one more step), and one F=2
    step with lss_banded=False (#2 twice)."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import train_entry

    pkl = train_shard(root, frames)
    work = tempfile.mkdtemp(prefix="veon_ttrain", dir=root)
    base = ["--preset", "veon_b", "--num-temporal", "2", "--temporal-start-epoch", "1",
            "--data-root", root, "--ann", pkl, "--workers", "2", "--work-dir", work,
            "--remat", "none"]
    res, launches_sorted2 = {}, 0
    start = phase_base()
    with step_probe("make_train_step", peaks=True) as probe:
        first, _o1, s1, l1 = run_cli(["train", *base, "--epochs", "2"])
        second, out2, s2, l2 = run_cli(["train", *base, "--epochs", "3", "--auto-resume"])
    if first != {"start_epoch": 0, "step": 2 * frames} or \
            second != {"start_epoch": 2, "step": 3 * frames} or "(epoch 2)" not in out2 or \
            probe.frames != [1] * frames + [2] * (2 * frames):
        raise AssertionError(f"temporal train / --auto-resume: {first}, {second}, frames "
                             f"{probe.frames}")
    for i, (got, f) in enumerate(zip(probe.launches, probe.frames)):
        expect_launches(got, {k: f if k == "bev_pool_sorted2" else 0 for k in got},
                        f"temporal train step {i + 1} (F={f})")
    expect_launches(l1, {k: 3 * frames if k == "bev_pool_sorted2" else 0 for k in l1},
                    "train --num-temporal 2 --epochs 2")
    expect_launches(l2, {k: 2 * frames if k == "bev_pool_sorted2" else 0 for k in l2},
                    "train --num-temporal 2 --auto-resume")
    if not all(math.isfinite(v) for d in probe.losses for v in d.values()):
        raise AssertionError(f"temporal train losses {probe.losses}")
    epochs = {}
    for e in range(3):
        ms = probe.ms[e * frames:(e + 1) * frames]
        epochs[e] = dict(frames=probe.frames[e * frames], step_ms=ms,
                         warm_ms=statistics.median(ms[1:]), peak_bytes=max(
                             probe.peaks[e * frames:(e + 1) * frames]) - start)
    test_pkl = shard_paths(root, frames, "ttrain_test")
    r, _o, ts, lt = run_cli(["test", "--preset", "veon_b", "--num-temporal", "2", "--data-root",
                             root, "--ann", test_pkl, "--workers", "2", "--ckpt",
                             os.path.join(work, f"step_{3 * frames}")])
    expect_launches(lt, {k: 2 * frames if k == "bev_pool_sorted2" else 0 for k in lt},
                    "test --num-temporal 2 --ckpt")
    if not np.isfinite(r["mIoU"]):
        raise AssertionError(f"test --num-temporal 2 --ckpt mIoU {r['mIoU']}")
    shutil.rmtree(work, ignore_errors=True)
    launches_sorted2 += sum(d["bev_pool_sorted2"] for d in probe.launches) + lt["bev_pool_sorted2"]
    res["cli"] = dict(epochs=epochs, losses=probe.losses, cli_s=[s1, s2], test_miou=r["mIoU"],
                      test_s=ts, launches=probe.launches, test_launches=lt)
    log(f"train --preset veon_b --num-temporal 2 --temporal-start-epoch 1 fp32, {frames} frames: "
        + "; ".join(f"epoch {e} (F={d['frames']}) step ms {[round(t, 3) for t in d['step_ms']]} "
                    f"warm {d['warm_ms']:.3f}, peak above the phase's start "
                    f"{d['peak_bytes'] / 2**30:.3f} GiB"
                    for e, d in epochs.items())
        + f"; epoch 3 by --auto-resume from NEXT_EPOCH 2; #3 once per F=1 step, twice per F=2 "
        f"step; test --num-temporal 2 --ckpt mIoU {r['mIoU']:.4f} in {ts:.1f} s (#3 twice per "
        f"frame); CLI s {[round(s1, 1), round(s2, 1)]}")
    res["bf16"] = {}
    for F in (2, 4):
        start = phase_base()
        trainer, batch = train_entry(presets.veon_b(num_temporal=F, compute_dtype="bfloat16"))
        torch.cuda.synchronize()
        seen, remove = _fusion_memory(trainer.model)
        torch.cuda.reset_peak_memory_stats()
        kernels = reset_launches()
        times, losses = [], []
        for _ in range(3):
            t = time.perf_counter()
            lo = trainer(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append({k: float(v) for k, v in lo.items()})
        launches = {k: fn.launches for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated() - start
        expect_launches(launches, {k: 3 * F if k == "bev_pool_sorted2" else 0 for k in launches},
                        f"train_entry bf16 F={F}")
        launches_sorted2 += launches["bev_pool_sorted2"]
        stencil = {k: v[-1] for k, v in seen.items()}
        trainer.model.alignnet.temporal_fusion.t_deform.use_stencil = False
        trainer(batch)
        torch.cuda.synchronize()
        gather = {k: v[-1] for k, v in seen.items()}
        remove()
        if not all(math.isfinite(v) for d in losses for v in d.values()):
            raise AssertionError(f"train_entry bf16 F={F} losses {losses}")
        res["bf16"][F] = dict(step_ms=times, warm_ms=statistics.median(times[1:]),
                              peak_bytes=peak, launches=launches, losses=losses,
                              fusion_saved_bytes=dict(stencil=stencil, gather=gather))
        log(f"train_entry veon_b bf16 F={F}: step ms {[round(t, 3) for t in times]}, peak above "
            f"the start (model included) {peak / 2**30:.3f} GiB, #3 {launches['bev_pool_sorted2']} in 3 steps; the "
            f"temporal fusion's train-mode forward leaves (output + saved for backward) "
            + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in stencil.items())
            + " on the stencil route, "
            + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in gather.items())
            + " on the gather route (the last t_deform call of each)")
        del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    trainer, batch = train_entry(dataclasses.replace(
        presets.veon_b(num_temporal=2, compute_dtype="bfloat16"), lss_banded=False))
    kernels = reset_launches()
    t = time.perf_counter()
    lo = trainer(batch)
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t) * 1e3
    full = {k: fn.launches for k, fn in kernels.items()}
    expect_launches(full, {k: 2 if k == "bev_pool_sorted" else 0 for k in full},
                    "train_entry bf16 F=2 lss_banded=False")
    res["full_lift_f2"] = dict(step_ms=full_ms, launches=full,
                               losses={k: float(v) for k, v in lo.items()})
    log(f"train_entry veon_b bf16 F=2 lss_banded=False: one step {full_ms:.3f} ms (cold), #2 "
        "twice")
    del trainer, batch
    res["launches_sorted2"], res["launches_sorted"] = launches_sorted2, full["bev_pool_sorted"]
    return res


def _spawn_ranks(argvs, work, timeout=300):
    """This script's `--dp-worker` processes, one per argv, all started at
    once with their output in `work`; waits for all, and kills every one
    that is left as soon as one fails or the timeout passes. Returns the
    outputs."""
    logs = [open(os.path.join(work, f"rank{i}.log"), "w+") for i in range(len(argvs))]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker",
                               *map(str, a)], stdout=f, stderr=subprocess.STDOUT)
             for a, f in zip(argvs, logs)]
    deadline, failed = time.time() + timeout, None
    while any(p.poll() is None for p in procs):
        failed = next((i for i, p in enumerate(procs) if p.poll() not in (None, 0)), None)
        if failed is not None or time.time() > deadline:
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"dp worker {bad[0]} exited {procs[bad[0]].returncode} (failed "
                             f"first: {failed}):\n{outs[bad[0]][-3000:]}")
    return outs


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_step_worker(rank, port, device, out):
    """Phase 32(b)'s rank: the tiny step on row `rank` of a B=2 batch in a
    two-rank gloo group on `device` (both ranks of the card on card 0),
    from CPU-seeded weights; saves its state and launches to `out`."""
    from veon_tpu_torch.cli.shapes import example_batch
    from veon_tpu_torch.entry import train_entry
    from veon_tpu_torch.train import distributed as D
    from veon_tpu_torch.train import step as tstep

    rank = int(rank)
    cfg = tiny_train_cfg()
    D.init_group(f"localhost:{port}", 2, rank, device=device, backend="gloo")
    trainer, batch = train_entry(cfg, device="cpu", seed=3)
    if device == "cuda":
        cpu_sd = trainer.model.state_dict()
        trainer, batch = train_entry(cfg, device="cuda", seed=3)
        trainer.model.load_state_dict(cpu_sd)
        trainer.state = tstep.create_train_state(trainer.model, tstep.AdamW())
    D.broadcast_state(trainer.model)
    imgs, _d, metas = example_batch(cfg, B=2, device=device)
    nx, ny, nz = cfg.grid.size
    labels = np.random.default_rng(23).integers(0, 18, (2, nx, ny, nz)).astype(np.int32)
    rows = slice(rank, rank + 1)
    del batch["depth_imgs"]
    batch.update(imgs=imgs[rows], metas={k: v[rows] for k, v in metas.items()},
                 depth=far_depth(cfg, B=2)[rows].to(device),
                 voxel_semantics=torch.from_numpy(labels[rows]).to(device))
    kernels = reset_launches()
    run = _run_state(trainer, trainer(batch))
    run["launches"] = {k: fn.launches for k, fn in kernels.items()}
    D.shutdown()
    torch.save({k: ({n: t.cpu() for n, t in v.items()} if k in ("params", "buffers", "mu", "ema")
                    else v) for k, v in run.items()}, out)


def _dp_cli_worker(rank, port, root, pkl, work, out):
    """Phase 32(c)'s rank: `train --preset veon_b --dist-num-processes 2`
    at full width in fp32 on the card, the two ranks sharing it over gloo
    (NCCL takes one rank per card): initialize is given backend="gloo"
    here, the CLI has no option for it. Saves the result, the checkpoints
    this rank wrote, each step's launches, ms, peak and losses
    (`step_probe`), and a SHA-256 of every tensor of its trained model, to
    `out`."""
    import functools
    import hashlib

    from veon_tpu_torch.cli import main as cli_mod
    from veon_tpu_torch.train import distributed as D
    from veon_tpu_torch.train import loop

    cli_mod.dist_init = functools.partial(D.initialize, backend="gloo")
    saves, models = [], []
    orig_save, orig_step = loop.save_checkpoint, cli_mod.make_train_step
    loop.save_checkpoint = lambda d, step, *a, **k: (saves.append(step), orig_save(d, step, *a,
                                                                                   **k))[1]
    cli_mod.make_train_step = lambda model, *a, **k: (models.append(model),
                                                      orig_step(model, *a, **k))[1]
    with step_probe("make_train_step", peaks=True) as probe:
        res = cli_mod.main(["train", "--preset", "veon_b", "--data-root", root, "--ann", pkl,
                            "--workers", "1", "--epochs", "1", "--work-dir", work, "--remat",
                            "none", "--dist-coordinator", f"localhost:{port}",
                            "--dist-num-processes", "2", "--dist-process-id", str(rank)])
    torch.cuda.synchronize()
    digest = {n: hashlib.sha256(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                                .numpy()).hexdigest()
              for n, t in models[-1].state_dict().items()}
    torch.save(dict(result=res, saves=saves, launches=probe.launches, step_ms=probe.ms,
                    peaks=probe.peaks, losses=probe.losses, frames=probe.frames,
                    digest=digest), out)


def _spread(ms):
    """Median, quartiles, min and max of a list of times."""
    q = statistics.quantiles(ms, n=4)
    return dict(median=statistics.median(ms), q1=q[0], q3=q[2], min=min(ms), max=max(ms))


def data_parallel_phase(root, rounds=12):
    """Phase 32, data parallel on the card. (a) VEON-B bf16 at full width
    through `train_entry`: the plain step twice from the same seeded weights
    (is the card's step bit-reproducible?), then the step under a one-rank
    NCCL group (`distributed.init_group`; `initialize` opens none at world
    size 1, as JAX's): synced BatchNorm, gradients and losses all-reduced.
    Its first step bit-equal to the plain one where the plain step repeats
    bit for bit (else within the plain step's own run-to-run difference).
    Then, on that trainer with the group open, 2 warm steps and `rounds`
    steps each of the plain step (the collectives switched off:
    `collectives.data_parallel` patched to False) and the synced one,
    alternating plain, synced, synced, plain: medians with their quartiles
    and the paired differences; #3 once per step. (b) Two ranks sharing
    the card over gloo (gloo all-reduces CUDA tensors through the host),
    tiny preset, one step on one row each of a B=2 batch, against the same
    two ranks on the CPU: the ranks bit-equal to each other, card against
    CPU within phase 26's tolerance, #3 once per rank. (c) `train --preset
    veon_b --dist-num-processes 2 --dist-coordinator` fp32 as two processes
    sharing the card (over gloo, see `_dp_cli_worker`) on the first 4
    frames of the shard with LiDAR sweeps: 2 steps per rank, #3 once per
    step on each rank, the averaged losses equal on both ranks, rank 0
    alone prints the param table and writes step_2 and the log, both ranks
    end with bit-equal models (SHA-256 of every tensor)."""
    from unittest import mock

    from veon_tpu_torch import collectives
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import train_entry
    from veon_tpu_torch.train import distributed as D

    cfg = presets.veon_b(compute_dtype="bfloat16")
    out, launches_sorted2 = {}, 0

    def first_step(synced):
        """A trainer from seed 0, its batch and its first step's state."""
        gc.collect()
        torch.cuda.empty_cache()
        trainer, batch = train_entry(cfg, seed=0)
        if synced:
            D.broadcast_state(trainer.model)
        return trainer, batch, _run_state(trainer, trainer(batch))

    def differ(a, b):
        """(bit-equal, max difference relative above 1) of two first steps."""
        pairs = [(a[k], b[k]) for k in ("params", "buffers", "mu", "ema")]
        exact = a["losses"] == b["losses"] and all(torch.equal(x[n], y[n]) for x, y in pairs
                                                   for n in x)
        worst = max([abs(a["losses"][k] - b["losses"][k]) / max(abs(a["losses"][k]), 1.0)
                     for k in a["losses"]] + [((y[n].float() - x[n].float()).abs()
                                               / x[n].float().abs().clamp_min(1.0)).max().item()
                                              for x, y in pairs for n in x])
        return exact, worst

    kernels = reset_launches()
    _t, _b, plain = first_step(False)
    del _t, _b
    _t, _b, again = first_step(False)
    del _t, _b
    order = ["plain", "synced", "synced", "plain"] * (rounds // 2)
    times = {"plain": [], "synced": []}
    D.init_group(f"localhost:{_free_port()}", 1, 0)
    try:
        trainer, batch, synced = first_step(True)
        backend = torch.distributed.get_backend()
        for _ in range(2):
            trainer(batch)
        for kind in order:
            with mock.patch.object(collectives, "data_parallel", lambda: False) \
                    if kind == "plain" else contextlib.nullcontext():
                torch.cuda.synchronize()
                t = time.perf_counter()
                trainer(batch)
                torch.cuda.synchronize()
                times[kind].append((time.perf_counter() - t) * 1e3)
    finally:
        D.shutdown()
    del trainer, batch
    steps = 3 + 2 + len(order)
    launches = {k: fn.launches for k, fn in kernels.items()}
    expect_launches(launches, {k: steps if k == "bev_pool_sorted2" else 0 for k in launches},
                    "veon_b bf16 plain and synced steps")
    launches_sorted2 += launches["bev_pool_sorted2"]
    repro, spread = differ(plain, again)
    exact, worst = differ(plain, synced)
    if not (exact or (not repro and worst <= 4 * spread)):
        raise AssertionError(f"world size 1 ({backend}): synced step off by {worst:.3g} from the "
                             f"plain one (plain run to run {spread:.3g}, bit-equal {repro})")
    paired = [times["synced"][i] - times["plain"][i] for i in range(rounds)]
    out["ws1"] = dict(backend=backend, bit_equal=exact, max_diff=worst, plain_bit_repro=repro,
                      plain_run_to_run=spread, order=order, plain_ms=times["plain"],
                      synced_ms=times["synced"], plain=_spread(times["plain"]),
                      synced=_spread(times["synced"]), paired_diff=_spread(paired),
                      losses=plain["losses"])
    w = out["ws1"]
    log(f"world size 1 over {backend}, veon_b bf16 full width: synced first step bit-equal "
        f"{exact} (max diff {worst:.3g}; the plain step run to run: bit-equal {repro}, "
        f"{spread:.3g}); {rounds} warm steps each, alternating plain/synced/synced/plain: "
        + "; ".join(f"{k} median {w[k]['median']:.3f} ms (quartiles {w[k]['q1']:.3f}-"
                    f"{w[k]['q3']:.3f}, range {w[k]['min']:.3f}-{w[k]['max']:.3f})"
                    for k in ("plain", "synced"))
        + f"; synced - plain per pair median {w['paired_diff']['median']:+.3f} ms (quartiles "
        f"{w['paired_diff']['q1']:+.3f} to {w['paired_diff']['q3']:+.3f}); plain ms "
        f"{[round(t, 3) for t in times['plain']]}, synced {[round(t, 3) for t in times['synced']]}")
    del plain, again, synced
    gc.collect()
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="veon_dp")
    try:
        ranks = {}
        for device in ("cuda", "cpu"):
            port = _free_port()
            _spawn_ranks([("step", r, port, device, os.path.join(work, f"{device}{r}.pt"))
                          for r in range(2)], work)
            ranks[device] = [torch.load(os.path.join(work, f"{device}{r}.pt")) for r in range(2)]
        card, cpu = ranks["cuda"], ranks["cpu"]
        for k in ("params", "buffers", "mu", "ema"):
            if not all(torch.equal(card[0][k][n], card[1][k][n]) for n in card[0][k]):
                raise AssertionError(f"two ranks on the card: {k} differ between the ranks")
        if card[0]["losses"] != card[1]["losses"]:
            raise AssertionError(f"two ranks on the card: losses {card[0]['losses']} vs "
                                 f"{card[1]['losses']}")
        for r in range(2):
            expect_launches(card[r]["launches"], {k: 1 if k == "bev_pool_sorted2" else 0
                                                  for k in card[r]["launches"]},
                            f"two ranks on the card: rank {r}")
        diffs = [_compare_runs(cpu[r], card[r], f"two gloo ranks, rank {r}") for r in range(2)]
        out["two_ranks_gloo"] = dict(diffs=diffs, losses=cpu[0]["losses"])
        log(f"two gloo ranks sharing the card, tiny fp32, one step each: ranks bit-equal, card "
            f"vs two CPU ranks {[{k: float(f'{v:.3g}') for k, v in d.items()} for d in diffs]}, "
            f"averaged losses { {k: round(v, 6) for k, v in cpu[0]['losses'].items()} }; #3 once "
            "per rank")

        pkl = train_shard(root, 4)
        tw = tempfile.mkdtemp(prefix="veon_dptrain", dir=root)
        port = _free_port()
        t = time.perf_counter()
        logs = _spawn_ranks([("cli", r, port, root, pkl, tw, os.path.join(work, f"cli{r}.pt"))
                             for r in range(2)], work, timeout=600)
        cli_s = time.perf_counter() - t
        recs = [torch.load(os.path.join(work, f"cli{r}.pt")) for r in range(2)]
        for r, rec in enumerate(recs):
            if rec["result"] != {"start_epoch": 0, "step": 2} or rec["frames"] != [1, 1] or \
                    rec["saves"] != ([2] if r == 0 else []) or ("TOTAL" in logs[r]) != (r == 0):
                raise AssertionError(f"train --dist rank {r}: {rec['result']}, frames "
                                     f"{rec['frames']}, saves {rec['saves']}")
            for i, got in enumerate(rec["launches"]):
                expect_launches(got, {k: 1 if k == "bev_pool_sorted2" else 0 for k in got},
                                f"train --dist rank {r} step {i + 1}")
            launches_sorted2 += sum(d["bev_pool_sorted2"] for d in rec["launches"])
            if not all(math.isfinite(v) for d in rec["losses"] for v in d.values()):
                raise AssertionError(f"train --dist rank {r} losses {rec['losses']}")
        if recs[0]["losses"] != recs[1]["losses"]:
            raise AssertionError(f"train --dist: the averaged losses differ between the ranks: "
                                 f"{recs[0]['losses']} vs {recs[1]['losses']}")
        off = sorted(n for n in recs[0]["digest"] if recs[0]["digest"][n] != recs[1]["digest"][n])
        if off or recs[0]["digest"].keys() != recs[1]["digest"].keys():
            raise AssertionError(f"train --dist: the ranks' models differ in {off[:5]}")
        if set(os.listdir(tw)) - {"tb"} != {"step_2", "train.log.jsonl"}:
            raise AssertionError(f"train --dist work dir: {sorted(os.listdir(tw))}")
        shutil.rmtree(tw, ignore_errors=True)
        out["cli"] = dict(results=[r["result"] for r in recs], saves=[r["saves"] for r in recs],
                          launches=[r["launches"] for r in recs],
                          step_ms=[r["step_ms"] for r in recs], peaks=[r["peaks"] for r in recs],
                          losses=recs[0]["losses"], tensors=len(recs[0]["digest"]),
                          seconds=cli_s)
        log(f"train --preset veon_b --dist-num-processes 2 fp32 (4 frames, two ranks sharing the "
            f"card over gloo): 2 steps per rank, #3 once per step per rank, averaged losses "
            f"equal on both ranks, rank 0 alone wrote step_2 and the log, "
            f"{len(recs[0]['digest'])} model tensors bit-equal across the ranks; step ms "
            + ", ".join(f"rank {r} {[round(t, 3) for t in rec['step_ms']]} (peak "
                        f"{max(rec['peaks']) / 2**30:.3f} GiB)" for r, rec in enumerate(recs))
            + f"; {cli_s:.1f} s for both processes")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["launches_sorted2"] = launches_sorted2
    return out


# ---------------------------------------------------------------------------
# Phases 33-37: parity --dumps, vis, train --remat, the rec-head options,
# profiling
# ---------------------------------------------------------------------------


def reference_layout(got, F, B=1, N=6):
    """The port's boundaries (`parity/compare.py` `run_boundaries`, its
    layouts) -> the npz entries the reference's `dump_reference.py` writes:
    the inverse of the comparator's adapters. Per-frame calls: @p<i> is
    call i-1, the bare name call F-1; single-call boundaries over all B*N*F
    cameras cam-major (the current frame's tiled where the port decodes the
    current frame only); the fused 2D lift input is not dumped."""
    def cam_major(x):  # (B*F*N frame-major, ...) -> (B*N*F, ...) cam-major
        x = x.reshape((B, F, N) + x.shape[1:])
        return np.swapaxes(x, 1, 2).reshape((B * N * F,) + x.shape[3:])

    def tile(x):  # current frame only (B*N, ...) -> (B*N*F, ...)
        x = x.reshape((B, N, 1) + x.shape[1:])
        return np.broadcast_to(x, (B, N, F) + x.shape[3:]).reshape((B * N * F,) + x.shape[3:])

    out = {}
    for name, a in got.items():
        base, _, tag = name.partition("@")
        c = int(tag[1:]) - 1 if tag else F - 1
        if base.startswith("clip_tokens."):
            sub = base.split(".", 1)[1]
            out[f"clip_tokens#0/{sub[:-4]}_cls_token" if sub.endswith("_cls")
                else f"clip_tokens#0/{sub}"] = (cam_major(a).transpose(1, 0, 2)
                                                if sub.endswith("_cls")
                                                else cam_major(a).transpose(0, 3, 1, 2))
        elif base in ("sa_mask_preds", "sa_attn_bias", "rec_mask_embs"):
            key = {"sa_mask_preds": "side_adapter#0/0/0", "sa_attn_bias": "side_adapter#0/1/0",
                   "rec_mask_embs": "rec_mask_embs#0"}[base]
            out[key] = tile(a)
        elif base == "rec_update_proj":
            out[f"rec_update#{c}/clip_feat_proj"] = a.transpose(0, 3, 1, 2)
        elif base == "hsa_attn_dense":
            out.update({f"hsa#{c}/1/{i}": a[i] for i in range(a.shape[0])})
        elif base == "hsa_supp":
            out[f"hsa#{c}/2/0"] = a.transpose(0, 3, 1, 2)
        elif base == "lift_vox":
            out[f"lift#{c}"] = a.transpose(0, 4, 1, 2, 3)
        elif base == "occ_early":
            out[f"occ_early#{c}"] = a.transpose(0, 4, 1, 2, 3)
        elif base in ("occ_bin", "occ_feat"):
            out[f"occ_heads#0/{'bin_occ' if base == 'occ_bin' else 'feat_occ'}"] = \
                a.transpose(0, 4, 1, 2, 3)
        elif base in ("out_sem_seg_ds", "out_sem_embed_ds", "out_clip_feat"):
            out[f"outputs#0/{base[4:]}"] = a.transpose(0, 1, 4, 2, 3)
        elif base in ("out_bin_occ", "out_feat_occ"):
            out[f"outputs#0/{base[4:]}"] = a.transpose(0, 4, 1, 2, 3)
    return out


def dump_inputs(imgs, depth, metas, depth_imgs=None):
    """The port's (B, F, N, ...) batch -> the reference dump's inputs.npz
    entries: cameras cam-major (B, N*F, ...), images NCHW."""
    def cm(x):
        x = x.cpu().numpy()
        B, F, N = x.shape[:3]
        return np.swapaxes(x, 1, 2).reshape((B, N * F) + x.shape[3:])

    out = {"imgs": cm(imgs).transpose(0, 1, 4, 2, 3), "depth": cm(depth),
           "bda": metas["bda"].cpu().numpy()}
    for k in ("sensor2egos", "ego2globals", "intrins", "post_rots", "post_trans"):
        out[k] = cm(metas[k])
    F = imgs.shape[1]
    if F > 1:
        out["adj_meta_0"] = metas["lidarego2global"].cpu().numpy()
        for i in range(1, F):
            out[f"adj_meta_{i}"] = metas["prev_lidarego2global"][:, i - 1].cpu().numpy()
    if depth_imgs is not None:
        d = cm(depth_imgs)
        out["depth_imgs_flat"] = d.reshape((-1,) + d.shape[2:]).transpose(0, 3, 1, 2)
    return out


@contextlib.contextmanager
def plain_kernels():
    """The pools' plain PyTorch versions on card tensors: kernels #1-#3's
    wrappers, as `ops/bev_pool.py` calls them, patched for the block."""
    from unittest import mock

    from veon_tpu_torch.ops import bev_pool as bp

    def sorted1(vals, rk, num_cells):
        return bp.bev_pool_sorted_plain([(vals, rk)], num_cells, vals.dtype)

    def sorted2(vals1, rk1, vals2, rk2, num_cells):
        return bp.bev_pool_sorted_plain([(vals1, rk1), (vals2, rk2)], num_cells, vals1.dtype)

    def pooled(depth, feat, order, rk, num_cells, pool_r):
        return bp.bev_pool_pooled_plain(bp.presorted_vals(depth, feat, order), rk, num_cells,
                                        pool_r, feat.dtype)

    with mock.patch.object(bp, "bev_pool_sorted", sorted1), \
            mock.patch.object(bp, "bev_pool_sorted2", sorted2), \
            mock.patch.object(bp, "bev_pool_pooled", pooled):
        yield


def write_dump(d, inputs, bnd):
    """inputs.npz, boundaries.npz and manifest.json under d; their bytes."""
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    np.savez(os.path.join(d, "boundaries.npz"), **bnd)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump({"boundaries": sorted({k.split("#")[0] for k in bnd})}, f)
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def _report_rows(out):
    """(boundary, verdict) of each row of a printed parity table."""
    rows = []
    for ln in out.splitlines():
        parts = ln.split()
        if parts and parts[-1] in ("ok", "FAIL") or "SKIP (" in ln:
            rows.append((parts[0], "SKIP" if "SKIP (" in ln else parts[-1]))
    return rows


def _proc_status(key):
    with open("/proc/self/status") as f:
        return next(int(ln.split()[1]) * 1024 for ln in f if ln.startswith(key))


def host_peak(fn, every=0.01):
    """(fn(), the largest resident bytes of this process sampled every
    `every` s while fn ran, its resident bytes before). Sampled: the card's
    machine does not let a process reset its high-water mark."""
    import threading

    before = _proc_status("VmRSS")
    peak, done = [before], threading.Event()

    def sample():
        while not done.wait(every):
            peak[0] = max(peak[0], _proc_status("VmRSS"))

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        out = fn()
    finally:
        done.set()
        th.join()
    return out, max(peak[0], _proc_status("VmRSS")), before


def parity_phase(root):
    """Phase 33, weights-day parity through the CLI, a main path: phase 15's
    full-width VEON-B files (fp32) loaded by the CLI's route, the example
    batch through the model with the pools' plain versions (`plain_kernels`)
    and its boundaries written as a reference dump in the reference's torch
    layouts (`reference_layout`); `parity --preset veon_b --dumps` with the
    same files on the card: every compared row ok (only the undumped
    lift_fused_2d skipped), kernel #3 once (the in-graph banded lift), and
    the host memory the command peaked at (`host_peak`, sampled). Then a copy with
    the inputs and the rec head's, side adapter's, heads' and outputs'
    boundaries, rec_mask_embs scaled by 1.05 (rel tolerance 1e-2): exit 1,
    that row alone FAIL. Then the T=2 and zoe legs at the tiny preset on
    the card, the dumps from the tiny files' model on the CPU."""
    import io
    from unittest import mock

    from veon_tpu_torch.cli import main as cli_mod
    from veon_tpu_torch.cli.shapes import example_batch, example_batch_full
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.parity.compare import run_boundaries

    cfg = presets.veon_b()
    paths = {"san": os.path.join(root, "clipsan", "SAN_ViT-B.pth"),
             "depth": os.path.join(root, "depth_pretrain", "depthanythingv2_pretrain_large.pth"),
             "bpe": os.path.join(root, "bpe_simple_vocab_16e6.txt.gz")}
    weights = ["--load-from", paths["san"], "--depth-load-from", paths["depth"], "--bpe-path",
               paths["bpe"]]
    dumps = tempfile.mkdtemp(prefix="veon_dump")
    res = {}
    try:
        t = time.perf_counter()
        model, _tower, ovw, _m, _e = cli_mod.build_model_and_params(
            cfg, paths["san"], paths["depth"], paths["bpe"], device="cuda")
        imgs, depth, metas = example_batch(cfg, device="cuda")
        kernels = reset_launches()
        with plain_kernels():
            got = run_boundaries(model, {"imgs": imgs, "depth": depth, "metas": metas}, ovw)
        plain_launches = {k: fn.launches for k, fn in kernels.items()}
        expect_launches(plain_launches, {k: 0 for k in kernels}, "the dump's plain forward")
        bnd = dict(reference_layout(got, 1), **{"outputs#0/ov_classifier_weight":
                                               ovw.cpu().numpy()})
        del model, got
        gc.collect()
        torch.cuda.empty_cache()
        d = os.path.join(dumps, "veon_b")
        nbytes = write_dump(d, dump_inputs(imgs, depth, metas), bnd)
        dump_s = time.perf_counter() - t
        (rows, out, cli_s, launches), peak, rss0 = host_peak(lambda: run_cli(
            ["parity", "--preset", "veon_b", "--dumps", d, *weights]))
        expect_launches(launches, {k: int(k == "bev_pool_sorted2") for k in launches},
                        "parity --preset veon_b")
        bad = [r for r in rows if r["ok"] is False]
        skipped = {r["boundary"] for r in rows if r["ok"] is None}
        if bad or skipped != {"lift_fused_2d"} or len(rows) < 20:
            raise AssertionError(f"parity veon_b: failed {bad}, skipped {skipped}\n{out}")
        compare_line = [ln for ln in out.splitlines() if ln.startswith("dump ")][0]
        worst = min(rows, key=lambda r: (r.get("cos", 1.0), -r.get("rel", 0.0)))
        shutil.rmtree(d, ignore_errors=True)
        # the corrupted copy: the inputs and a few boundaries (the rest would
        # only be re-read), one of them rec_mask_embs x 1.05
        keep = [k for k in bnd if k.split("#")[0] in ("rec_mask_embs", "side_adapter",
                                                      "occ_heads", "outputs")]
        small = {k: bnd[k] for k in keep}
        small["rec_mask_embs#0"] = small["rec_mask_embs#0"] * 1.05
        del bnd
        bad_d = os.path.join(dumps, "veon_b_bad")
        write_dump(bad_d, dump_inputs(imgs, depth, metas), small)
        t = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                cli_mod.main(["parity", "--preset", "veon_b", "--dumps", bad_d, *weights])
            except SystemExit as e:
                code = e.code
            else:
                code = 0
        bad_s = time.perf_counter() - t
        failed = [b for b, v in _report_rows(buf.getvalue()) if v == "FAIL"]
        if code != 1 or failed != ["rec_mask_embs"]:
            raise AssertionError(f"parity on a dump with rec_mask_embs x 1.05: exit {code}, "
                                 f"failed rows {failed}\n{buf.getvalue()[-3000:]}")
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(bad_d, ignore_errors=True)
        res["veon_b"] = dict(rows=rows, dump_bytes=nbytes, dump_s=dump_s, cli_s=cli_s,
                             compare_line=compare_line, launches=launches,
                             host_peak_bytes=peak, host_rss_before_bytes=rss0,
                             corrupted=dict(exit=code, failed=failed, s=bad_s,
                                            boundaries=len(small)))
        log(f"parity --preset veon_b fp32 (phase 15's files, the dump from the plain pools): "
            f"{sum(1 for r in rows if r['ok'])} rows ok, skipped {sorted(skipped)}, lowest cos "
            f"{worst['boundary']} {worst['cos']:.7f} (rel {worst['rel']:.3g}); {compare_line}; "
            f"this script's resident memory {rss0 / 2**30:.3f} GiB before the command, peak "
            f"{peak / 2**30:.3f} GiB during it (sampled every 10 ms); dump written in {dump_s:.1f} s, CLI "
            f"{cli_s:.1f} s, launches {launches}; rec_mask_embs x 1.05 ({len(small)} "
            f"boundaries): exit {code}, FAIL {failed}, {bad_s:.1f} s")
        # T=2 and the zoe leg at the tiny preset: files, the dump on the CPU, the CLI on the card
        tiny = {"t2": presets.veon_tiny_test(num_temporal=2),
                "zoe": with_tiny_zoe(presets.veon_tiny_test())}
        for leg, tcfg in tiny.items():
            troot = os.path.join(dumps, f"{leg}_w")
            tp, _s, _b = mirror_weights(tcfg, troot)
            model, _tower, ovw, _m, _e = cli_mod.build_model_and_params(
                tcfg, tp["san"], tp["depth"], tp["bpe"], device="cpu")
            if leg == "t2":
                imgs, depth, metas = example_batch(tcfg, device="cpu")
                depth_imgs, extra = None, {}
            else:
                imgs, depth_imgs, metas = example_batch_full(tcfg, device="cpu")
                rel = []
                h = model.depth.core.register_forward_hook(lambda _m, _a, o: rel.append(o[0]))
                with torch.no_grad():
                    depth = model.estimate_depth(depth_imgs)
                h.remove()
                extra = {"zoe_core#0/0": rel[-1].numpy()}
            got = run_boundaries(model, {"imgs": imgs, "depth": depth, "metas": metas}, ovw)
            bnd = dict(reference_layout(got, tcfg.num_temporal), **extra,
                       **{"outputs#0/ov_classifier_weight": ovw.numpy()})
            td = os.path.join(dumps, leg)
            tbytes = write_dump(td, dump_inputs(imgs, depth, metas, depth_imgs), bnd)
            preset = "veon_tiny_zoe" if leg == "zoe" else "veon_tiny_test"
            with mock.patch.object(presets, "veon_tiny_zoe", lambda **kw: with_tiny_zoe(
                    presets.veon_tiny_test(**kw)), create=True):
                trows, tout, ts, tl = run_cli([
                    "parity", "--preset", preset, "--num-temporal", str(tcfg.num_temporal),
                    "--dumps", td, "--load-from", tp["san"], "--depth-load-from", tp["depth"],
                    "--bpe-path", tp["bpe"]])
            names = {r["boundary"] for r in trows if r["ok"]}
            need = {"lift_vox@p1", "occ_early@p1", "hsa_supp@p1"} if leg == "t2" else \
                {"depth_pred", "zoe_rel_depth"}
            if any(r["ok"] is False for r in trows) or not need <= names:
                raise AssertionError(f"parity tiny {leg} card vs CPU dump:\n{tout}")
            res[leg] = dict(rows=trows, dump_bytes=tbytes, cli_s=ts, launches=tl)
            log(f"parity tiny {leg} (dump on the CPU, CLI on the card): {len(names)} rows ok "
                f"(among them {sorted(need)}), {tbytes} B, launches {tl}")
    finally:
        shutil.rmtree(dumps, ignore_errors=True)
    res["launches_sorted2"] = res["veon_b"]["launches"]["bev_pool_sorted2"]
    return res


def vis_phase(root):
    """Phase 34, `vis --preset veon_b` through the CLI, a main path, fp32
    with seeded weights: on the synthetic batch and on the first frame of
    phase 18's shard (--ann): occ_bev.png (200, 200, 3), occ_slices.png
    (200, 3200, 3), the PLY's vertex count equal to the non-free voxels of
    the predicted grid (captured at the CLI's fusion rule) and to the NPY's
    rows, one overlay per camera at the input size; kernel #3 once per run."""
    from PIL import Image

    from veon_tpu_torch.cli import main as cli_mod

    res = {}
    work = tempfile.mkdtemp(prefix="veon_vis")
    fused, preds = cli_mod.fused_classes, []
    cli_mod.fused_classes = lambda out, m: preds.append(fused(out, m)) or preds[-1]
    try:
        for src, extra in (("synthetic", ["--ann", os.path.join(work, "absent.pkl")]),
                           ("shard", ["--ann", os.path.join(root, "infos.pkl"), "--data-root",
                                      root])):
            wd = os.path.join(work, src)
            paths, out, s, launches = run_cli(["vis", "--preset", "veon_b", "--work-dir", wd,
                                               *extra])
            expect_launches(launches, {k: int(k == "bev_pool_sorted2") for k in launches},
                            f"vis {src}")
            pred = preds[-1][0].cpu().numpy()
            shapes = {k: np.asarray(Image.open(paths[k])).shape for k in ("bev", "slices")}
            cams = [np.asarray(Image.open(p)).shape for p in paths["semseg"]]
            with open(paths["ply"]) as f:
                head = [next(f) for _ in range(3)][2].split()
            verts = np.load(paths["npy"])
            nonfree = int((pred < 17).sum())
            if shapes != {"bev": (200, 200, 3), "slices": (200, 3200, 3)} or \
                    int(head[2]) != nonfree or len(verts) != nonfree or \
                    cams != [(512, 1408, 3)] * 6:
                raise AssertionError(f"vis {src}: {shapes}, PLY {head}, {len(verts)} points vs "
                                     f"{nonfree} non-free voxels, overlays {cams}")
            res[src] = dict(s=s, launches=launches, vertices=nonfree, shapes=shapes,
                            ply_bytes=os.path.getsize(paths["ply"]))
            log(f"vis --preset veon_b fp32 on the {src} frame: {shapes}, {nonfree} points in the "
                f"PLY ({os.path.getsize(paths['ply'])} B) = the grid's non-free voxels, 6 "
                f"overlays (512, 1408, 3); {s:.1f} s, launches {launches}")
    finally:
        cli_mod.fused_classes = fused
        shutil.rmtree(work, ignore_errors=True)
    res["launches_sorted2"] = sum(res[k]["launches"]["bev_pool_sorted2"] for k in
                                  ("synthetic", "shard"))
    return res


REMAT_POLICIES = ("none", "full", "dots_saveable")


def remat_phase(root, frames=2):
    """Phase 35, `train --remat` through the CLI, a main path: `train
    --preset veon_b --remat P` fp32 for P in none, full, dots_saveable, one
    epoch on the first `frames` frames of the shard with LiDAR sweeps, #3
    once per step; each step's losses and the trained model's running stats
    against none's within phase 26's tolerances (losses 1e-4, stats 1e-4,
    relative above 1: the card's step does not repeat bit for bit), ms/step
    and the peak above the phase's start. Then `train_entry` bf16 under each
    policy from seed 0: the first step's losses and running stats against
    none's (same tolerances), the median of 3 more steps and the peak."""
    from veon_tpu_torch.cli import main as cli_mod
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import train_entry

    pkl = train_shard(root, frames)
    base = ["--preset", "veon_b", "--data-root", root, "--ann", pkl, "--workers", "2",
            "--epochs", "1"]
    res, runs, launches_sorted2 = {"cli": {}, "bf16": {}}, {}, 0
    orig = cli_mod.make_train_step
    for pol in REMAT_POLICIES:
        work = tempfile.mkdtemp(prefix="veon_remat", dir=root)
        models = []
        cli_mod.make_train_step = lambda model, *a, **k: (models.append(model),
                                                          orig(model, *a, **k))[1]
        start = phase_base()
        try:
            with step_probe("make_train_step", peaks=True) as probe:
                out, _o, s, launches = run_cli(["train", *base, "--remat", pol, "--work-dir",
                                                work])
        finally:
            cli_mod.make_train_step = orig
            shutil.rmtree(work, ignore_errors=True)
        want = {k: int(k == "bev_pool_sorted2") for k in launches}
        for i, got in enumerate(probe.launches):
            expect_launches(got, want, f"train --remat {pol} step {i + 1}")
        launches_sorted2 += launches["bev_pool_sorted2"]
        model = models[-1]
        if model.remat != {"none": False, "full": True}.get(pol, pol) or out["step"] != frames:
            raise AssertionError(f"train --remat {pol}: model.remat {model.remat}, {out}")
        runs[pol] = dict(losses=probe.losses, buffers={n: b.detach().cpu().clone()
                                                       for n, b in model.named_buffers()})
        peak = max(probe.peaks) - start
        res["cli"][pol] = dict(step_ms=probe.ms, peak_bytes=peak, losses=probe.losses, s=s)
        del model, models
        log(f"train --preset veon_b --remat {pol} fp32 ({frames} frames): step ms "
            f"{[round(t, 3) for t in probe.ms]}, peak above the phase's start "
            f"{peak / 2**30:.3f} GiB, losses {probe.losses[-1]}")
    for pol in REMAT_POLICIES[1:]:
        res["cli"][pol]["vs_none"] = _agree(runs["none"], runs[pol], f"train --remat {pol}")

    cfg = presets.veon_b(compute_dtype="bfloat16")
    first = {}
    for pol in REMAT_POLICIES:
        start = phase_base()
        torch.cuda.reset_peak_memory_stats()
        trainer, batch = train_entry(cfg, seed=0, remat=cli_mod.parse_policy(pol))
        kernels = reset_launches()
        ms = []
        for i in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses = trainer(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                first[pol] = dict(losses=[{k: float(v) for k, v in losses.items()}],
                                  buffers={n: b.detach().cpu().clone()
                                           for n, b in trainer.model.named_buffers()})
        peak = torch.cuda.max_memory_allocated() - start
        launches = {k: fn.launches for k, fn in kernels.items()}
        expect_launches(launches, {k: 4 * int(k == "bev_pool_sorted2") for k in launches},
                        f"train_entry bf16 remat {pol}")
        launches_sorted2 += 4
        del trainer, batch
        res["bf16"][pol] = dict(step_ms=ms, warm_ms=statistics.median(ms[1:]), peak_bytes=peak)
        log(f"train_entry veon_b bf16 remat {pol}: step ms {[round(t, 3) for t in ms]}, warm "
            f"median {statistics.median(ms[1:]):.3f} ms, peak above the phase's start "
            f"{peak / 2**30:.3f} GiB")
    for pol in REMAT_POLICIES[1:]:
        res["bf16"][pol]["vs_none"] = _agree(first["none"], first[pol],
                                             f"train_entry bf16 remat {pol}")
    res["launches_sorted2"] = launches_sorted2
    return res


def _agree(want, got, what):
    """Losses (step by step) and running stats of two runs within phase 26's
    tolerances (1e-4, relative above 1); the differences."""
    loss = max(abs(g[k] - v) / max(abs(v), 1.0) for w, g in zip(want["losses"], got["losses"])
               for k, v in w.items())
    stats = max(((got["buffers"][n].float() - v.float()).abs()
                 / v.float().abs().clamp_min(1.0)).max().item()
                for n, v in want["buffers"].items())
    if len(want["losses"]) != len(got["losses"]) or not (loss <= 1e-4 and stats <= 1e-4):
        raise AssertionError(f"{what} vs none: losses off by {loss:.3g}, running stats by "
                             f"{stats:.3g} (tolerance 1e-4)")
    log(f"{what} vs none: losses within {loss:.3g}, running stats within {stats:.3g}")
    return dict(loss=loss, stats=stats)


def rec_options(cfg):
    """cfg with REC_CROSS_ATTN=False and the bilinear rec-bias downsample."""
    return dataclasses.replace(cfg, san=dataclasses.replace(
        cfg.san, rec_cross_attn=False, rec_downsample_method="bilinear"))


def rec_options_phase():
    """Phase 36, REC_CROSS_ATTN=False with the bilinear rec downsample: the
    tiny preset card vs CPU (phase 5's checks), then a main path at full
    VEON-B width in bf16 through `entry` (phase 6's: 3 frames, kernel #1
    once per frame), the rec head's mask embeddings finite with unit norm
    (1e-2 in bf16), and the dense mask's bytes as the rec head builds it."""
    from veon_tpu_torch.configs import presets

    small = small_parity_phase(rec_options(presets.veon_tiny_test()))
    server, (imgs, depth_imgs), res = main_path(rec_options(presets.veon_b(
        compute_dtype="bfloat16")))
    embs, masks = [], []
    from veon_tpu_torch.nn import vit

    build = vit.rec_self_attn_mask
    vit.rec_self_attn_mask = lambda b: masks.append(build(b)) or masks[-1]
    h = server.model.rec_head.register_forward_hook(lambda _m, _a, o: embs.append(o))
    try:
        server.outputs(imgs, depth_imgs)
    finally:
        h.remove()
        vit.rec_self_attn_mask = build
    e = embs[-1].float()
    norm = torch.linalg.vector_norm(e, dim=-1)
    if not (torch.isfinite(e).all() and (norm - 1).abs().max() < 1e-2):
        raise AssertionError(f"self-attention rec head: embeddings finite "
                             f"{bool(torch.isfinite(e).all())}, norm {norm.min()}..{norm.max()}")
    m = masks[-1]
    res.update(small=small, emb_shape=tuple(e.shape), norm_err=float((norm - 1).abs().max()),
               mask_shape=tuple(m.shape), mask_bytes=m.numel() * m.element_size())
    log(f"REC_CROSS_ATTN=False + bilinear, veon_b bf16: mask embeddings {tuple(e.shape)} finite, "
        f"|norm - 1| <= {res['norm_err']:.3g}; the dense mask {tuple(m.shape)} {m.dtype}, "
        f"{res['mask_bytes']} B")
    del server
    return res


def profiling_phase():
    """Phase 37, the profiling tools on the card: `lift_microbench` at the
    JAX microbench's VEON-B lift shapes (the full-frustum lift, kernel #2
    once per call: 5 warm-up + 10 timed), `flops` of the F=1 bf16 forward
    (`entry`), a Chrome trace of one frame written by `trace` and parsed:
    its device kernel events and their time beside the host's."""
    from veon_tpu_torch.entry import entry
    from veon_tpu_torch.utils import profiling

    kernels = reset_launches()
    bench = profiling.lift_microbench(n_iters=10)
    launches = {k: fn.launches for k, fn in kernels.items()}
    expect_launches(launches, {k: 15 * int(k == "bev_pool_sorted") for k in launches},
                    "lift_microbench")
    server, (imgs, depth_imgs) = entry(seed=0)
    fl = profiling.flops(server.model.full_forward, imgs, depth_imgs, server.metas,
                         server.ov_weight)
    server(imgs, depth_imgs)  # warm
    d = tempfile.mkdtemp(prefix="veon_trace")
    try:
        t = time.perf_counter()
        with profiling.trace(d) as path:
            server(imgs, depth_imgs)
        host_ms = (time.perf_counter() - t) * 1e3
        trace_bytes = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    dev = [e for e in events if e.get("cat") == "kernel"]
    dev_ms = sum(e.get("dur", 0) for e in dev) / 1e3
    pooled = sum(1 for e in dev if "bev_pool_pooled" in e.get("name", ""))
    if not dev or pooled != 1 or not fl["flops"] > 0:
        raise AssertionError(f"trace: {len(dev)} device kernels, #1 in it {pooled} times; "
                             f"flops {fl['flops']}")
    top = sorted(fl["by_op"].items(), key=lambda kv: -kv[1])[:4]
    log(f"lift_microbench veon_b shapes fp32: {bench['ms_per_iter']:.3f} ms/iter "
        f"({bench['fps']:.1f} /s), launches {launches}; flops of the F=1 bf16 forward "
        f"{fl['flops']:.4g} (matmuls, convolutions, attention: {top}); trace of one frame "
        f"{trace_bytes} B, {len(dev)} device kernels, {dev_ms:.3f} ms of kernel time in "
        f"{host_ms:.3f} ms on the host, #1 once")
    del server
    return dict(lift_microbench=bench, launches=launches, flops=fl["flops"], flops_by_op=top,
                trace_bytes=trace_bytes, trace_kernels=len(dev), trace_kernel_ms=dev_ms,
                trace_host_ms=host_ms)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.ops import native

    script_t0 = time.perf_counter()
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
    laps, last = {}, [time.perf_counter()]

    def lap(name):
        """Seconds since the last lap, kept per group of phases."""
        now = time.perf_counter()
        laps[name], last[0] = round(now - last[0], 1), now

    cfg = presets.veon_b(compute_dtype="bfloat16")
    kern, (metas, pre, feat, metric, dist) = kernel_phase(cfg)
    sorted_res = sorted_kernel_phase(cfg, metas, feat, metric)
    backward = pooled_backward_phase(cfg, pre, feat, dist)
    del metas, pre, feat, metric, dist
    torch.cuda.empty_cache()
    ln = ln_dense_phase()
    lap("1-2 kernels")
    train_small = train_parity_phase()
    train = train_phase(cfg)
    lap("3-4 train step")
    small = small_parity_phase()
    server, inputs, main_res = main_path(cfg)
    where = breakdown(server, *inputs)
    lap("5-7 serving")
    del server, inputs
    torch.cuda.empty_cache()
    temporal_small = temporal_parity_phase()
    session, reqs, temporal = temporal_main_path()
    temporal_where = temporal_breakdown(session, reqs)
    batched = batched_temporal_phase(session, reqs)
    lap("8-9 streaming")
    del session, reqs
    torch.cuda.empty_cache()
    text = text_tower_phase()
    lap("10 text tower")
    grid, serve_f1 = frame_server_phase()
    serve_t2 = streaming_server_phase()
    lap("11-12 sockets")
    metrics = metrics_phase(grid)
    weights_tiny = weights_tiny_phase()
    lap("13-14 metrics, tiny weights")
    ckpt_root = tempfile.mkdtemp(prefix="veon_b_ckpts")
    try:
        variables, weights = weights_main_path(main_res["median_ms"], ckpt_root)
        new_presets = presets_phase(main_res["median_ms"])
        lap("15-16 weights, presets")
        precision = precision_phase(variables)
        lap("17 precision")
        del variables
        gc.collect()
        parity = parity_phase(ckpt_root)
        lap("33 parity")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    zoe_tiny = small_parity_phase(with_tiny_zoe(presets.veon_tiny_test()))
    zoe_f1 = zoe_main_path()
    _session, _reqs, zoe_t2 = temporal_main_path(
        presets.veon_b_zoe(num_temporal=2, compute_dtype="bfloat16"))
    del _session, _reqs
    if zoe_t2["depth_input"] != (256, 704):
        raise AssertionError(f"zoe drive depth input {zoe_t2['depth_input']}")
    variables, zoe_weights = zoe_weights_phase()
    zoe_precision = precision_phase(variables, "veon_b_zoe")
    lap("20-24 zoe")
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
        lap("18 data plane")
        eval_tiny = eval_tiny_parity_phase(shard)
        eval_loop = eval_loop_phase(shard, frames=4)
        lap("19 eval loop")
        zoe_eval = zoe_eval_phase(shard)
        lap("25 zoe eval")
        stages = train_stages_parity_phase(shard)
        lap("26 training parity")
        train_cli = train_cli_phase(shard, frames=2)
        lap("27 train CLI")
        pretrain = {"veon_b": pretrain_cli_phase(shard, "veon_b", 4),
                    "veon_b_zoe": pretrain_cli_phase(shard, "veon_b_zoe", 2)}
        lap("28 pretrain CLI")
        overfit = overfit_phase()
        lap("29 overfit")
        temporal_train_small = temporal_train_parity_phase()
        lap("30 temporal parity")
        temporal_cli = temporal_cli_phase(shard, frames=2)
        lap("31 temporal CLI")
        data_parallel = data_parallel_phase(shard)
        lap("32 data parallel")
        vis = vis_phase(shard)
        lap("34 vis")
        remat = remat_phase(shard)
        lap("35 remat")
    finally:
        shutil.rmtree(shard, ignore_errors=True)
    rec_opts = rec_options_phase()
    lap("36 rec options")
    prof = profiling_phase()
    lap("37 profiling")

    # launches on the main paths: the F=1 frames, the requests served from
    # converted weights and the new presets' frames, the zoe frames, calls
    # and served requests (#1); the train steps (#2, #3), the weights
    # drills' forwards and the eval loops' frames, zoe's included, the CLI
    # train steps and the frames of `test` on their checkpoints, the
    # temporal train steps (F per step), the data-parallel steps (#3); the
    # F=2 full-frustum temporal step (#2); phases 33-37: the parity, vis and
    # train --remat runs (#3), the REC_CROSS_ATTN=False frames (#1), the
    # lift microbench's calls (#2)
    rows = {"bev_pool_pooled": (kern["bf16"], main_res["launches"]["bev_pool_pooled"]
                                + sum(weights["launches_per_request"])
                                + new_presets["launches"]["bev_pool_pooled"]
                                + zoe_f1["launches"]["bev_pool_pooled"]
                                + zoe_t2["launches"]["bev_pool_pooled"]
                                + zoe_weights["launches_pooled"]
                                + rec_opts["launches"]["bev_pool_pooled"]),
            "bev_pool_sorted": (sorted_res["full_bf16"],
                                train["full"]["launches"]["bev_pool_sorted"]
                                + temporal_cli["launches_sorted"]
                                + prof["launches"]["bev_pool_sorted"]),
            "bev_pool_sorted2": (sorted_res["band_spray_bf16"],
                                 train["banded"]["launches"]["bev_pool_sorted2"]
                                 + weights["drill_launches"]["bev_pool_sorted2"]
                                 + eval_loop["launches_sorted2"]
                                 + zoe_weights["drill_launches"]["bev_pool_sorted2"]
                                 + zoe_eval["launches"]["bev_pool_sorted2"]
                                 + train_cli["launches_sorted2"]
                                 + temporal_cli["launches_sorted2"]
                                 + data_parallel["launches_sorted2"]
                                 + parity["launches_sorted2"] + vis["launches_sorted2"]
                                 + remat["launches_sorted2"]),
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
                   "eval_loop": eval_loop, "zoe_tiny_parity": zoe_tiny, "zoe_f1": zoe_f1,
                   "zoe_t2": zoe_t2, "zoe_weights": zoe_weights,
                   "zoe_precision": zoe_precision, "zoe_eval": zoe_eval,
                   "train_stages_parity": stages, "train_cli": train_cli,
                   "pretrain_cli": pretrain, "overfit": overfit,
                   "temporal_train_parity": temporal_train_small,
                   "temporal_cli": temporal_cli, "data_parallel": data_parallel,
                   "parity": parity, "vis": vis, "remat": remat, "rec_options": rec_opts,
                   "profiling": prof,
                   "builds": {k: v["seconds"] for k, v in builds.items()}, "phase_s": laps,
                   "script_s": time.perf_counter() - script_t0},
                  f, indent=1)
    for r, _ in rows.values():
        if not all(math.isfinite(r[k]) for k in ("ms", "plain_ms", "library_ms", "bound_ms")):
            raise AssertionError("non-finite timing")
    log(f"phase seconds: {laps}")
    log(f"whole script: {time.perf_counter() - script_t0:.1f} s wall")
    log(smi)
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:  # a rank of phase 32, started by _spawn_ranks
        {"step": _dp_step_worker, "cli": _dp_cli_worker}[sys.argv[2]](*sys.argv[3:])
        sys.exit(0)
    sys.exit(main())
