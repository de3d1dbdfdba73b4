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
     time's share of the bound; the deformable stencil (the port's own
     kernel, `csrc/deform_stencil.cu`) at VEON-B's fusion shape, every
     tap's q.k and the output against the plain version, with L2 flushed
     and warm, in turns with the plain chain; fp32 and bf16;
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
     around exactly those calls (kernel #1 once per call, the deformable
     stencil twice); then where a
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
     numpy, loader frames/s over 5 frames (cut from 8 for the script's
     time) with 2 and 4 workers in thread and in process mode (forked after
     the card's context exists);
 19. the eval loop, a main path: the tiny fixture's `test` with mirror
     files card vs CPU, then through `cli/main.py` `main` at full VEON-B
     width with seeded weights, fp32: `test` over 4 frames (kernel #3 once
     per frame), `--pipeline 2` and `--raw-uint8` (equal grids),
     `--num-temporal 2` (#3 twice per frame), `test --retrieval` on a
     3-item CSV, `cache-depth` on 2 frames (idempotent), and `benchmark
     --eval` in bf16 over 6 frames, whose JSON line is logged;
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
     --num-temporal 2 --ckpt` on its checkpoint (the deformable stencil
     twice per two-frame step and test frame); ms/step and peak per
     epoch; `train_entry` bf16 at F=2 and F=4 (the stencil twice per step;
     peaks, the temporal fusion's autograd bytes on both routes) and one
     F=2 step with lss_banded=False (#2 twice);
 32. data parallel on the card (run with phase 19's shard): (a) VEON-B
     bf16 under a one-rank NCCL group against the plain step (bit-equal
     where the plain step repeats bit for bit), then 6 warm steps of
     each (cut from 12 for the script's time), alternating, medians with
     their spread; (b) two gloo ranks
     sharing the card, tiny, one step, against the same two ranks on the
     CPU, run beside (c); (c) a main path: `train --preset veon_b --dist-num-processes 2
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
 38. `export --preset veon_b` (F=1 bf16) through the CLI, a main path: export
     s, `.pt2` bytes, load s, the graph's kernel #1 node and device copies;
     the loaded program on the live `FrameServer`'s frame: the class grid
     equal, kernel #1 once per call; both timed in turns;
 39. `export --num-temporal 2` (fp32, the preset's dtype) and with
     `--raw-uint8`, a main path: 4 drive calls through each program beside
     a live `TemporalSession`, the cache rolled by hand: outputs equal,
     kernel #1 once per call; the float program and the live step timed
     in turns. The three `export` calls of 38-39 run at once, each in a
     process of this script, started beside phase 33, which times
     nothing;
 40. `benchmark` through the CLI, a main path: live F=1 bf16, `--num-temporal
     2` bf16, `--artifact` on both programs; the JSON lines and the F=1
     artifact-to-live ratio (phases 38-39 also time each program in turns
     with its live module);
 41. `serve_exported` of the F=1 program, a main path, served in phase
     43(d)'s turns: 4 requests through `TensorClient` (the frame, then
     perturbed by i * 1e-3), pred equal to the live grid, kernel #1 once
     each.
 42. camera sharding (`serve/camshard.py`), ranks of this script
     (`--dp-worker cs_*`) sharing the card over gloo: (a) the tiny preset
     in fp32 at S=2 and S=3: the stacked presort on the card integer-equal
     to the CPU's, the presorted sharded forward against the unsharded one
     on the CPU at 2e-4 (#2 once per rank), #2 against its plain version on
     each rank's stream; one SGD step on a 2 x 2 (batch x cam) grid, its
     parameter deltas equal to the unsharded step's; (b) a main path:
     `serve_entry(cam_group=)` at VEON-B width in bf16 on 3 ranks, 3 frames
     through a `TensorServer` on rank 0, the others following, #2 once per
     frame per rank and #1 never; frame 0 in fp32 on the same ranks
     against `entry`'s unsharded one (class grid >= 0.999 off near-ties,
     feat_occ and sem_occ_raw within 1e-3), each bf16 frame's class grid
     >= 0.999 off near-ties against the same weights run shard by shard in
     one process, frame 0's outputs within 1e-2 of their largest value
     (bf16 GEMMs round by how many cameras they batch, so the
     unsharded bf16 frame is reported, not held), ms per frame with the
     all-reduce's share, each rank's peak, #2 timed
     on a rank's stream; (c) a main path: a T=2
     `TemporalSession(cam_group=)` on 2 ranks, 4 drive calls against
     `temporal_entry`'s unsharded session, #2 once per call per rank; (d) a
     main path: 2 sharded `train_entry`-recipe steps on 2 ranks, #3 once per
     step per rank, losses within rtol 1e-3 of the unsharded steps, #3
     timed on a rank's streams. (b) runs alone; (a), (c) and (d) run
     beside phase 33 (which times nothing), their ranks started before it
     and awaited after it, so their times are contended and held to
     nothing; #3 is timed after (b).
 43. serving with no Python in the loop (`export --native`, the op library
     `veon_ops`, the C++ runner and daemon over libtorch): (a) right after
     phase 2 (so the kernels' timings run alone), the ops program's inputs
     at the flagship shapes are written and two processes of this script
     (`--dp-worker native`, 1 compile worker each) start the AOTInductor
     compiles beside the phases that follow, whose times are then
     contended: `export --native --preset veon_b` (F=1 bf16), then the
     package run in Python on (d)'s requests; and the host programs' g++
     builds, a small package of kernels #1-#3 and the tiny fp32 bundles
     (F=1, `--split-output 2`, `--num-temporal 2`), then (b) and (c). (b)
     and (c) time nothing; all is awaited at phase 41. The Inductor and Triton
     caches are kept in the checkout's build/ (a cold cache on a fresh
     checkout). (b) the small package through
     `veon_aoti_runner`: veon_ops' CUDA #1, #2 (full frustum, K-band) and
     #3 bit-equal to the Python ops, its counters 1 / 2 / 1; (c) each tiny
     bundle served by the daemon against the live port module on the CPU
     with the same weights: the class grid off near-ties, and for T=2 (3
     drive calls, the cache rolled by the client) the float outputs within
     2e-4 and the C++ stencil op twice a request; (d) a main path, while phase 38's program and live
     server exist: `veon_serve_host` serves the VEON-B bundle to
     `TensorClient`, 1 + 3 requests, #1 once per request by the op
     library's counter, each grid bit-equal to the same package run in
     Python and agreeing with the live bf16 frame off near-ties (flip <
     0.15); the daemon's, `serve_exported`'s (phase 41) and the live
     frame's times in turns, the daemon's device memory; (e)
     `utils/train_bench.py` at VEON-B bf16 (forward and loss, remat full
     and none, dots_saveable's peak; #3 once per call and step) and
     `utils/roofline.py`'s floors against phase 6's frame.
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
# the port's own kernels, which replace no TPU kernel (kept out of KERNELS,
# whose launches every phase expects by name)
OWN_KERNELS = {"deform_stencil": ("veon_tpu_torch/csrc/deform_stencil.cu", None)}
# the temporal fusion's deformable layer at VEON-B: (B, D, H, W, C), heads, samples
STENCIL_SHAPE, STENCIL_HEADS, STENCIL_SAMPLES = (1, 8, 100, 100, 256), 4, 8


def log(*a):
    print(*a, flush=True)


def kernel_fns():
    """{name: wrapper} of every kernel in KERNELS (each counts its launches)."""
    from veon_tpu_torch.ops import bev_pool as bp
    from veon_tpu_torch.ops import fused_ln

    mods = {"ln_dense": fused_ln}
    return {k: getattr(mods.get(k, bp), k) for k in KERNELS}


def deform_stencil_launches():
    from veon_tpu_torch.ops import deform_stencil as ds

    return ds.deform_stencil.launches


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


def deform_stencil_phase():
    """The deformable stencil kernel (`csrc/deform_stencil.cu`, the port's
    own: the JAX package leaves the stencil to XLA) against its plain
    version (`deform_stencil_plain`) at VEON-B's fusion shape, seeded inputs
    on the card, fp32 and bf16: every tap's q.k and the output within 1e-5
    (fp32) or one bf16 ulp (bf16), with the share of elements equal bit for
    bit. Times in turns (plain, kernel, kernel, plain): the registered op
    with L2 flushed (`cold_times`) and warm (`time_ms`), the plain chain
    likewise, and both ops' peak-memory deltas. Bound: off, q and kv read
    once and the output written once over the HBM rate, against 4 C
    operations a voxel and tap over the fp32 rate."""
    from veon_tpu_torch.ops import deform_stencil as ds

    dev = torch.device("cuda")
    (B, D, H, W, C), nh, ns = STENCIL_SHAPE, STENCIL_HEADS, STENCIL_SAMPLES
    hd = C // nh
    g = torch.Generator(device=dev).manual_seed(17)
    off32 = torch.tanh(2 * torch.randn(B, D, H, W, nh * ns * 3, generator=g, device=dev))
    q32 = torch.randn(B, D, H, W, C, generator=g, device=dev)
    kv32 = torch.randn(B, D, H, W, 2 * C, generator=g, device=dev)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    launches0 = ds.deform_stencil.launches
    results = {"shape": list(STENCIL_SHAPE), "heads": nh, "samples": ns}
    for dt, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        off, q, kv = off32.to(dt), q32.to(dt), kv32.to(dt)
        taps = torch.empty(B, D, H, W, nh, 27, device=dev)
        got = ds.launch(off, q, kv, nh, ns, dt_out=taps)
        plain = ds.deform_stencil_plain(off, q, kv, nh, ns)
        qs = q.reshape(B, D, H, W, nh, hd) * hd ** -0.5
        kvp = ds._edge_pad3d(kv.reshape(B, D, H, W, nh, 2 * hd))
        plain_taps = torch.stack([(qs * ds._shift3d(kvp, t)[..., :hd]).sum(-1)
                                  for t in ds._TAPS], -1).float()
        del qs, kvp
        torch.cuda.synchronize()
        checks = {}
        for what, a, b in (("taps", taps, plain_taps), ("output", got, plain)):
            af, bf = a.float(), b.float()
            if dt == torch.float32:
                torch.testing.assert_close(af, bf, rtol=1e-5, atol=1e-5,
                                           msg=f"deform_stencil {name} {what}")
            else:  # as check_kernel: one ulp on top of the fp32 tolerance
                over = (af - bf).abs() - (bf16_ulp(torch.maximum(af.abs(), bf.abs())) + 1e-5
                                          + 1e-5 * bf.abs())
                if over.max().item() > 0:
                    raise AssertionError(f"deform_stencil {name} {what}: more than one bf16 ulp "
                                         f"from the plain version: {over.max().item()}")
            checks[what] = dict(max_abs_err=(af - bf).abs().max().item(),
                                bit_equal_share=(a == b).float().mean().item())
        del got, plain, taps, plain_taps
        calls = {"kernel": lambda: ds.deform_stencil(off, q, kv, nh, ns),
                 "plain": lambda: ds.deform_stencil_plain(off, q, kv, nh, ns)}
        for fn in calls.values():
            fn()
        cold = {k: [] for k in calls}
        for k in ("plain", "kernel", "kernel", "plain"):
            cold[k] += cold_times(calls[k], flush)
        cold = {k: statistics.median(v) for k, v in cold.items()}
        warm = {k: [] for k in calls}
        for k in ("kernel", "plain", "plain", "kernel"):
            warm[k].append(time_ms(calls[k]))
        warm = {k: min(v) for k, v in warm.items()}
        peak = {k: peak_delta(fn) for k, fn in calls.items()}
        elt = q.element_size()
        nbytes = (off.numel() + 2 * q.numel() + kv.numel()) * elt
        ops = 27 * 4 * B * D * H * W * C
        bound_ms, bound_by = bound(nbytes, ops)
        results[name] = dict(
            checks=checks, max_abs_err=checks["output"]["max_abs_err"], ms=cold["kernel"],
            plain_ms=cold["plain"], warm_ms=warm["kernel"], warm_plain_ms=warm["plain"],
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
            bound_share=bound_ms / cold["kernel"], peak_delta_bytes=peak["kernel"],
            plain_peak_delta_bytes=peak["plain"])
        log(f"kernel deform_stencil {name} {STENCIL_SHAPE}, {nh} heads x {ns} samples: L2 flushed: "
            f"kernel {cold['kernel']:.4f} ms, plain {cold['plain']:.4f} ms; warm: kernel "
            f"{warm['kernel']:.4f}, plain {warm['plain']:.4f} ms; bound {bound_ms:.4f} ms "
            f"({bound_by}, {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), share "
            f"{bound_ms / cold['kernel']:.3f}; peak memory delta kernel "
            f"{peak['kernel'] / 2**20:.1f} MiB, plain {peak['plain'] / 2**20:.1f} MiB; checks "
            f"{checks}")
        del off, q, kv
    results["phase_launches"] = ds.deform_stencil.launches - launches0
    del flush
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
    once per call, no other kernel of KERNELS, the deformable stencil twice
    per call."""
    from veon_tpu_torch.entry import temporal_entry

    base = phase_base()
    t0 = time.perf_counter()
    session, reqs = temporal_entry(cfg, device="cuda", seed=0, frames=calls)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    stencil0 = deform_stencil_launches()
    times, out = [], None
    for r in reqs:
        t = time.perf_counter()
        out = session.infer(r["imgs"], r["depth_imgs"], {"lidarego2global": r["lidarego2global"]})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = {k: fn.launches for k, fn in kernels.items()}
    stencil = deform_stencil_launches() - stencil0
    peak = torch.cuda.max_memory_allocated()
    want = {k: calls if k == "bev_pool_pooled" else 0 for k in launches}
    if launches != want or stencil != 2 * calls:
        raise AssertionError(f"temporal launches {launches}, deform_stencil {stencil} in {calls} "
                             f"calls, expected {want}, deform_stencil {2 * calls}")
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
                               launches=launches, stencil_launches=stencil, setup_s=setup_s,
                               classes=classes,
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
    first 5 frames of the 900x1600 JPEG shard under root with 2 and 4
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
    pkl = shard_paths(root, 5, "loader")
    fps = {}
    for mode in ("thread", "process"):
        for workers in (2, 4):
            fps[f"{mode}_{workers}"] = loader_fps(pkl, root, workers, mode)
    log(f"loader frames/s on the 900x1600 shard (VEON-B eval samples, 5 frames, "
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
    bf16 over 6 frames of its own shard, whose JSON line is logged."""
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
    bench, _out, s, launches = run_cli(["benchmark", "--eval", "--frames", "6"])
    expect_launches(launches, {n: 19 if n == "bev_pool_sorted2" else 0 for n in launches},
                    "benchmark --eval (1 cold + 6 + 6 pipelined + 6 e2e frames)")
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
    stencil = [deform_stencil_launches()]
    with step_probe("make_train_step", peaks=True) as probe:
        first, _o1, s1, l1 = run_cli(["train", *base, "--epochs", "2"])
        stencil.append(deform_stencil_launches())
        second, out2, s2, l2 = run_cli(["train", *base, "--epochs", "3", "--auto-resume"])
        stencil.append(deform_stencil_launches())
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
    stencil.append(deform_stencil_launches())
    expect_launches(lt, {k: 2 * frames if k == "bev_pool_sorted2" else 0 for k in lt},
                    "test --num-temporal 2 --ckpt")
    # the fusion's deformable layer twice a two-frame step or frame, in the
    # forward (its backward re-runs the plain version): train epochs 1 and 2
    # (`frames` steps each), the test's frames
    stencil = [b - a for a, b in zip(stencil, stencil[1:])]
    if stencil != [2 * frames] * 3:
        raise AssertionError(f"deform_stencil launches {stencil} in train --epochs 2, "
                             f"--auto-resume and test, expected {2 * frames} each")
    if not np.isfinite(r["mIoU"]):
        raise AssertionError(f"test --num-temporal 2 --ckpt mIoU {r['mIoU']}")
    shutil.rmtree(work, ignore_errors=True)
    launches_sorted2 += sum(d["bev_pool_sorted2"] for d in probe.launches) + lt["bev_pool_sorted2"]
    res["cli"] = dict(epochs=epochs, losses=probe.losses, cli_s=[s1, s2], test_miou=r["mIoU"],
                      test_s=ts, launches=probe.launches, test_launches=lt,
                      stencil_launches=stencil)
    res["stencil_launches"] = sum(stencil)
    log(f"train --preset veon_b --num-temporal 2 --temporal-start-epoch 1 fp32, {frames} frames: "
        + "; ".join(f"epoch {e} (F={d['frames']}) step ms {[round(t, 3) for t in d['step_ms']]} "
                    f"warm {d['warm_ms']:.3f}, peak above the phase's start "
                    f"{d['peak_bytes'] / 2**30:.3f} GiB"
                    for e, d in epochs.items())
        + f"; epoch 3 by --auto-resume from NEXT_EPOCH 2; #3 once per F=1 step, twice per F=2 "
        f"step; test --num-temporal 2 --ckpt mIoU {r['mIoU']:.4f} in {ts:.1f} s (#3 twice per "
        f"frame); deform_stencil {stencil} (train, --auto-resume, test); CLI s "
        f"{[round(s1, 1), round(s2, 1)]}")
    res["bf16"] = {}
    for F in (2, 4):
        start = phase_base()
        trainer, batch = train_entry(presets.veon_b(num_temporal=F, compute_dtype="bfloat16"))
        torch.cuda.synchronize()
        seen, remove = _fusion_memory(trainer.model)
        torch.cuda.reset_peak_memory_stats()
        kernels = reset_launches()
        stencil0 = deform_stencil_launches()
        times, losses = [], []
        for _ in range(3):
            t = time.perf_counter()
            lo = trainer(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append({k: float(v) for k, v in lo.items()})
        launches = {k: fn.launches for k, fn in kernels.items()}
        launches["deform_stencil"] = deform_stencil_launches() - stencil0
        peak = torch.cuda.max_memory_allocated() - start
        expect_launches(launches, {k: 3 * F if k == "bev_pool_sorted2" else
                                   6 if k == "deform_stencil" else 0 for k in launches},
                        f"train_entry bf16 F={F}")
        res["stencil_launches"] += 6
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
            f"the start (model included) {peak / 2**30:.3f} GiB, #3 "
            f"{launches['bev_pool_sorted2']} and deform_stencil {launches['deform_stencil']} in 3 "
            f"steps; the "
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


# every rank process this script started, killed at its exit if still running
_RANKS = []


def _start_ranks(argvs, work, timeout=300):
    """Start this script's `--dp-worker` processes, one per argv, all at
    once with their output in `work`: the handle `_wait_ranks` takes, whose
    timeout counts from now."""
    logs = [open(os.path.join(work, f"rank{i}.log"), "w+") for i in range(len(argvs))]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker",
                               *map(str, a)], stdout=f, stderr=subprocess.STDOUT)
             for a, f in zip(argvs, logs)]
    _RANKS.extend(procs)
    return procs, logs, time.time() + timeout


def _kill_ranks():
    for p in _RANKS:
        if p.poll() is None:
            p.kill()
        p.wait()


def _spawn_ranks(argvs, work, timeout=300):
    """`_start_ranks` and `_wait_ranks`."""
    return _wait_ranks(_start_ranks(argvs, work, timeout))


def _wait_ranks(handle):
    """Wait for the processes of `_start_ranks`, and kill every one that is
    left as soon as one fails or the timeout passes. Returns the outputs."""
    procs, logs, deadline = handle
    failed = None
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
        first = failed if failed is not None else bad[0]  # the one that failed, not one killed
        raise AssertionError(f"dp worker {first} exited {procs[first].returncode} (of failed "
                             f"{bad}):\n{outs[first][-3000:]}")
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
    CPU within phase 26's tolerance, #3 once per rank; its ranks run
    beside (c), whose times are informational. (c) `train --preset
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
        # (b): the card's ranks and the CPU's at once, beside (c): nothing of
        # (b) is timed
        port = {"cuda": _free_port()}
        while (p := _free_port()) == port["cuda"]:
            pass
        port["cpu"] = p
        work_b = os.path.join(work, "b")
        os.makedirs(work_b)
        ranks_b = _start_ranks([("step", r, port[device], device,
                                 os.path.join(work_b, f"{device}{r}.pt"))
                                for device in ("cuda", "cpu") for r in range(2)], work_b)
        pkl = train_shard(root, 4)
        tw = tempfile.mkdtemp(prefix="veon_dptrain", dir=root)
        while (port_c := _free_port()) in port.values():
            pass
        t = time.perf_counter()
        logs = _spawn_ranks([("cli", r, port_c, root, pkl, tw, os.path.join(work, f"cli{r}.pt"))
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
        _wait_ranks(ranks_b)
        ranks = {device: [torch.load(os.path.join(work_b, f"{device}{r}.pt")) for r in range(2)]
                 for device in ("cuda", "cpu")}
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


def _launched(kernels, fn, *args):
    """(fn(*args), the launches it made per kernel), synchronized."""
    before = {k: f.launches for k, f in kernels.items()}
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {k: f.launches - before[k] for k, f in kernels.items()}


def _artifact(path, seconds, what):
    """Load a `.pt2` program written by `export`: (program, the numbers of
    its export and load, its graph's device copies), logged on one line."""
    from veon_tpu_torch.utils.export import device_copies, load_program

    t = time.perf_counter()
    saved = load_program(path)
    program = saved.module()
    load_s = time.perf_counter() - t
    copies = {k: len(v) for k, v in device_copies(saved).items()}
    nodes = sum(1 for n in saved.graph.nodes if n.op == "call_function")
    checks = sum(1 for n in saved.graph.nodes if "_assert" in str(n.target))
    pooled = sum(n.target is torch.ops.veon.bev_pool_pooled.default for n in saved.graph.nodes)
    if pooled != 1 or copies["to_host"] or copies["scalar_reads"]:
        raise AssertionError(f"{what}: {pooled} kernel #1 nodes, device copies {copies}")
    res = {"export_s": seconds, "bytes": os.path.getsize(path), "load_s": load_s,
           "graph_nodes": nodes, "assert_nodes": checks, "device_copies": copies}
    log(f"{what}: export (the CLI call, model build included) {seconds:.3f} s, "
        f"{res['bytes']} bytes, load {load_s:.3f} s, {nodes} graph nodes ({checks} of them "
        f"run-time asserts), kernel #1 once, device copies {copies}")
    return program, res


def in_turns(live, program, args, iters, float_idx=(0, 1)):
    """ms per call of the live module and the loaded program on the same
    inputs, timed in turns (live, program, program, live), each turn one
    run of `iters` back-to-back perturbed calls and one synchronize
    (`utils/bench_model.py` protocol), then the host's time to enqueue one
    more call on an idle card (a call that returns long before the card
    finishes is device-bound; one whose enqueue takes its whole time,
    host-bound); ({"live"/"artifact": [2 turns], "enqueue_live"/
    "enqueue_artifact": [2]}, kernel #1 launches made)."""
    from veon_tpu_torch.utils.bench_model import perturbed, timed_runs

    calls = perturbed(args, iters, float_idx)
    kernels = reset_launches()
    ms = {"live": [], "artifact": [], "enqueue_live": [], "enqueue_artifact": []}
    with torch.no_grad():
        for name in ("live", "artifact", "artifact", "live"):
            fn = live if name == "live" else program
            per, _first = timed_runs(fn, calls, outer=1, warmup=1)
            ms[name].append(per * 1e3)
            t = time.perf_counter()
            fn(*calls[0])
            ms["enqueue_" + name].append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
    made = {k: fn.launches for k, fn in kernels.items()}
    expect_launches(made, {k: 4 * (iters + 2) * int(k == "bev_pool_pooled") for k in made},
                    "artifact and live in turns")
    return ms, made["bev_pool_pooled"]


def export_f1_phase(made):
    """38. `export --preset veon_b` (F=1, bf16) through the CLI (`made`, the
    call's (path, seconds, launches) from `_export_worker`), a main path:
    the `.pt2` program loaded back and run on the live `FrameServer`'s
    frame, rig metas and open-vocabulary matrix (the same seeded weights):
    the class grid equal to the live one, kernel #1 once per program call
    (3 calls), no other launch. The program's one output is the class grid,
    as JAX's artifact's; phase 39 compares raw outputs. Returns the server
    and frame for phases 40-41."""
    from veon_tpu_torch.entry import entry
    from veon_tpu_torch.utils.export import _serving_cfg

    phase_base()
    path, seconds, launches = made
    expect_launches(launches, {k: 0 for k in launches}, "export F=1")
    program, res = _artifact(path, seconds, "export F=1 veon_b bf16")
    server, (imgs, depth_imgs) = entry(_serving_cfg("veon_b", compute_dtype="bfloat16"),
                                       device="cuda", seed=0)
    kernels = reset_launches()
    live = server(imgs, depth_imgs)
    torch.cuda.synchronize()
    calls = []
    with torch.no_grad():
        for _ in range(3):
            grid, made = _launched(kernels, program, imgs, depth_imgs, server.metas,
                                   server.ov_weight)
            expect_launches(made, {k: int(k == "bev_pool_pooled") for k in made},
                            "F=1 artifact call")
            calls.append(made["bev_pool_pooled"])
            if not torch.equal(grid, live):
                raise AssertionError(f"F=1 artifact grid differs from the live one in "
                                     f"{int((grid != live).sum())} voxels")
    ms, timed = in_turns(server.forward, program,
                         (imgs, depth_imgs, server.metas, server.ov_weight), 10)
    ratio = statistics.mean(ms["artifact"]) / statistics.mean(ms["live"])
    res.update(grid_equal=True, launches_pooled=sum(calls) + timed,
               occupied=float((live != 17).float().mean()), in_turns_ms=ms, ratio=ratio)
    log(f"export F=1: artifact grid == live FrameServer grid over 3 calls, kernel #1 "
        f"{calls} per call, occupied share {res['occupied']:.4f}; in turns (10 calls a turn) "
        f"ms/frame {ms}, artifact / live {ratio:.4f}")
    del program
    return path, server, (imgs, depth_imgs, live), res


def _t2_compare(program, session, reqs, kernels, frames, what):
    """Drive calls through a live session and a streaming program side by
    side, the program's cache rolled by hand: every output equal (the pred
    bit for bit, raw outputs' max abs difference logged and held within
    1e-5 of each output's largest value), kernel #1 once per program call."""
    rig = {k: session.rig_metas[k] for k in ("sensor2egos", "ego2globals", "intrins",
                                             "post_rots", "post_trans", "bda")}
    pv, pl = session.state()
    te = session._zero_embed
    diffs, calls = {}, []
    for r, (imgs, depth_imgs) in zip(reqs, frames):
        l2g = r["lidarego2global"]
        live = session.infer(imgs, depth_imgs, {"lidarego2global": l2g})
        m = dict(rig, lidarego2global=l2g, lift_sorted=session.rig_metas["lift_sorted"])
        with torch.no_grad():
            out, made = _launched(kernels, program, imgs, depth_imgs, m, session.ov_weight,
                                  pv, pl, te)
        expect_launches(made, {k: int(k == "bev_pool_pooled") for k in made}, what)
        calls.append(made["bev_pool_pooled"])
        early = out.pop("early_vox")
        pv = torch.cat([early[:, None].to(pv.dtype), pv[:, :-1]], 1)
        pl = torch.cat([l2g[:, None].float(), pl[:, :-1]], 1)
        if set(out) != set(live) or not torch.equal(out["pred"], live["pred"]):
            raise AssertionError(f"{what}: pred or keys differ")
        for k in live:
            d = (out[k].float() - live[k].float()).abs().max().item()
            diffs[k] = max(diffs.get(k, 0.0), d)
            if d > 1e-5 * max(live[k].float().abs().max().item(), 1.0):
                raise AssertionError(f"{what}: {k} off by {d}")
        del live, out
    for got, want in zip((pv, pl), session.state()):
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: the rolled cache differs from the session's")
    log(f"{what}: {len(calls)} drive calls equal to the live session (pred bit-equal, raw "
        f"outputs' max abs difference {diffs}), kernel #1 {calls} per call")
    return {"max_abs_diff": diffs, "launches_pooled": sum(calls)}


def export_t2_phase(made, calls=4):
    """39. `export --preset veon_b --num-temporal 2` in the preset's dtype
    (fp32) and with `--raw-uint8`, through the CLI (`made`: {raw: the
    call's (path, seconds, launches)} from `_export_worker`), a main path: each
    program loaded back and driven by `calls` calls of `example_drive`
    beside a live `TemporalSession` on the same seeded weights (the float
    program on the drive's frames, the uint8 one on uint8 frames from
    numpy's default_rng(5), the session normalizing them on the card).
    Returns the float program's path for phase 40."""
    from veon_tpu_torch.entry import temporal_entry
    from veon_tpu_torch.serve.streaming import TemporalSession
    from veon_tpu_torch.utils.export import _serving_cfg

    phase_base()
    res = {}
    session, reqs = temporal_entry(_serving_cfg("veon_b", num_temporal=2), device="cuda", seed=0,
                                   frames=calls)
    kernels = reset_launches()
    path = None
    for raw in (False, True):
        p, seconds, launches = made[raw]
        expect_launches(launches, {k: 0 for k in launches}, "export T=2")
        what = f"export T=2 veon_b fp32{' raw-uint8' if raw else ''}"
        program, r = _artifact(p, seconds, what)
        if raw:
            rng = np.random.default_rng(5)
            frames = [tuple(torch.from_numpy(rng.integers(0, 256, size=tuple(x.shape),
                                                          dtype=np.uint8)).cuda()
                            for x in (q["imgs"], q["depth_imgs"])) for q in reqs]
            live = TemporalSession(session.model, session.ov_weight, session.membership,
                                   rig_metas=session.rig_metas,
                                   normalize=("clipsan", session.model.cfg.data.depth_norm_method))
        else:
            frames = [(q["imgs"], q["depth_imgs"]) for q in reqs]
            session.reset()
            live, path = session, p
        r.update(_t2_compare(program, live, reqs, kernels, frames, what))
        if not raw:
            m = dict({k: v for k, v in live.rig_metas.items() if k != "lift_sorted"},
                     lidarego2global=reqs[0]["lidarego2global"],
                     lift_sorted=live.rig_metas["lift_sorted"])
            pv, pl = live.state()
            ms, timed = in_turns(live.step, program, (*frames[0], m, live.ov_weight, pv, pl,
                                                      live._zero_embed), 3)
            r.update(in_turns_ms=ms, ratio=statistics.mean(ms["artifact"])
                     / statistics.mean(ms["live"]))
            r["launches_pooled"] += timed
            log(f"{what}: in turns (3 calls a turn) ms/call {ms}, artifact / live "
                f"{r['ratio']:.4f}")
        res["raw_uint8" if raw else "float"] = r
        del program
        if raw:
            os.remove(p)  # phase 40 times the float program only
        gc.collect()
        torch.cuda.empty_cache()
    return path, res


def benchmark_phase(f1_path, t2_path):
    """40. `benchmark` through the CLI, a main path: the live F=1 graph bf16,
    the streaming step `--num-temporal 2` bf16, then `--artifact` on the F=1
    (bf16) and T=2 (fp32) programs; each JSON line, kernel #1's launches
    per run (2 warm-up + 3 runs of 10 calls), and the F=1 artifact-to-live
    ms ratio (phases 38-39 time both programs in turns with the live
    modules as well)."""
    phase_base()
    runs = {}
    argvs = {"live_f1_bf16": ["benchmark", "--preset", "veon_b"],
             "live_t2_bf16": ["benchmark", "--preset", "veon_b", "--num-temporal", "2"],
             "artifact_f1_bf16": ["benchmark", "--artifact", f1_path],
             "artifact_t2_fp32": ["benchmark", "--artifact", t2_path]}
    for name, argv in argvs.items():
        line, _out, seconds, launches = run_cli(argv)
        expect_launches(launches, {k: 32 * int(k == "bev_pool_pooled") for k in launches},
                        f"benchmark {name}")
        if not (math.isfinite(line["value"]) and line["value"] > 0):
            raise AssertionError(f"benchmark {name}: {line}")
        runs[name] = dict(line=line, seconds=seconds, launches_pooled=launches["bev_pool_pooled"])
        log(f"benchmark {name} ({seconds:.1f} s): {json.dumps(line)}")
    ms = {k: v["line"]["detail"]["ms_per_frame"] for k, v in runs.items()}
    ratio = ms["artifact_f1_bf16"] / ms["live_f1_bf16"]
    log(f"benchmark F=1 bf16 artifact / live ms: {ratio:.4f}")
    return {"runs": runs, "ratio_f1_bf16": ratio,
            "launches_pooled": sum(v["launches_pooled"] for v in runs.values())}


# --------------------------------------------------------------------------
# phase 42: camera sharding, ranks of this script sharing the card over gloo


class _SGD:
    """Plain SGD in the optimizer interface of the stage-2 step (the JAX
    camera-sharding test's optax.sgd): a parameter's delta is -lr times its
    gradient, so a wrong cross-camera combine shows as a 2x delta."""

    lr = 0.1

    def init(self, params):
        from veon_tpu_torch.train.step import AdamState

        return AdamState(0, {}, {})

    @torch.no_grad()
    def update(self, grads, state, params):
        from veon_tpu_torch.train.step import AdamState

        for n, p in params.items():
            p.add_(grads[n], alpha=-self.lr)
        return AdamState(state.count + 1, {}, {})


def _sgd_step(model, cfg, batch, membership, cam_group=None):
    """(losses, parameter deltas) of one SGD step of the stage-2 step."""
    from veon_tpu_torch.train import step as tstep

    tx = _SGD()
    state = tstep.create_train_state(model, tx)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, losses = tstep.make_train_step(model, tx, cfg, membership, cam_group=cam_group)(state,
                                                                                       batch)
    return ({k: float(v) for k, v in losses.items()},
            {n: (p.detach() - before[n]).cpu() for n, p in model.named_parameters()})


def _cs_sum_timer(times):
    """`collectives.cam_sum` that appends its host-clock ms (the card
    synchronized on both sides) and the grid's dtype to `times`: the lift's
    all-reduce share."""
    from veon_tpu_torch import collectives

    def cam_sum(x, cg):
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = collectives.cam_sum(x, cg)
        torch.cuda.synchronize()
        times.append(((time.perf_counter() - t) * 1e3, str(x.dtype).replace("torch.", "")))
        return y

    return cam_sum


def _cs_tiny_worker(rank, port, out):
    """Phase 42(a) and the 2 x 2 step, rank `rank` of 4 sharing the card:
    weights seeded on the CPU (one init on every rank and on the CPU).
    (1) One SGD step of the tiny preset in fp32 on a (batch x cam) = 2 x 2
    grid, each batch row one row of a B=2 batch, against the unsharded step
    on the whole batch on the card, taken by rank 0 before the group opens
    (BatchNorm and the step average over any open group): losses at 2e-4,
    deltas at rtol 5e-3 / atol 1e-5 (the JAX test's), #3 once per rank.
    (2) On the groups of the first 2 and 3 ranks: the stacked presort on the
    card integer-equal to the CPU's; the presorted sharded forward against
    the unsharded forward on the CPU (plain versions) at 2e-4, #2 once per
    rank and nothing else; kernel #2 against its plain version on the
    rank's own stream."""
    import torch.distributed as dist

    from veon_tpu_torch.cli.shapes import example_batch
    from veon_tpu_torch.collectives import CamGroup, cam_groups
    from veon_tpu_torch.entry import _ov_weight, _with_presort, build_model
    from veon_tpu_torch.lift.lss import two_hot_depth
    from veon_tpu_torch.ops import bev_pool as bp
    from veon_tpu_torch.model.camshard import prepare_camshard_metas
    from veon_tpu_torch.serve.camshard import make_camera_sharded_forward
    from veon_tpu_torch.train import distributed as D

    rank, dev = int(rank), torch.device("cuda")
    cfg = tiny_train_cfg()
    cpu_model = build_model(cfg, torch.device("cpu"), 0, None)
    sd = cpu_model.state_dict()

    def card_model():
        m = build_model(cfg, dev, 0, None)
        m.load_state_dict(sd)
        return m

    imgs, _d, metas = example_batch(cfg, B=2, device=dev)
    nx, ny, nz = cfg.grid.size
    rng = np.random.default_rng(7)
    ovw, membership = _ov_weight(cfg, dev)
    batch = dict(imgs=imgs, depth=far_depth(cfg, B=2).to(dev), metas=metas,
                 voxel_semantics=torch.from_numpy(rng.integers(0, 18, (2, nx, ny, nz)).astype(
                     np.int32)).to(dev),
                 mask_camera=torch.ones(2, nx, ny, nz, dtype=torch.int32, device=dev),
                 ov_weight=ovw, epoch=0)
    res = {}
    if rank == 0:
        res["step_ref"] = _sgd_step(card_model(), cfg, batch, membership)
    D.init_group(f"localhost:{port}", 4, rank, device="cuda", backend="gloo")
    cg = cam_groups(2, 2)
    row = cg.batch_index
    mine = {k: v[row:row + 1] for k, v in batch.items() if torch.is_tensor(v) and v.shape[0] == 2
            and k != "ov_weight"}
    mine.update(ov_weight=ovw, epoch=0, metas=prepare_camshard_metas(
        cfg, {k: v[row:row + 1] for k, v in metas.items()}, 2))
    kernels = reset_launches()
    res["step"] = _sgd_step(card_model().set_cam_group(cg), cfg, mine, membership, cg)
    res["step_launches"] = {k: fn.launches for k, fn in kernels.items()}

    groups = {S: dist.new_group(list(range(S))) for S in (2, 3)}
    imgs1, depth1, metas1 = example_batch(cfg, device=dev)
    cpu_in = example_batch(cfg, device="cpu")
    with torch.no_grad():
        want = cpu_model(cpu_in[0], cpu_in[1], _with_presort(cpu_model, cpu_in[2]), ovw.cpu())
    for S in (2, 3):
        if rank >= S:
            continue
        pre = prepare_camshard_metas(cfg, metas1, S, presort=True)
        pre_cpu = prepare_camshard_metas(cfg, cpu_in[2], S, presort=True)
        for k in ("order", "rk_sorted", "ranks"):
            if not torch.equal(pre["lift_sorted"][k].cpu(), pre_cpu["lift_sorted"][k]):
                raise AssertionError(f"S={S} stacked presort {k} differs card vs CPU")
        fwd = make_camera_sharded_forward(card_model(), CamGroup(groups[S], S, rank), "forward")
        kernels = reset_launches()
        with torch.no_grad():
            got = fwd(imgs1, depth1, pre, ovw)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()}
        expect_launches(launches, {k: int(k == "bev_pool_sorted") for k in launches},
                        f"tiny S={S} sharded forward rank {rank}")
        err = {}
        for k, w in want.items():
            torch.testing.assert_close(got[k].cpu(), w, rtol=2e-4, atol=2e-4, msg=k)
            err[k] = float((got[k].cpu() - w).abs().max())
        # kernel #2 against its plain version on this rank's stream
        ls = pre["lift_sorted"]
        B, N, D_, h, w = ls["ranks"].shape
        r = np.random.default_rng(rank)
        feat = torch.from_numpy(r.standard_normal((B, N // S, h, w, 32)).astype(np.float32)).to(dev)
        dist_w = two_hot_depth(torch.from_numpy(r.uniform(1.0, 44.0, (B, N // S, h, w)).astype(
            np.float32)), cfg.grid).to(dev)
        vals = bp.presorted_vals(dist_w, feat, ls["order"][rank]).contiguous()
        num_cells = int(np.prod(cfg.grid.size))
        k2 = bp.bev_pool_sorted(vals, ls["rk_sorted"][rank], num_cells)
        plain = bp.bev_pool_sorted_plain([(vals, ls["rk_sorted"][rank])], num_cells, torch.float32)
        check_kernel(k2, plain, plain, torch.float32, f"#2 on rank {rank}'s S={S} stream")
        res[f"forward{S}"] = dict(max_abs_err=err, launches=launches,
                                  kernel2_max_abs_err=float((k2 - plain).abs().max()),
                                  stream_rows=int(ls["order"].shape[1]))
    D.shutdown()
    torch.save(res, out)


def _cs_frames(cfg, n):
    """`n` distinct full frames of the example rig (the example images
    scaled frame by frame), the same on every rank."""
    from veon_tpu_torch.cli.shapes import example_batch_full

    imgs, depth_imgs, _ = example_batch_full(cfg, device="cuda")
    return [(imgs * (1.0 + 0.25 * i), depth_imgs * (1.0 - 0.1 * i)) for i in range(n)]


def _cs_serve_worker(rank, port, sock, out):
    """Phase 42(b), rank `rank` of 3 sharing the card: `serve_entry` at
    VEON-B width in bf16 (seeded weights) with `cam_group` over the 3
    ranks, rank 0's handler on a `TensorServer` answering 3 frames from a
    `TensorClient`, ranks 1-2 in `follow()`; launches read around exactly
    those frames (#2 once per frame per rank, nothing else); the lift's
    all-reduce timed (`_cs_sum_timer`); each rank's peak memory.

    Rank 0 holds each frame against `entry`'s FrameServer on the same
    weights and open-vocabulary matrix, class grids off the reference's
    near-ties (margin 1e-3). In fp32, frame 0 through a fp32
    `serve_entry(cam_group=)` on the same ranks against the unsharded fp32
    frame: class grid >= 0.999, feat_occ and sem_occ_raw within 1e-3. In
    bf16 a GEMM's rounding depends on how many cameras it batches (cuBLAS
    picks its kernels by shape), so the unsharded frame is not the bar:
    each bf16 frame is held at >= 0.999 against the same weights run shard
    by shard in rank 0's one process (`_cs_blockwise`: each 2-camera block
    alone, the grids summed in bf16), with frame 0's feat_occ and
    sem_occ_raw within 1e-2 of their largest value: that leaves the
    group's bf16 all-reduce and the ranks as the difference. The
    agreement with the unsharded frame, and with the floor (the unsharded
    model with only its depth tower run on 2 cameras at a time), is
    reported. Rank 0 then times kernel #2 on its stream against the plain
    version and index_add_."""
    from veon_tpu_torch.collectives import cam_groups
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import entry, serve_entry
    from veon_tpu_torch.lift import lss
    from veon_tpu_torch.model.veon import fused_classes
    from veon_tpu_torch.ops import bev_pool as bp
    from veon_tpu_torch.serve.client import TensorClient
    from veon_tpu_torch.serve.server import TensorServer
    from veon_tpu_torch.train import distributed as D

    rank, S = int(rank), 3
    D.init_group(f"localhost:{port}", S, rank, device="cuda", backend="gloo")
    cg = cam_groups(1, S)
    cfg = presets.veon_b(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    handler, required, _expect, exclusive = serve_entry(cfg, device="cuda", seed=0, cam_group=cg)
    torch.cuda.synchronize()
    res = dict(setup_s=time.perf_counter() - t0)
    server, membership = handler.server, handler.server.membership
    frames = _cs_frames(cfg, 3)

    def unsharded(c, ovw, shards=0):
        """Rank 0's unsharded FrameServer of config c: per frame, its class
        grid, near-ties and voxel outputs (frame 0's); with `shards`, per
        frame, the class grid of the floor (its depth tower on each shard's
        cameras at a time) and the blockwise outputs (`_cs_blockwise`)."""
        ref_server, _ = entry(c, device="cuda", seed=0)
        ref_server.ov_weight = ovw
        rm, refs = ref_server.model, []
        with torch.no_grad():
            for im, d in frames[:3 if shards else 1]:
                o = ref_server.outputs(im, d)
                r = dict(pred=fused_classes(o, membership).cpu(),
                         tie=near_ties(o, membership).cpu(),
                         out={k: o[k] for k in ("feat_occ", "sem_occ_raw")} if not refs else None)
                if shards:
                    n = d.shape[2] // shards
                    dch = torch.cat([rm.estimate_depth(d[:, :, j:j + n])
                                     for j in range(0, d.shape[2], n)], 2)
                    r["floor"] = fused_classes(rm(im, dch, ref_server.metas, ovw),
                                               membership).cpu()
                    b = _cs_blockwise(rm, shards, im, d, server.metas, ovw)
                    r["block"] = dict(pred=fused_classes(b, membership).cpu(),
                                      tie=near_ties(b, membership).cpu(),
                                      out={k: b[k] for k in ("feat_occ", "sem_occ_raw")}
                                      if not refs else None)
                refs.append(r)
                del o
        del ref_server, rm
        gc.collect()
        torch.cuda.empty_cache()
        return refs

    def compare(pred, got_out, r):
        return dict(agreement_off_ties=float((pred.int() == r["pred"])[~r["tie"]].float().mean()),
                    near_tie_share=float(r["tie"].float().mean()),
                    max_abs_diff={k: float((got_out[k] - v).abs().max())
                                  for k, v in r["out"].items()} if got_out else None,
                    max_abs_ref={k: float(v.abs().max()) for k, v in r["out"].items()}
                    if got_out else None)

    ref = unsharded(cfg, server.ov_weight, shards=S) if rank == 0 else None
    sums = []
    lss.cam_sum = _cs_sum_timer(sums)
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    if rank == 0:
        srv = TensorServer(handler, sock, required=required, exclusive=exclusive)
        srv.start()
        rts, sms, preds = [], [], []
        try:
            with TensorClient(sock) as c:
                for im, d in frames:
                    t = time.perf_counter()
                    resp = c.infer(imgs=im.cpu().numpy(), depth_imgs=d.cpu().numpy())
                    rts.append((time.perf_counter() - t) * 1e3)
                    sms.append(float(np.asarray(resp["server_ms"]).reshape(-1)[0]))
                    preds.append(torch.from_numpy(np.asarray(resp["pred"])))
        finally:
            srv.stop()
            handler.close()
        res.update(round_trip_ms=rts, server_ms=sms)
    else:
        handler.follow()
    torch.cuda.synchronize()
    res["launches"] = {k: fn.launches for k, fn in kernels.items()}
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["allreduce_ms"] = list(sums)
    expect_launches(res["launches"], {k: 3 * int(k == "bev_pool_sorted") for k in res["launches"]},
                    f"serve --cam-shards 3 rank {rank}")
    with torch.no_grad():
        got0 = server.outputs(*frames[0])
    del handler, server
    gc.collect()
    torch.cuda.empty_cache()
    # frame 0 in fp32 on the same ranks
    cfg32 = presets.veon_b()
    h32, *_ = serve_entry(cfg32, device="cuda", seed=0, cam_group=cg)
    with torch.no_grad():
        got32 = h32.server.outputs(*frames[0])
    ovw32 = h32.server.ov_weight
    del h32
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        bf16 = [dict(blockwise=compare(p, got0 if i == 0 else None, r["block"]),
                     unsharded=compare(p, got0 if i == 0 else None, r),
                     floor_agreement_off_ties=float((p.int() == r["floor"])[~r["tie"]]
                                                    .float().mean()))
                for i, (p, r) in enumerate(zip(preds, ref))]
        ref32 = unsharded(cfg32, ovw32)[0]
        fp32 = compare(fused_classes(got32, membership).cpu(), got32, ref32)
        res.update(bf16=bf16, fp32=fp32)
        log(f"serve --cam-shards 3: bf16 {bf16}, fp32 {fp32}")
        low = [f["blockwise"]["agreement_off_ties"] for f in bf16
               if f["blockwise"]["agreement_off_ties"] < 0.999]
        if low:
            raise AssertionError(f"sharded bf16 class grid agrees with the blockwise one on {low} "
                                 "off near-ties (< 0.999)")
        b0 = bf16[0]["blockwise"]
        far = {k: v for k, v in b0["max_abs_diff"].items() if not v <= 1e-2 * b0["max_abs_ref"][k]}
        if far:
            raise AssertionError(f"sharded bf16 frame 0 differs from the blockwise one by {far} "
                                 "(> 1e-2 of its largest value)")
        if fp32["agreement_off_ties"] < 0.999:
            raise AssertionError(f"sharded fp32 class grid agrees on "
                                 f"{fp32['agreement_off_ties']} off near-ties (< 0.999)")
        far = {k: v for k, v in fp32["max_abs_diff"].items() if not v <= 1e-3}
        if far:
            raise AssertionError(f"sharded fp32 frame differs from the unsharded by {far} (> 1e-3)")
        # kernel #2 on this rank's stream: time, plain, library, bound
        ls = _cs_stacked_presort(cfg, S)
        order, rk = ls["order"][0], ls["rk_sorted"][0]
        B, N, D_, h, w = ls["ranks"].shape
        r = np.random.default_rng(5)
        feat = torch.from_numpy(r.standard_normal((B, N // S, h, w, cfg.propagation.dim)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        dist_w = lss.two_hot_depth(torch.from_numpy(r.uniform(1.0, 44.0, (B, N // S, h, w)).astype(
            np.float32)), cfg.grid).to("cuda", torch.bfloat16)
        vals = bp.presorted_vals(dist_w, feat, order).contiguous()
        num_cells = int(np.prod(cfg.grid.size))
        got = bp.bev_pool_sorted(vals, rk, num_cells)
        plain = bp.bev_pool_sorted_plain([(vals, rk)], num_cells, torch.bfloat16)
        check_kernel(got, plain, bp.bev_pool_sorted_plain([(vals, rk)], num_cells, torch.float32),
                     torch.bfloat16, "#2 on rank 0's serving stream")
        res["kernel2"] = dict(_time_case(
            "bev_pool_sorted shard bf16", lambda: bp.bev_pool_sorted(vals, rk, num_cells),
            lambda: bp.bev_pool_sorted_plain([(vals, rk)], num_cells, torch.bfloat16),
            [(vals, rk)], num_cells, cfg.propagation.dim, 2),
            max_abs_err=float((got.float() - plain.float()).abs().max()))
    D.shutdown()
    torch.save(res, out)


def _cs_blockwise(model, num_shards, imgs, depth_imgs, metas, ovw):
    """The camera-sharded forward of `model` in this one process, with no
    group: each shard's block of cameras (`local_inputs` of the stacked
    presort `metas`) run on its own up to the lift's cross-camera sum, the
    blocks' full-resolution grids summed in their dtype in shard order,
    and the rest run once on that sum. Returns the voxel outputs."""
    from veon_tpu_torch.collectives import CamGroup
    from veon_tpu_torch.lift import lss
    from veon_tpu_torch.model.camshard import local_inputs

    grids, cam_sum = [], lss.cam_sum
    try:
        lss.cam_sum = lambda x, cg: grids.append(x) or x
        for i in range(num_shards):
            model.set_cam_group(CamGroup(None, num_shards, i))
            model.full_forward(*local_inputs(imgs, depth_imgs, metas, model.cam_group), ovw)
        total = grids[0]
        for g in grids[1:]:
            total = total + g
        lss.cam_sum = lambda x, cg: total
        return model.full_forward(*local_inputs(imgs, depth_imgs, metas, model.cam_group), ovw)
    finally:
        lss.cam_sum = cam_sum
        model.set_cam_group(None)


def _cs_stacked_presort(cfg, num_shards):
    """The stacked per-shard presort of the example rig on the card."""
    from veon_tpu_torch.cli.shapes import example_batch
    from veon_tpu_torch.model.camshard import prepare_camshard_metas

    return prepare_camshard_metas(cfg, example_batch(cfg, device="cuda")[2], num_shards,
                                  presort=True)["lift_sorted"]


def _cs_main2_worker(rank, port, out):
    """Phases 42(c) and (d), rank `rank` of 2 sharing the card, VEON-B in
    bf16 with seeded weights. (d)'s reference first: rank 0 takes 2
    unsharded steps of `train_entry` before the group opens. (c) A T=2
    `TemporalSession` with `cam_group` over both ranks on the stacked
    presort of the drive's rig, 4 drive calls (#2 once per call per rank,
    nothing else), against `temporal_entry`'s unsharded session on rank 0
    (class grid off near-ties, max abs difference of feat_occ). (d) 2
    sharded steps (the batch's keyegos pinned, #3 once per step per rank),
    the losses against the unsharded ones within rtol 1e-3."""
    from veon_tpu_torch.cli.shapes import example_drive
    from veon_tpu_torch.collectives import cam_groups
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import (_ov_weight, build_model, temporal_entry, train_batch,
                                      train_entry)
    from veon_tpu_torch.lift import lss
    from veon_tpu_torch.model.camshard import prepare_camshard_metas
    from veon_tpu_torch.serve.streaming import TemporalSession
    from veon_tpu_torch.train import distributed as D
    from veon_tpu_torch.train import step as tstep

    rank, dev = int(rank), torch.device("cuda")
    cfg = presets.veon_b(compute_dtype="bfloat16")
    res = {}
    if rank == 0:
        trainer, batch = train_entry(cfg, device="cuda", seed=0)
        res["train_ref"] = [{k: float(v) for k, v in trainer(batch).items()} for _ in range(2)]
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
    D.init_group(f"localhost:{port}", 2, rank, device="cuda", backend="gloo")
    cg = cam_groups(1, 2)

    cfg_t = presets.veon_b(num_temporal=2, compute_dtype="bfloat16")
    rig, reqs = example_drive(cfg_t, 4, device=dev, seed=0)
    ovw, membership = _ov_weight(cfg_t, dev)
    sess = TemporalSession(build_model(cfg_t, dev, 0, None), ovw, membership,
                           rig_metas=prepare_camshard_metas(cfg_t, rig, 2, presort=True),
                           cam_group=cg)
    sums = []
    lss.cam_sum = _cs_sum_timer(sums)
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    times, outs = [], []
    for r in reqs:
        t = time.perf_counter()
        o = sess.infer(r["imgs"], r["depth_imgs"], {"lidarego2global": r["lidarego2global"]})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        outs.append(dict(pred=o["pred"].cpu(), feat_occ=o["feat_occ"] if rank == 0 else None))
    launches = {k: fn.launches for k, fn in kernels.items()}
    expect_launches(launches, {k: 4 * int(k == "bev_pool_sorted") for k in launches},
                    f"streaming --cam-shards 2 rank {rank}")
    res["streaming"] = dict(call_ms=times, launches=launches, allreduce_ms=list(sums),
                            peak_bytes=torch.cuda.max_memory_allocated())
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        ref, ref_reqs = temporal_entry(cfg_t, device="cuda", seed=0, frames=4)
        agree, diff = [], []
        with torch.no_grad():
            for r, got in zip(ref_reqs, outs):
                o = ref.infer(r["imgs"], r["depth_imgs"], {"lidarego2global": r["lidarego2global"]})
                off = ~near_ties(o, membership).cpu()
                agree.append(float((got["pred"] == o["pred"].cpu())[off].float().mean()))
                diff.append(float((got["feat_occ"] - o["feat_occ"]).abs().max()))
        res["streaming"].update(agreement_off_ties=agree, feat_occ_max_abs_diff=diff)
        del ref, outs
        gc.collect()
        torch.cuda.empty_cache()
        if min(agree) < 0.999:
            raise AssertionError(f"sharded streaming grid agrees on {agree} off near-ties")

    model = build_model(cfg, dev, 0, None).set_cam_group(cg)
    _p, refl_membership = _ov_weight(cfg, dev)
    tx = tstep.AdamW()
    state = tstep.create_train_state(model, tx)
    step = tstep.make_train_step(model, tx, cfg, refl_membership, cam_group=cg)
    batch = train_batch(cfg, device=dev)
    batch["metas"] = prepare_camshard_metas(cfg, batch["metas"], 2)
    sums.clear()
    torch.cuda.reset_peak_memory_stats()
    kernels = reset_launches()
    times, losses = [], []
    for _ in range(2):
        t = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append({k: float(v) for k, v in loss.items()})
    launches = {k: fn.launches for k, fn in kernels.items()}
    expect_launches(launches, {k: 2 * int(k == "bev_pool_sorted2") for k in launches},
                    f"train --cam-shards 2 rank {rank}")
    res["train"] = dict(step_ms=times, losses=losses, launches=launches, allreduce_ms=list(sums),
                        peak_bytes=torch.cuda.max_memory_allocated())
    if rank == 0:
        for got, want in zip(losses, res["train_ref"]):
            for k, w in want.items():
                if not abs(got[k] - w) <= 1e-3 * abs(w) + 1e-5:
                    raise AssertionError(f"sharded step loss {k} {got[k]} vs unsharded {w}")
    D.shutdown()
    torch.save(res, out)


def _cs_kernel3_on_shard(cfg, metas, lss):
    """Kernel #3 on rank 0's streams of a sharded train step (its 3
    cameras' K-band and far-depth spray on `far_depth`, the whole rig's
    keyegos) in bf16: against its plain version, then timed with the plain
    version and index_add_ against its bound (`_time_case`)."""
    from veon_tpu_torch.ops import bev_pool as bp

    nl = cfg.data.num_cams // 2
    m = {k: metas[k][:, 0, :nl] for k in ("sensor2keyegos", "intrins", "post_rots", "post_trans")}
    args = (m["sensor2keyegos"], m["intrins"], m["post_rots"], m["post_trans"], metas["bda"])
    metric = lss.min_pool_depth(far_depth(cfg)[:, 0, :nl].cuda(), 8)
    lift = lss.LSSLift.from_config(cfg)
    w1, r1, w2, r2 = lift.banded_streams(metric, *args)
    if w2 is None:
        raise AssertionError("no far-depth spray stream at this grid's depth bins")
    h, w = metric.shape[-2:]
    C = cfg.propagation.dim
    feat = torch.from_numpy(np.random.default_rng(6).standard_normal((nl * h * w, C)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    pairs = [(vals, rk) for rk, vals in (bp.sorted_stream(wt.to(torch.bfloat16), feat, r)
                                         for wt, r in ((w1, r1), (w2, r2)))]
    flat = [t for pair in pairs for t in pair]
    num_cells = int(np.prod(cfg.grid.size))
    got = bp.bev_pool_sorted2(*flat, num_cells)
    plain = bp.bev_pool_sorted_plain(pairs, num_cells, torch.bfloat16)
    check_kernel(got, plain, bp.bev_pool_sorted_plain(pairs, num_cells, torch.float32),
                 torch.bfloat16, "#3 on a shard's streams")
    res = _time_case("bev_pool_sorted2 shard bf16", lambda: bp.bev_pool_sorted2(*flat, num_cells),
                     lambda: bp.bev_pool_sorted_plain(pairs, num_cells, torch.bfloat16), pairs,
                     num_cells, C, 2)
    return dict(res, max_abs_err=float((got.float() - plain.float()).abs().max()))


def _cs_argvs(work, group, sock=None):
    """The `--dp-worker` argvs of phase 42's (name, kind, world) groups,
    each on a free port of its own: {name: [argv per rank]}."""
    argvs, ports = {}, set()
    for name, kind, world in group:
        while (port := _free_port()) in ports:
            pass
        ports.add(port)
        argvs[name] = [(kind, r, port) + ((sock,) if name == "serve" else ())
                       + (os.path.join(work, f"{name}{r}.pt"),) for r in range(world)]
    return argvs


def camshard_start():
    """Start phase 42's untimed ranks in the background: (a) and the 2 x 2
    step (`_cs_tiny_worker`, 4 ranks) beside (c) and (d)
    (`_cs_main2_worker`, 2 ranks), whose times are contended and held to
    nothing. `camshard_wait` waits for them."""
    work = tempfile.mkdtemp(prefix="veon_cs_bg")
    argvs = _cs_argvs(work, (("tiny", "cs_tiny", 4), ("main2", "cs_main2", 2)))
    return dict(work=work, argvs=argvs, t=time.perf_counter(),
                ranks=_start_ranks([a for v in argvs.values() for a in v], work, timeout=420))


def camshard_wait(bg):
    """The results of `camshard_start`'s ranks, once all have ended:
    {"tiny": [per rank], "main2": [per rank], "seconds": since the start}."""
    try:
        _wait_ranks(bg["ranks"])
        res = {name: [torch.load(a[-1], weights_only=False) for a in v]
               for name, v in bg["argvs"].items()}
    finally:
        shutil.rmtree(bg["work"], ignore_errors=True)
    res["seconds"] = round(time.perf_counter() - bg["t"], 1)
    return res


def camshard_phase(bg):
    """Phase 42, camera sharding (`serve/camshard.py`): ranks of this script
    (`--dp-worker cs_*`) sharing the card over gloo (NCCL takes one rank
    per card; gloo sums through the host): (b) (`_cs_serve_worker`, 3
    ranks) alone, since its frames are timed; then the results of (a),
    (c) and (d) (`bg`, from `camshard_wait`) and #3 timed on a rank's
    streams of the sharded step. Returns their results, with the launches
    of #2 and #3 on the main paths (b)-(d) summed over the ranks."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import train_batch
    from veon_tpu_torch.lift import lss
    from veon_tpu_torch.model.camshard import prepare_camshard_metas

    work = tempfile.mkdtemp(prefix="veon_cs")
    res = {k: bg[k] for k in ("tiny", "main2")}
    secs = {"tiny+main2 (beside phase 33)": bg["seconds"]}
    try:
        t = time.perf_counter()
        sock = os.path.join(socket_dir(), "s.sock")
        argvs = _cs_argvs(work, (("serve", "cs_serve", 3),), sock)
        try:
            _spawn_ranks(argvs["serve"], work, timeout=420)
        finally:
            shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
        res["serve"] = [torch.load(a[-1], weights_only=False) for a in argvs["serve"]]
        secs["serve"] = round(time.perf_counter() - t, 1)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cfg = presets.veon_b(compute_dtype="bfloat16")
    kernel3 = _cs_kernel3_on_shard(cfg, prepare_camshard_metas(
        cfg, train_batch(cfg, device="cuda")["metas"], 2), lss)
    tiny, serve, main2 = res["tiny"], res["serve"], res["main2"]
    # the 2 x 2 step against the unsharded one on the card
    want_losses, want_deltas = tiny[0]["step_ref"]
    for r, t in enumerate(tiny):
        losses, deltas = t["step"]
        expect_launches(t["step_launches"], {k: int(k == "bev_pool_sorted2")
                                             for k in t["step_launches"]}, f"2x2 step rank {r}")
        for k, w in want_losses.items():
            if not abs(losses[k] - w) <= 2e-4 * abs(w) + 1e-6:
                raise AssertionError(f"2x2 step rank {r} loss {k} {losses[k]} vs {w}")
        for n, w in want_deltas.items():
            torch.testing.assert_close(deltas[n], w, rtol=5e-3, atol=1e-5, msg=f"2x2 delta {n}")
    moved = max(float(d.abs().max()) for d in want_deltas.values())
    if moved <= 1e-6:
        raise AssertionError("the 2x2 step moved no parameter")
    dtypes = {d for x in serve + [m["train"] for m in main2] for _ms, d in x["allreduce_ms"]}
    out = dict(seconds=secs, allreduce_dtypes=sorted(dtypes), two_by_two=dict(
        losses=tiny[0]["step"][0], max_abs_delta_diff=max(
            float((t["step"][1][n] - w).abs().max()) for t in tiny for n, w in want_deltas.items()),
        max_abs_delta=moved),
        tiny_forward={f"rank{r}": {k: v for k, v in t.items() if k.startswith("forward")}
                      for r, t in enumerate(tiny)},
        serve=serve, streaming=[m["streaming"] for m in main2],
        train=[m["train"] for m in main2], train_ref=main2[0]["train_ref"])
    out["launches_sorted"] = (sum(s["launches"]["bev_pool_sorted"] for s in serve)
                              + sum(m["streaming"]["launches"]["bev_pool_sorted"] for m in main2))
    out["launches_sorted2"] = sum(m["train"]["launches"]["bev_pool_sorted2"] for m in main2)
    s0 = serve[0]
    log(f"phase 42 camera sharding ({secs} s): 2x2 tiny step losses {out['two_by_two']['losses']}"
        f", max delta diff {out['two_by_two']['max_abs_delta_diff']:.3e} of "
        f"{moved:.3e}; tiny S=2/3 forwards {out['tiny_forward']}")
    log(f"serve --cam-shards 3 veon_b bf16: server ms {s0['server_ms']}, round trip ms "
        f"{s0['round_trip_ms']}, all-reduce (ms, dtype) per rank "
        f"{[s['allreduce_ms'] for s in serve]}, peaks GiB "
        f"{[round(s['peak_bytes'] / 2**30, 3) for s in serve]}, launches "
        f"{[s['launches'] for s in serve]}, setup s {[round(s['setup_s'], 1) for s in serve]}")
    log(f"serve --cam-shards 3 bf16 per frame, against the blockwise one, the unsharded one "
        f"and the floor (the unsharded depth tower on 2 cameras at a time): {s0['bf16']}; fp32 "
        f"frame 0 against the unsharded one: {s0['fp32']}")
    for name in ("streaming", "train"):
        log(f"{name} --cam-shards 2 veon_b bf16: " + "; ".join(
            f"rank {r}: " + ", ".join(f"{k} {v}" for k, v in m[name].items() if k != "losses")
            for r, m in enumerate(main2)))
    log(f"train --cam-shards 2 losses {out['train'][0]['losses']} vs unsharded {out['train_ref']}")
    out["kernel3"] = kernel3
    log(f"kernel #2 on a shard's stream: {s0['kernel2']}; #3: {kernel3}")
    return out


def _export_worker(out, *argv):
    """Phases 38-39's `export` CLI call `argv` in a process of its own:
    saves (the program's path, the call's host s, the launches it made) to
    `out`."""
    path, _out, seconds, launches = run_cli(list(argv))
    torch.save((path, seconds, launches), out)


EXPORTS = {"f1": [], "t2": ["--num-temporal", "2"], "t2_raw": ["--num-temporal", "2",
                                                               "--raw-uint8"]}


def export_start():
    """Start phases 38-39's three `export` calls (F=1, T=2, T=2
    `--raw-uint8`, each into a directory of its own under one temporary
    work directory) at once, in processes of this script (`--dp-worker
    export`), beside phase 33, which times nothing: nothing times them but
    their own host seconds, which are then contended. `export_phases`
    awaits them."""
    work = tempfile.mkdtemp(prefix="veon_export")
    logs = os.path.join(work, "logs")
    os.makedirs(logs)
    ranks = _start_ranks([("export", os.path.join(logs, f"{k}.pt"), "export", "--preset",
                           "veon_b", *a, "--work-dir", os.path.join(work, k))
                          for k, a in EXPORTS.items()], logs, timeout=600)
    return dict(work=work, logs=logs, ranks=ranks)


def export_phases(exp_bg, native_bg):
    """Phases 38-41 on `export_start`'s work directory (the programs, ~6 GB,
    deleted at the end), and phase 43(d) while phase 38's program and live
    server exist: phase 41's `serve_exported` is served and timed in
    43(d)'s turns beside the daemon. 43(b) and (c) ran in the compiling
    process (`native_bg`, `native_start`'s handle); the bundles are deleted
    at the end."""
    work, logs = exp_bg["work"], exp_bg["logs"]
    native = {}
    try:
        _wait_ranks(exp_bg["ranks"])
        made = {k: torch.load(os.path.join(logs, f"{k}.pt")) for k in EXPORTS}
        f1_path, server, frame, f1 = export_f1_phase(made["f1"])
        t2_path, t2 = export_t2_phase({False: made["t2"], True: made["t2_raw"]})
        bench = benchmark_phase(f1_path, t2_path)
        native_bg = native_wait(native_bg)
        native["main"], served = native_main_path(native_bg, f1_path, server, frame)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del server, frame
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(native_bg["work"], ignore_errors=True)
    made = native_bg["made"]
    native.update(ops=made["ops_check"][0],
                  tiny=dict(made["tiny_check"][0], tiny_t2=made["tiny_t2_check"][0]),
                  compile_wall_s=native_bg["wait_s"], worker_logs=native_bg["worker_logs"],
                  host_builds=made["host_builds"])
    return {"export_f1": f1, "export_t2": t2, "benchmark": bench, "serve_exported": served,
            "native": native}


# ---------------------------------------------------------------------------
# Phase 43: serving with no Python in the loop (`export --native`, the op
# library `veon_ops`, the C++ runner and daemon over libtorch)
# ---------------------------------------------------------------------------

NATIVE_HOST = ("veon_ops", "veon_aoti_runner", "veon_serve_host")
NATIVE_COMPILE_THREADS = 1  # each compiling process's workers, beside the script


class OpsProgram(torch.nn.Module):
    """Kernels #1-#3 as one small program for phase 43(b): #1 on the rig's
    presort, #2 on the full frustum's and on the K-band's stream, #3 on the
    K-band and the far-depth spray."""

    def __init__(self, num_cells, pool_r):
        super().__init__()
        self.num_cells, self.pool_r = num_cells, pool_r

    def forward(self, depth, feat, order, rk, full_vals, full_rk, band_vals, band_rk,
                spray_vals, spray_rk):
        ops = torch.ops.veon
        return (ops.bev_pool_pooled(depth, feat, order, rk, self.num_cells, self.pool_r),
                ops.bev_pool_sorted(full_vals, full_rk, self.num_cells),
                ops.bev_pool_sorted(band_vals, band_rk, self.num_cells),
                ops.bev_pool_sorted2(band_vals, band_rk, spray_vals, spray_rk, self.num_cells))


OPS_ARGS = ("depth", "feat", "order", "rk", "full_vals", "full_rk", "band_vals", "band_rk",
            "spray_vals", "spray_rk")


def native_ops_inputs(cfg, d):
    """Phase 43(b)'s inputs at the flagship shapes in bf16, as kernel_phase
    and sorted_kernel_phase make them (the rig's presort, seeded features
    and metric depth, the full frustum's, K-band's and spray's sorted
    streams), written to `d` as one .npy each in `OPS_ARGS` order; returns
    (the paths, the Python ops' outputs on them saved to `d`/want.pt, the
    kernels' launches they made)."""
    from veon_tpu_torch.cli.shapes import example_batch_full
    from veon_tpu_torch.geometry.frustum import sensor2keyego_chain
    from veon_tpu_torch.lift.lss import LSSLift, two_hot_depth
    from veon_tpu_torch.ops import bev_pool as bp
    from veon_tpu_torch.utils.export import _write_npy

    dev = torch.device("cuda")
    _, _, metas = example_batch_full(cfg, device=dev)
    s2k = sensor2keyego_chain(metas["sensor2egos"].reshape(1, -1, 4, 4),
                              metas["ego2globals"].reshape(1, -1, 4, 4), 1, cfg.data.num_cams)
    pre = LSSLift.from_config(cfg).precompute_sorted(
        s2k[:, 0], metas["intrins"][:, 0], metas["post_rots"][:, 0], metas["post_trans"][:, 0],
        metas["bda"])
    h, w = cfg.feat_hw
    C = cfg.propagation.dim
    g = torch.Generator(device=dev).manual_seed(7)
    feat = torch.randn(1, cfg.data.num_cams, h, w, C, generator=g, device=dev)
    metric = torch.rand(1, cfg.data.num_cams, h, w, generator=g, device=dev) * 58.0 + 1.5
    streams = lift_streams(cfg, metas, feat, metric, dev)
    bf = torch.bfloat16
    feat_flat = feat.to(bf).reshape(-1, C)
    (fr, fv), (br, bv), (sr, sv) = (bp.sorted_stream(wt.to(bf), feat_flat, r) for wt, r in (
        streams["full"][0], streams["band"][0], streams["band_spray"][1]))
    args = (two_hot_depth(metric, cfg.grid).to(bf), feat.to(bf), pre["order"], pre["rk_pooled"],
            fv, fr, bv, br, sv, sr)
    paths = []
    for name, t in zip(OPS_ARGS, args):
        paths.append(os.path.join(d, f"{name}.npy"))
        _write_npy(paths[-1], t)
    kernels = reset_launches()
    with torch.no_grad():
        want = OpsProgram(int(np.prod(cfg.grid.size)), 8)(*args)
    torch.cuda.synchronize()
    made = {k: fn.launches for k, fn in kernels.items()}
    expect_launches(made, {"bev_pool_pooled": 1, "bev_pool_sorted": 2, "bev_pool_sorted2": 1,
                           "ln_dense": 0}, "the ops program's Python run")
    torch.save([t.cpu() for t in want], os.path.join(d, "want.pt"))
    return paths, os.path.join(d, "want.pt"), made


def _native_worker(kind, out, work, *args):
    """Phase 43's compiling work in a process of its own (`--dp-worker
    native`), with at most NATIVE_COMPILE_THREADS compile workers: "bundles"
    builds the host programs, exports the ops program (the .npy inputs in
    args) and the three tiny bundles through the CLI (fp32: F=1, split in 2,
    T=2), then runs 43(b) and (c) on them; "flagship" exports the VEON-B
    F=1 bf16 bundle through the CLI and runs it in Python on 43(d)'s
    requests, and ends: its ~2 GB of weights and their copies leave the
    card before the memory-heavy training phases. Saves {name: (result,
    the call's host s)} and the host builds' s to `out`."""
    import torch._inductor.config as inductor_config

    from veon_tpu_torch.cli.main import main as cli_main
    from veon_tpu_torch.ops import bev_pool, native  # noqa: F401  (bev_pool: torch.ops.veon.*)
    from veon_tpu_torch.utils.export import export_native_bundle, read_npy

    inductor_config.compile_threads = NATIVE_COMPILE_THREADS
    res = {}

    def timed(name, fn):
        t = time.perf_counter()
        res[name] = (fn(), time.perf_counter() - t)
        print(f"native worker: {name} {res[name][1]:.1f} s", flush=True)

    if kind == "flagship":
        timed("veon_b", lambda: cli_main(["export", "--native", "--preset", "veon_b",
                                          "--work-dir", os.path.join(work, "veon_b")]))
        timed("veon_b_python", lambda: _native_python_preds(res["veon_b"][0]))
    else:
        res["host_builds"] = {k: v["seconds"] for k, v in native.build_host(*NATIVE_HOST).items()}
        cfg_cells = int(args[0])
        ins = tuple(read_npy(p).cuda() for p in args[1:])
        timed("ops", lambda: export_native_bundle(OpsProgram(cfg_cells, 8), ins,
                                                  os.path.join(work, "ops"), OPS_ARGS, OPS_ARGS))
        del ins
        base = ["export", "--native", "--preset", "veon_tiny_test"]
        for name, extra in (("tiny", []), ("tiny_split", ["--split-output", "2"]),
                            ("tiny_t2", ["--num-temporal", "2"])):
            timed(name, lambda extra=extra, name=name: cli_main(
                base + extra + ["--work-dir", os.path.join(work, name)]))
        # 43(b) and (c) time nothing: they run here, beside the script's phases
        torch.set_num_threads(2)
        bg = dict(made=res, work=work, paths=list(args[1:]),
                  want=os.path.join(os.path.dirname(args[1]), "want.pt"))
        timed("ops_check", lambda: native_ops_phase(bg))
        timed("tiny_check", lambda: native_tiny_phase(bg))
        timed("tiny_t2_check", lambda: native_tiny_t2_phase(bg))
    torch.save(res, out)


def native_requests():
    """Phase 43(d)'s 4 requests: the example frame of VEON-B's F=1 serving
    graph (`entry`'s) + i * 1e-3, as numpy."""
    from veon_tpu_torch.cli.shapes import example_batch_full
    from veon_tpu_torch.utils.export import _serving_cfg

    imgs, depth_imgs, _m = example_batch_full(_serving_cfg("veon_b", compute_dtype="bfloat16"),
                                              device="cuda")
    return [{"imgs": (imgs + i * 1e-3).cpu().numpy(),
             "depth_imgs": (depth_imgs + i * 1e-3).cpu().numpy()} for i in range(4)]


def _native_python_preds(outdir):
    """The VEON-B bundle's package loaded in this process (its extern nodes
    calling the Python ops) and run on `native_requests`: (the grids on
    the host, load s, kernel #1's launches)."""
    from veon_tpu_torch.utils.export import NativeBundle

    b = NativeBundle(outdir)
    t = time.perf_counter()
    run_py = b.load_python()
    load_s = time.perf_counter() - t
    kernels = reset_launches()
    with torch.no_grad():
        preds = [run_py(b.flat_inputs(r, "cuda"))["pred"].cpu() for r in native_requests()]
    return preds, load_s, kernels["bev_pool_pooled"].launches


def native_start(cfg):
    """Start phase 43's compiling processes (`_native_worker`) right after
    the kernels are timed: the flagship's AOTInductor compile takes minutes
    and runs beside the phases that follow. Returns the handle
    `native_wait` takes."""
    work = tempfile.mkdtemp(prefix="veon_native")
    d = os.path.join(work, "ops_in")
    os.makedirs(d)
    t = time.perf_counter()
    paths, want, made = native_ops_inputs(cfg, d)
    inputs_s = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    logs = os.path.join(work, "logs")
    os.makedirs(logs)
    cells = str(int(np.prod(cfg.grid.size)))
    argvs = {"flagship": ("native", "flagship", os.path.join(logs, "flagship.pt"), work),
             "bundles": ("native", "bundles", os.path.join(logs, "bundles.pt"), work, cells,
                         *paths)}
    log(f"phase 43(a): the ops program's inputs ({inputs_s:.1f} s, "
        f"{sum(os.path.getsize(p) for p in paths) / 1e9:.3f} GB of .npy) and its Python run "
        f"({made}); veon_b and the small bundles compiling in 2 processes")
    ranks = {}
    for name, argv in argvs.items():  # one handle each: a failure stops only its own
        os.makedirs(os.path.join(logs, name))
        ranks[name] = _start_ranks([argv], os.path.join(logs, name), timeout=1100)
    return dict(work=work, logs=logs, paths=paths, want=want, t=time.perf_counter(),
                ranks=ranks)


def native_wait(bg):
    """Wait for `native_start`'s processes: adds their results ("made":
    {name: (dir, s)}) and the seconds from their start to their end.
    Raises with the failed processes' output once both have ended."""
    outs, errors = [], []
    for name, handle in bg["ranks"].items():
        try:
            outs += _wait_ranks(handle)
        except AssertionError as e:
            errors.append(f"{name}: {e}")
    if errors:
        raise AssertionError("phase 43(a) compiling processes failed:\n" + "\n".join(errors))
    made = {}
    for name in ("flagship", "bundles"):
        made.update(torch.load(os.path.join(bg["logs"], f"{name}.pt"), weights_only=False))
    bg.update(made=made, wait_s=round(time.perf_counter() - bg["t"], 1), worker_logs=[
        ln for o in outs for ln in o.splitlines() if ln.startswith("native worker:")])
    log(f"phase 43(a): compiling processes done {bg['wait_s']} s after their start: "
        f"{bg['worker_logs']}; host builds {made['host_builds']}")
    for o in outs:  # 43(b) and (c), which ran in the compiling process
        for ln in o.splitlines():
            if ln.startswith(("phase 43(b)", "phase 43(c)")):
                log(ln)
    return bg


def _daemon(bundle, sock):
    """`veon_serve_host` serving `bundle` on `sock`, started and awaited
    (its socket exists): (process, start s)."""
    t = time.perf_counter()
    proc = subprocess.Popen(bundle.daemon_argv(sock), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    _RANKS.append(proc)
    while not os.path.exists(sock):
        if proc.poll() is not None:
            raise AssertionError(f"veon_serve_host exited {proc.returncode}: "
                                 f"{proc.stderr.read()[-3000:]}")
        if time.perf_counter() - t > 300:
            raise AssertionError("veon_serve_host did not listen within 300 s")
        time.sleep(0.05)
    return proc, time.perf_counter() - t


def _daemon_stop(proc):
    """Stop a daemon: (its served-request lines, parsed, and its stderr)."""
    proc.terminate()
    out, err = proc.communicate(timeout=60)
    lines = []
    for ln in out.splitlines():
        if ln.startswith("served request"):
            counts = dict(kv.split("=") for kv in ln.split("launches ")[1].split(";")[0].split())
            lines.append({"server_ms": float(ln.split("server_ms ")[1].split(";")[0]),
                          "launches": {k: int(v) for k, v in counts.items()},
                          "peak_bytes": int(ln.split("device peak ")[1].split()[0])})
    return lines, err


def native_ops_phase(bg):
    """43(b), in the compiling process: the ops program's package through
    `veon_aoti_runner`, which
    loads the op library `veon_ops` first: its four outputs bit-equal to
    the Python ops' on the same inputs (the same kernels, no atomics in
    their forward), the library's counters #1 once, #2 twice (full frustum
    and K-band), #3 once; `--probe` reports the card."""
    from veon_tpu_torch.utils.export import NativeBundle, read_npy

    b = NativeBundle(bg["made"]["ops"][0])
    probe = subprocess.run(b.runner_argv([], "x")[:3] + ["--probe"], capture_output=True,
                           text=True, timeout=300)
    if probe.returncode != 0 or "package device: cuda" not in probe.stdout \
            or "op library: cuda" not in probe.stdout:
        raise AssertionError(f"runner --probe: {probe.returncode} {probe.stdout} {probe.stderr}")
    prefix = os.path.join(bg["work"], "ops_out_")
    t = time.perf_counter()
    r = subprocess.run(b.runner_argv(bg["paths"], prefix), capture_output=True, text=True,
                       timeout=600)
    run_s = time.perf_counter() - t
    if r.returncode != 0:
        raise AssertionError(f"veon_aoti_runner on the ops package: {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    counts = dict(kv.split("=") for kv in r.stdout.split("launches ")[1].split())
    counts = {k: int(v) for k, v in counts.items()}
    if counts != {"bev_pool_pooled": 1, "bev_pool_sorted": 2, "bev_pool_sorted2": 1,
                  "deform_stencil": 0}:
        raise AssertionError(f"the op library counted {counts}")
    names = ("#1 pooled", "#2 full frustum", "#2 K-band", "#3 band + spray")
    for i, (name, want) in enumerate(zip(names, torch.load(bg["want"]))):
        got = read_npy(f"{prefix}{i}.npy")
        if got.dtype != want.dtype or not torch.equal(got.view(torch.int16),
                                                      want.view(torch.int16)):
            raise AssertionError(f"{name}: the C++ op differs from the Python op")
    res = {"launches": counts, "runner_s": run_s, "probe": probe.stdout.strip().splitlines(),
           "package_bytes": os.path.getsize(b.package), "export_s": b.manifest["export_s"],
           "compile_s": b.manifest["compile_s"]}
    log(f"phase 43(b): veon_ops' CUDA #1, #2 (full, K-band), #3 bit-equal to the Python ops at "
        f"the flagship shapes (bf16) through veon_aoti_runner ({run_s:.1f} s, inputs from "
        f".npy); library counters {counts}; probe {res['probe']}")
    return res


def _client_roll(resp, req, prev):
    """The next request's cache: early_vox first (newest), this pose first."""
    vox, l2g = prev
    early = torch.as_tensor(np.asarray(resp["early_vox"]))
    return (torch.cat([early[:, None].to(vox.dtype), vox[:, :-1]], 1),
            torch.cat([torch.as_tensor(req["lidarego2global"])[:, None], l2g[:, :-1]], 1))


def _cli_seeded_on_cpu(cfg):
    """The model the CLI's exporters seed on the card (`build_model`, seed
    0), on the CPU."""
    from veon_tpu_torch.entry import build_model

    on_card = build_model(cfg, torch.device("cuda"), 0, None)
    model = build_model(cfg, torch.device("cpu"), 1, None)
    model.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    return model.eval()


def native_tiny_phase(bg):
    """43(c)'s F=1 part, in the compiling process: the tiny fp32
    F=1 bundles on the card, whole and split in 2 (joined back), each
    served by `veon_serve_host` to `TensorClient` against the live port
    module on the CPU with the same weights (the CLI's seed on the card,
    moved to the CPU): the class grid off near-ties."""
    from veon_tpu_torch.cli.shapes import example_batch
    from veon_tpu_torch.entry import ServingForward, _ov_weight
    from veon_tpu_torch.serve.client import TensorClient
    from veon_tpu_torch.utils.export import NativeBundle, _serving_cfg

    cpu = torch.device("cpu")
    res = {}
    cfg = _serving_cfg("veon_tiny_test")
    model = _cli_seeded_on_cpu(cfg)
    ovw, membership = _ov_weight(cfg, cpu, seed=0)
    live = ServingForward(model, membership).eval()
    imgs, _d, _m = example_batch(cfg, device=cpu)
    # the bundle takes depth-tower frames at the frames' size, as JAX's
    depth_imgs = torch.from_numpy(
        np.random.default_rng(5).standard_normal(imgs.shape).astype(np.float32))
    for name in ("tiny", "tiny_split"):
        b = NativeBundle(bg["made"][name][0])
        binds = b.binds()
        metas = {n.split(".", 1)[1]: t for n, t in binds.items() if n.startswith("metas.")}
        with torch.no_grad():
            out = model.full_forward(imgs, depth_imgs, metas, ovw)
            want = live(imgs, depth_imgs, metas, ovw)
        clear = ~near_ties(out, membership)
        d = socket_dir()
        proc, start_s = _daemon(b, os.path.join(d, "s.sock"))
        try:
            with TensorClient(os.path.join(d, "s.sock")) as c:
                resp = b.concat_split(c.infer(imgs=imgs.numpy(), depth_imgs=depth_imgs.numpy()))
        finally:
            lines, _err = _daemon_stop(proc)
            shutil.rmtree(d, ignore_errors=True)
        got = torch.from_numpy(resp["pred"])
        diff = int(((got != want) & clear).sum())
        if diff or clear.float().mean() < 0.95:  # seeded weights: ~2.5% near-ties
            raise AssertionError(f"{name}: served grid differs off near-ties in {diff} voxels "
                                 f"(clear share {float(clear.float().mean()):.4f})")
        res[name] = {"agree_all": float((got == want).float().mean()),
                     "clear": float(clear.float().mean()), "start_s": start_s,
                     "server_ms": lines[-1]["server_ms"], "launches": lines[-1]["launches"],
                     "compile_s": b.manifest["compile_s"], "parts": len(b.manifest["outputs"])}
    log(f"phase 43(c): tiny fp32 F=1 bundles on the card served by veon_serve_host against "
        f"the live CPU module: {res}")
    return res


def native_tiny_t2_phase(bg):
    """43(c)'s T=2 part, in the compiling process: the tiny fp32
    T=2 bundle on the card served by `veon_serve_host` to `TensorClient`,
    3 drive calls with the cache rolled by the client, against the live
    port session on the CPU with the same weights: the float outputs
    within 2e-4, the class grid off near-ties."""
    from veon_tpu_torch.cli.shapes import example_drive
    from veon_tpu_torch.entry import _ov_weight
    from veon_tpu_torch.serve.client import TensorClient
    from veon_tpu_torch.serve.streaming import TemporalSession
    from veon_tpu_torch.utils.export import NativeBundle, _serving_cfg

    cpu = torch.device("cpu")
    # the bundle's bound rig, the drive's frames, the cache rolled here
    b = NativeBundle(bg["made"]["tiny_t2"][0])
    binds = b.binds()
    tcfg = _serving_cfg("veon_tiny_test", 2)
    tmodel = _cli_seeded_on_cpu(tcfg)
    tovw, membership = _ov_weight(tcfg, cpu, seed=0)
    rig = {}
    for n, t in binds.items():
        if n.startswith("rig."):
            *path, leaf = n.split(".")[1:]
            node = rig
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = t
    sess = TemporalSession(tmodel, tovw, membership, rig_metas=rig)
    _rig, reqs = example_drive(tcfg, 3, device=cpu)
    shapes = dict(zip(b.manifest["order"], b.manifest["in_shapes"]))
    vox = torch.zeros([int(s) for s in shapes["prev_vox"].split("[")[1][:-1].split(",")])
    prev = (vox, torch.eye(4).expand(1, vox.shape[1], 4, 4).clone())
    te = torch.zeros(tcfg.propagation.clip_proj_dim)
    d = socket_dir()
    proc, start_s = _daemon(b, os.path.join(d, "s.sock"))
    errs, agree = {}, []
    try:
        with TensorClient(os.path.join(d, "s.sock")) as c:
            for req in reqs:
                with torch.no_grad():
                    want = sess.infer(req["imgs"], req["depth_imgs"],
                                      {"lidarego2global": req["lidarego2global"]})
                rnp = {k: v.numpy() for k, v in req.items()}
                resp = c.infer(prev_vox=prev[0].numpy(), prev_l2g=prev[1].numpy(),
                               text_embed=te.numpy(), **rnp)
                prev = _client_roll(resp, rnp, prev)
                for k, w in want.items():
                    g = torch.from_numpy(np.asarray(resp[k]))
                    if k == "pred":
                        clear = ~near_ties(want, membership)
                        if int(((g != w) & clear).sum()):
                            raise AssertionError("T=2 served grid differs off near-ties")
                        agree.append(float((g == w).float().mean()))
                    elif w.is_floating_point():
                        errs[k] = max(errs.get(k, 0.0), float((g - w).abs().max()))
                        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4,
                                                   msg=f"T=2 served {k}: {errs}")
    finally:
        lines, _err = _daemon_stop(proc)
        shutil.rmtree(d, ignore_errors=True)
    per = [ln["launches"]["deform_stencil"] for ln in lines]
    if per != [2 * (i + 1) for i in range(len(reqs))]:
        raise AssertionError(f"T=2 daemon deform_stencil launches {per}, expected 2 a request")
    res = {"calls": len(reqs), "max_abs_err": errs, "agree_all": agree,
           "start_s": start_s, "server_ms": [ln["server_ms"] for ln in lines],
           "launches": lines[-1]["launches"], "compile_s": b.manifest["compile_s"]}
    log(f"phase 43(c): tiny fp32 T=2 bundle on the card served by veon_serve_host against the "
        f"live CPU session: {res}")
    return res


def native_main_path(bg, f1_path, server, frame):
    """43(d), a main path: `veon_serve_host` serving the VEON-B F=1 bf16
    bundle (phase 43(a)'s compile) to `TensorClient`, 1 warm-up and 3
    requests on the synthetic rig's frame (+ i * 1e-3, `native_requests`),
    kernel #1 once per request by the op library's counter; each grid
    bit-equal to the same package loaded in Python (its extern nodes
    calling the Python ops; run on the same requests by the compiling
    process, `_native_python_preds`), and agreeing with the live bf16 `FrameServer`
    (the same seeded weights) off near-ties (flip < 0.15, the bf16 floor).
    server_ms of the daemon, of `serve_exported` (phase 38's program) and
    the live frame's ms, timed in turns; the daemon's allocator peak and
    its whole device memory after request 0 (the card's free memory before
    its start less after, less what this process reserved meanwhile).
    Phase 41 rides along: each `serve_exported` pred equal to the live
    grid, kernel #1 once per request. Returns (43(d)'s results, 41's)."""
    from veon_tpu_torch.serve.client import TensorClient
    from veon_tpu_torch.serve.server import serve_exported
    from veon_tpu_torch.utils.export import NativeBundle

    phase_base()
    imgs, depth_imgs, live0 = frame
    b = NativeBundle(bg["made"]["veon_b"][0])
    (py_preds, load_py_s, py_launches), _s = bg["made"]["veon_b_python"]
    d = socket_dir()
    sock, sock_x = os.path.join(d, "s.sock"), os.path.join(d, "x.sock")
    torch.cuda.synchronize()
    free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    proc, start_s = _daemon(b, sock)
    t = time.perf_counter()
    srv = serve_exported(f1_path, sock_x, bound={"metas": server.metas,
                                                 "ov_weight": server.ov_weight},
                         request_keys=("imgs", "depth_imgs"),
                         arg_order=("imgs", "depth_imgs", "metas", "ov_weight"),
                         out_names=("pred",))
    x_start_s = time.perf_counter() - t
    kernels = reset_launches()
    turns = {"daemon": [], "serve_exported": [], "live": []}
    agree, x_rts, x_sms, x_calls = [], [], [], []
    try:
        with TensorClient(sock) as c, TensorClient(sock_x) as cx:
            for i, req in enumerate(native_requests()):  # request 0 warms every server up
                im, dm = imgs + i * 1e-3, depth_imgs + i * 1e-3
                before = {k: f.launches for k, f in kernels.items()}
                resp = c.infer(**req)
                if any(f.launches != before[k] for k, f in kernels.items()):
                    raise AssertionError("the daemon's request launched a Python op")
                if i == 0:  # the card's memory less what this process held before
                    held = free0 - torch.cuda.mem_get_info()[0] - (
                        torch.cuda.memory_reserved() - reserved0)
                rx, rt, made = _served(cx, kernels, req, f"serve_exported request {i}")
                x_rts.append(rt)
                x_sms.append(float(np.asarray(rx["server_ms"]).reshape(-1)[0]))
                x_calls.append(made)
                torch.cuda.synchronize()
                t = time.perf_counter()
                with torch.no_grad():
                    live = server(im, dm)
                torch.cuda.synchronize()
                live_ms = (time.perf_counter() - t) * 1e3
                if not np.array_equal(rx["pred"], live.cpu().numpy()):
                    raise AssertionError(f"serve_exported request {i}: pred differs from the "
                                         f"live grid")
                with torch.no_grad():
                    out = server.outputs(im, dm)
                got = torch.from_numpy(resp["pred"])
                if not torch.equal(got, py_preds[i]):
                    raise AssertionError(f"request {i}: the daemon's grid differs from the same "
                                         f"package run in Python in "
                                         f"{int((got != py_preds[i]).sum())} voxels")
                got = got.cuda()
                if i == 0:
                    if not torch.equal(live, live0):
                        raise AssertionError("the live frame differs from phase 38's")
                    continue
                clear = ~near_ties(out, server.membership)
                agree.append(float((got == live)[clear].float().mean()))
                turns["daemon"].append(float(np.asarray(resp["server_ms"]).reshape(-1)[0]))
                turns["serve_exported"].append(x_sms[-1])
                turns["live"].append(live_ms)
    finally:
        srv.stop()
        lines, err = _daemon_stop(proc)
        shutil.rmtree(d, ignore_errors=True)
    per = [ln["launches"]["bev_pool_pooled"] for ln in lines]
    if per != [1, 2, 3, 4] or any(ln["launches"]["bev_pool_sorted"] or
                                  ln["launches"]["bev_pool_sorted2"] or
                                  ln["launches"]["deform_stencil"] for ln in lines):
        raise AssertionError(f"daemon launch counts {[ln['launches'] for ln in lines]}")
    if py_launches != 4:
        raise AssertionError(f"the package run in Python launched #1 {py_launches} times")
    if min(agree) < 0.85:
        raise AssertionError(f"daemon grid agrees with the live bf16 frame on {agree} off "
                             f"near-ties (< 0.85)")
    res = {"requests": 4, "launches_pooled": per[-1], "agree_live_off_ties": agree,
           "grid_equal_python": True, "server_ms_in_turns": turns,
           "first_server_ms": lines[0]["server_ms"], "daemon_start_s": start_s,
           "python_load_s": load_py_s, "daemon_peak_bytes": lines[-1]["peak_bytes"],
           "daemon_device_bytes": held, "export_s": b.manifest["export_s"],
           "compile_s": b.manifest["compile_s"], "package_bytes": os.path.getsize(b.package),
           "cli_s": bg["made"]["veon_b"][1]}
    log(f"phase 43(d) veon_serve_host veon_b F=1 bf16: 4 requests, #1 by the op library "
        f"{per}, grids == the package run in Python, agreement with the live bf16 frame off "
        f"near-ties {agree}; server_ms in turns {turns}; first request {lines[0]['server_ms']:.3f}"
        f" ms; daemon start (load + binds) {start_s:.3f} s, package load in Python "
        f"{load_py_s:.3f} s; the daemon's allocator peak {lines[-1]['peak_bytes'] / 2**30:.3f} "
        f"GiB, its whole device memory after request 0 {held / 2**30:.3f} GiB (context, "
        f"weights, allocator); export {res['export_s']:.1f} s, compile "
        f"{res['compile_s']:.1f} s, package {res['package_bytes']} bytes")
    served = {"start_s": x_start_s, "round_trip_ms": x_rts, "server_ms": x_sms,
              "launches_pooled": sum(x_calls)}
    log(f"serve_exported F=1 (phase 41, in 43(d)'s turns): start (load) {x_start_s:.3f} s, "
        f"round trip ms {[round(x, 3) for x in x_rts]}, server_ms "
        f"{[round(x, 3) for x in x_sms]}, pred == live grid, kernel #1 {x_calls} per request")
    return res, served


def tools_phase(frame_ms):
    """43(e), the analysis tools at VEON-B bf16 on the card:
    `utils/train_bench.py` `main` (the forward and loss alone, 1 timed
    step under remat full and none after an untimed one, one untimed step
    under dots_saveable for its peak; #3 once per call and step, the
    cached-depth batch) and `utils/roofline.py` `print_audit` (the F=1
    graph's floors at the H100 data-sheet peaks), whose floor is read as a
    share of phase 6's measured ms/frame."""
    import contextlib
    import io

    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.utils import roofline, train_bench

    phase_base()
    kernels = reset_launches()
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rows = train_bench.main(["--preset", "veon_b", "--steps", "1", "--policies", "true,none",
                                 "--compile-only-policies", "dots_saveable"])
    seconds = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in kernels.items()}
    expect_launches(launches, {k: 7 * int(k == "bev_pool_sorted2") for k in launches},
                    "train_bench veon_b bf16")
    if any("run_error" in r for r in rows) or len(rows) != 4:
        raise AssertionError(f"train_bench legs: {rows}")
    with contextlib.redirect_stdout(io.StringIO()):
        audit = roofline.print_audit(presets.veon_b(), as_json=True)
    res = {"train_bench": rows, "train_bench_s": seconds, "launches_sorted2": 7,
           "roofline_floor_ms": audit["floor_ms"], "roofline_total_gflop": audit["total_gflop"],
           "roofline_total_mb_min": audit["total_mb_min"],
           "frame_share_of_floor": audit["floor_ms"] / frame_ms}
    log(f"phase 43(e) train_bench veon_b bf16 ({seconds:.1f} s): {rows}; roofline veon_b "
        f"floor {audit['floor_ms']} ms ({audit['total_gflop']} GFLOP, "
        f"{audit['total_mb_min']} MB least traffic, H100 data-sheet peaks), the measured frame "
        f"({frame_ms:.3f} ms) at {res['frame_share_of_floor']:.4f} of it")
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.ops import native

    # phase 43's AOTInductor and Triton caches in the checkout's build/ (this
    # process's and its workers'): a second run reuses the first's kernels
    build_root = native.BUILD_DIR.parent
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build_root / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build_root / "triton"))
    script_t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    builds = native.build(*sorted({os.path.basename(src)[:-3]
                                   for src, _ in (*KERNELS.values(), *OWN_KERNELS.values())}))
    log(f"build: {time.perf_counter() - t0:.1f} s wall, "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in builds.items()))
    for k, v in builds.items():
        log(v["log"].strip()[-1500:])

    # fp32 stays fp32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    laps, last = {}, [time.perf_counter()]

    def lap(name):
        """Seconds since the last lap, kept per group of phases (and logged)."""
        now = time.perf_counter()
        laps[name], last[0] = round(now - last[0], 1), now
        log(f"lap {name}: {laps[name]} s ({now - script_t0:.1f} s in)")

    cfg = presets.veon_b(compute_dtype="bfloat16")
    kern, (metas, pre, feat, metric, dist) = kernel_phase(cfg)
    sorted_res = sorted_kernel_phase(cfg, metas, feat, metric)
    backward = pooled_backward_phase(cfg, pre, feat, dist)
    del metas, pre, feat, metric, dist
    torch.cuda.empty_cache()
    ln = ln_dense_phase()
    stencil = deform_stencil_phase()
    lap("1-2 kernels")
    # phase 43(a): the AOTInductor compiles start now, after the kernels' timings
    native_bg = native_start(cfg)
    lap("43(a) start")
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
        del variables
        gc.collect()
        torch.cuda.empty_cache()
        # phase 42's untimed ranks and phases 38-39's exports run beside the
        # parity check, which times nothing
        camshard_bg = camshard_start()
        export_bg = export_start()
        lap("17 precision")
        parity = parity_phase(ckpt_root)
        camshard_bg = camshard_wait(camshard_bg)
        lap("33 parity (beside phase 42's untimed ranks)")
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
        data_parallel = data_parallel_phase(shard, rounds=6)  # 12 cost the script's time
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
    exported = export_phases(export_bg, native_bg)
    tools = tools_phase(main_res["median_ms"])
    lap("38-41 export, benchmarks, serve_exported; 43 native serving, tools")
    camshard = camshard_phase(camshard_bg)
    lap("42 camera sharding")

    # launches on the main paths: the F=1 frames, the requests served from
    # converted weights and the new presets' frames, the zoe frames, calls
    # and served requests (#1); the train steps (#2, #3), the weights
    # drills' forwards and the eval loops' frames, zoe's included, the CLI
    # train steps and the frames of `test` on their checkpoints, the
    # temporal train steps (F per step), the data-parallel steps (#3); the
    # F=2 full-frustum temporal step (#2); phases 33-37: the parity, vis and
    # train --remat runs (#3), the REC_CROSS_ATTN=False frames (#1), the
    # lift microbench's calls (#2); phases 38-41: the exported programs'
    # calls, the benchmarks' calls and the requests served from a program
    # (#1); phase 42: every rank's sharded frames and streaming calls (#2)
    # and sharded train steps (#3); phase 43(d): the requests the C++ daemon
    # served, by the op library's counter (#1); 43(e): train_bench's calls
    # and steps (#3)
    rows = {"bev_pool_pooled": (kern["bf16"], main_res["launches"]["bev_pool_pooled"]
                                + sum(weights["launches_per_request"])
                                + new_presets["launches"]["bev_pool_pooled"]
                                + zoe_f1["launches"]["bev_pool_pooled"]
                                + zoe_t2["launches"]["bev_pool_pooled"]
                                + zoe_weights["launches_pooled"]
                                + rec_opts["launches"]["bev_pool_pooled"]
                                + exported["export_f1"]["launches_pooled"]
                                + exported["export_t2"]["float"]["launches_pooled"]
                                + exported["export_t2"]["raw_uint8"]["launches_pooled"]
                                + exported["benchmark"]["launches_pooled"]
                                + exported["serve_exported"]["launches_pooled"]
                                + exported["native"]["main"]["launches_pooled"]),
            "bev_pool_sorted": (sorted_res["full_bf16"],
                                train["full"]["launches"]["bev_pool_sorted"]
                                + temporal_cli["launches_sorted"]
                                + prof["launches"]["bev_pool_sorted"]
                                + camshard["launches_sorted"]),
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
                                 + remat["launches_sorted2"] + camshard["launches_sorted2"]
                                 + tools["launches_sorted2"]),
            # no main path calls kernel #4 (the model keeps LayerNorm + Dense)
            "ln_dense": (ln["hsa_qkv_bf16"], main_res["launches"]["ln_dense"]
                         + temporal["launches"]["ln_dense"]),
            # twice per streaming call (phases 9 and 22) and per temporal
            # train step or test frame (phase 31)
            "deform_stencil": (stencil["bf16"], temporal["stencil_launches"]
                               + zoe_t2["stencil_launches"]
                               + temporal_cli["stencil_launches"])}
    sources = {**KERNELS, **OWN_KERNELS}
    table = {"kernels": [{
        "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
        "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"]} for name, (r, launches) in rows.items()]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "kind": kind, "kernel": kern, "sorted_kernels": sorted_res,
                   "pooled_backward": backward, "train_small_parity": train_small,
                   "train": train, "small_parity_max_abs": small, "main_path": main_res,
                   "breakdown": where, "ln_dense": ln, "deform_stencil": stencil,
                   "temporal_small_parity": temporal_small,
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
                   "profiling": prof, "export": exported, "camshard": camshard, "tools": tools,
                   "builds": {k: v["seconds"] for k, v in builds.items()}, "phase_s": laps,
                   "script_s": time.perf_counter() - script_t0},
                  f, indent=1)
    for r, _ in rows.values():
        if not all(r[k] is None or math.isfinite(r[k])
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")):
            raise AssertionError("non-finite timing")
    log(f"phase seconds: {laps}")
    log(f"whole script: {time.perf_counter() - script_t0:.1f} s wall")
    log(smi)
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:  # a process of phase 32, 38-39, 42 or 43
        {"step": _dp_step_worker, "cli": _dp_cli_worker, "cs_tiny": _cs_tiny_worker,
         "cs_serve": _cs_serve_worker, "cs_main2": _cs_main2_worker,
         "export": _export_worker, "native": _native_worker}[sys.argv[2]](*sys.argv[3:])
        sys.exit(0)
    try:
        sys.exit(main())
    finally:
        _kill_ranks()
