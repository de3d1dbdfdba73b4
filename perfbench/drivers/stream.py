"""Streamed serving traffic: one ego vehicle, closed loop, one request in
flight, through the port's request handler in the process
(`entry.serve_entry` with the benchmark's weights, raw uint8 frames; no
socket): a streaming session of `num_temporal` frames, or with
num_temporal 1 the single-frame server.

Each request carries six raw uint8 camera images, the depth branch's
uint8 input and, to a streaming session, the ego pose `lidarego2global`;
it starts with the frame
in host memory and ends when the handler's response (`pred`, the uint8
class grid) is in host memory. Frames come from a seeded pool made at
set-up and played in order; the pose follows a seeded drive and advances
on every request, so no two requests of a run are the same (frame, pose).

The traffic file gives: num_temporal, pool_frames, drive (step_m,
yaw_deg), warmup_requests, check_within (the judged request drawn from
the seed lies among the window's first `check_within`; the last timed
request is always judged too) and profiled_requests (the traced run's
profiler stretch, after one profiled request that starts the profiler).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from perfbench import harness, judge, trace


def make_frames(torch, cfg, traffic: Dict, seed: int, count: int, device) -> List[Dict]:
    """`count` requests in time order: pool frames made on the device from
    the seed and held in host memory, poses of the seeded drive."""
    N, (H, W) = cfg.data.num_cams, cfg.data.input_size
    dh, dw = harness.depth_tower_hw(cfg)
    P = traffic["pool_frames"]
    gen = torch.Generator(device=device).manual_seed(harness.subseed(seed, "frames"))
    imgs = torch.randint(0, 256, (P, 1, 1, N, H, W, 3), generator=gen, device=device,
                         dtype=torch.uint8).cpu().numpy()
    depth = torch.randint(0, 256, (P, 1, 1, N, dh, dw, 3), generator=gen, device=device,
                          dtype=torch.uint8).cpu().numpy()
    drive = traffic["drive"]
    poses = harness.drive_poses(count, harness.rng(seed, "drive"), drive["step_m"],
                                drive["yaw_deg"])
    out = []
    for k in range(count):
        fr = {"imgs": imgs[k % P], "depth_imgs": depth[k % P]}
        if traffic["num_temporal"] > 1:
            fr["lidarego2global"] = poses[k:k + 1]
        out.append(fr)
    return out


def max_requests(seconds: float, traffic: Dict) -> int:
    # a generous cap: no request of this model is served in under 20 ms
    return traffic["warmup_requests"] + int(seconds * 50) + traffic["profiled_requests"] + 2


def build_program(torch, cell: harness.Cell, seed: int, device):
    """The port's handler for the cell, with the benchmark's weights."""
    from veon_tpu_torch import entry
    from veon_tpu_torch.configs import presets
    from perfbench.reference.configs import base as ref_base

    nt = cell.traffic["num_temporal"]
    cfg = harness.build_config(presets, cell.config, nt)
    skel = harness.make_weights(harness.config_from_file(ref_base, cell.config, nt, "float32"),
                                seed, device)
    model = entry.build_model(cfg, device, 0, None)
    model.load_state_dict(skel.state_dict(), strict=True)
    del skel
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    handler, *_ = entry.serve_entry(cfg, device, raw_uint8=True, model=model)
    return cfg, model, handler


class Keep:
    """What the check needs of the latest request, held by reference
    (nothing is copied in the window): the raw outputs, and of a streaming
    session its newest cached voxels before and after the request, of the
    single-frame server the voxels its 3D head took."""

    def __init__(self, handler):
        self.latest: Dict = {}
        session = handler.session
        if session is None:
            server = handler.server
            server.model.alignnet.register_forward_pre_hook(
                lambda m, a: self.latest.__setitem__("vox", a[0]))
            outputs = server.outputs

            def kept_f1(*a, **k):
                out = outputs(*a, **k)
                self.latest.update(bin_occ=out["bin_occ"], sem_occ_raw=out["sem_occ_raw"])
                return out

            server.outputs = kept_f1
            return
        infer = session.infer

        def kept(*a, **k):
            prev = session.state()[0][:, 0]
            out = infer(*a, **k)
            self.latest = {"prev_vox": prev, "vox": session.state()[0][:, 0],
                           "bin_occ": out["bin_occ"], "sem_occ_raw": out["sem_occ_raw"]}
            return out

        session.infer = kept

    def take(self, pred) -> Dict:
        return dict(self.latest, pred=pred)


def run(ctx: Dict) -> Dict:
    """One run of a serving cell; see `run.py` for `ctx` and the result."""
    import torch

    cell, seed, seconds, traced = ctx["cell"], ctx["seed"], ctx["seconds"], ctx["trace"]
    dev = torch.device(ctx["device"])
    tr = cell.traffic
    nt = tr["num_temporal"]
    parts = {"start": time.perf_counter() - ctx["t_start"]}
    cfg, model, handler = build_program(torch, cell, seed, dev)
    parts["program"] = time.perf_counter() - ctx["t_start"]
    if ctx.get("program_hook"):
        ctx["program_hook"](handler)
    frames = make_frames(torch, cfg, tr, seed, max_requests(seconds, tr), dev)
    parts["frames"] = time.perf_counter() - ctx["t_start"]
    k = 0
    for _ in range(tr["warmup_requests"]):
        handler(**frames[k])
        k += 1
    first = k
    sample = first + int(harness.rng(seed, "check").integers(0, tr["check_within"]))
    keep = Keep(handler)
    kept: Dict[int, Dict] = {}
    pred = None

    def serve(until: float, lat: List[float], spans=None, timer=None):
        nonlocal k, pred
        while time.perf_counter() < until and k < len(frames):
            t0 = time.perf_counter()
            pred = handler(**frames[k])["pred"]
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if spans is not None:
                spans.append((t0, t1))
                timer.end_item()
            if k == sample:
                kept[k] = keep.take(pred)
            k += 1

    t_first = time.perf_counter()
    setup_s = t_first - ctx["t_start"]
    records: Dict = {"flops_per_item": ctx["flops_per_item"], "setup_parts": dict(parts, warm=setup_s)}
    lat: List[float] = []
    if not traced:
        serve(t_first + seconds, lat)
        window = time.perf_counter() - t_first
        metrics = {"ms_per_frame": 1e3 * window / len(lat),
                   "p95_frame_ms": 1e3 * float(np.percentile(lat, 95)), "setup_s": setup_s}
    else:
        # plain requests first (the rate the MFU reads), then the same with
        # CUDA events around each tower and host clocks around the
        # session's infer, then a profiled stretch
        serve(t_first + seconds / 2, lat)
        records["ms_per_item"] = 1e3 * (time.perf_counter() - t_first) / len(lat)
        timer = trace.StageTimer(torch)
        for mod, name in ((model.depth, "depth"), (model.clip_visual, "clip_visual"),
                          (model.side_adapter, "side_adapter"), (model.rec_head, "rec_head"),
                          (model.hsa, "hsa"), (model.alignnet, "alignnet")):
            timer.hook(mod, name)
        if nt > 1:
            timer.hook(model.alignnet.temporal_fusion, "temporal_fusion")
            timer.wrap(model, "align_to_prev", "warp")
        infer_clock: List = []
        trace.wrap_clocks(handler.session if nt > 1 else handler.server, "infer", infer_clock)
        spans: List = []
        timer.on = True
        serve(t_first + seconds, [], spans, timer)
        records["stages_ms"] = timer.spans_ms()
        # the handler's own host time: the request less the session's infer
        records["handler_ms"] = [1e3 * ((ti - t0) + (t1 - to))
                                 for (t0, t1), (ti, to) in zip(spans, infer_clock)]
        timer.on = False

        def profiled(n):
            def go():
                nonlocal k, pred
                n_run = min(n, len(frames) - k)
                for _ in range(n_run):
                    pred = handler(**frames[k])["pred"]
                    if k == sample:
                        kept[k] = keep.take(pred)
                    k += 1
                return n_run
            return go

        trace.profile_stretch(torch, profiled(1))  # starts the profiler; not read
        records["profile"] = trace.profile_stretch(torch, profiled(tr["profiled_requests"]))
        metrics = {}
    last = k - 1
    kept[last] = keep.take(pred)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    kept = {i: {n: np.asarray(v) if n == "pred" else v.float().cpu().numpy()
                for n, v in rec.items()} for i, rec in kept.items()}
    keep.latest = {}
    del handler, model, keep
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference's check, once the window has closed and the program is freed
    t_check = time.perf_counter()
    ref = judge.RefServing(cell.config, nt, seed, dev)
    numbers = judge.serving_numbers(ref, frames, kept)
    records["pooled_bytes"] = pooled_kernel_bytes(ref, cfg.compute_dtype)
    del ref
    return {"attempted": k - first, "failed": 0, "metrics": metrics, "records": records,
            "numbers": numbers, "memory_peak_bytes": peak,
            "check_s": time.perf_counter() - t_check, "checked": sorted(kept)}


def pooled_kernel_bytes(ref: "judge.RefServing", compute_dtype: str) -> int:
    """Kernel #1's least bytes per launch, from the reference's own presort
    of the rig: each in-grid point's order, rank and weight, each feature
    row once, the CSR starts and the pooled output (bf16 rows)."""
    cfg, pre = ref.cfg, ref.rig["lift_sorted"]
    num_cells = int(np.prod(cfg.grid.size))
    n_valid = int((pre["rk_pooled"] < num_cells).sum())
    N = cfg.data.num_cams
    h, w = (s // cfg.lss_downsample for s in cfg.data.input_size)
    C, elt = cfg.propagation.dim, 2 if compute_dtype == "bfloat16" else 4
    n_coarse = num_cells // int(np.prod(cfg.lss_feat_ds))
    return n_valid * (8 + elt) + N * h * w * C * elt + n_coarse * C * elt + (n_coarse + 1) * 4
