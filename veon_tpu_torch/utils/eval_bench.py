"""The `test` loop timed on a synthetic shard (counterpart of
`veon_tpu/utils/eval_bench.py`, `benchmark --eval`).

The reference measures inference fps inside its test loop: upload,
forward and grid readback per sample, then the confusion histogram and
mIoU at the end. Four legs on a `loader_bench.make_frames` shard:

1. device path: batches preloaded in host memory, then per frame the
   host-to-device copy, full forward, fusion rule and uint8 grid readback
   (the loader left out); host clock per frame, median reported, and the
   medians of its three stages, each ended by a synchronise;
   1b. the same frames pipelined two deep (`evaluate_occ`'s pipeline=2:
   frame N+1 enqueued before frame N's grid is read);
2. e2e: the shard through the real DataLoader via `evaluate_occ`, exactly
   what `test` runs; fps from its own "inference done" line;
3. hist: `dataset.evaluate` over the grids (confusion histogram + mIoU),
   ms per frame.

Usage: python -m veon_tpu_torch.utils.eval_bench [--frames 12] [--preset veon_b]
       [--dtype bfloat16] [--workers 2] [--mode thread] [--raw-uint8] [--pipeline 1]
Prints one JSON line, with the device's name.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import tempfile
import time

import torch

from .. import resolve_device
from ..cli.main import build_model_and_params, occ_predictor
from ..configs import presets
from ..data.loader import DataLoader
from ..data.nuscenes import NuScenesOccDataset, load_infos
from ..train.loop import _to_device, evaluate_occ
from .loader_bench import make_frames


class _Preloaded:
    """Host batches already in memory, as a loader over `dataset`."""

    def __init__(self, batches, dataset):
        self.batches, self.dataset = batches, dataset

    def __iter__(self):
        return (dict(b) for b in self.batches)


def _loop_fps(predict, loader, ov_weight, pipeline, dev, lines=None) -> float:
    """Frames/s of `evaluate_occ` over `loader`, from the loop's own
    "inference done" line: the wall clock around it also pays
    `dataset.evaluate`, which leg 3 reports."""
    lines = [] if lines is None else lines
    evaluate_occ(predict, loader, ov_weight, log_fn=lines.append, pipeline=pipeline, device=dev)
    m = re.search(r"done: (\d+) samples in ([0-9.]+)s", lines[-1])
    return int(m.group(1)) / max(float(m.group(2)), 1e-9)


def run(n_frames: int = 12, preset: str = "veon_b", dtype: str = "bfloat16", workers: int = 2,
        mode: str = "thread", keep=None, raw_uint8: bool = False, pipeline: int = 1,
        device="cuda"):
    """Time the legs and print (and return) one JSON record."""
    dev = resolve_device(device)
    fn = getattr(presets, preset)
    try:
        cfg = fn(compute_dtype=dtype)
    except TypeError:  # presets that own their dtype (veon_l, the tiny ones)
        cfg = fn()
    root = keep or tempfile.mkdtemp(prefix="veon_eval_bench_")
    try:
        pkl = make_frames(root, n_frames, hw=tuple(cfg.data.src_size), grid_shape=cfg.grid.size)
        ds = NuScenesOccDataset(infos=load_infos(pkl), data_cfg=cfg.data, grid=cfg.grid,
                                num_temporal=cfg.num_temporal, is_train=False, data_root=root,
                                load_lidar_depth=False, raw_uint8=raw_uint8)
        loader = DataLoader(ds, batch_size=1, shuffle=False, num_workers=workers,
                            drop_last=False, mode=mode)
        model, _tower, ovw, membership, _extras = build_model_and_params(cfg, device=dev)
        predict = occ_predictor(model, membership, cfg.data.depth_norm_method, raw_uint8)

        def upload(batch, pinned):
            return (_to_device(batch["imgs"], dev, pinned),
                    _to_device(batch.get("depth_imgs", batch.get("depth_preds")), dev, pinned),
                    _to_device(batch["metas"], dev, pinned))

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize()

        # --- leg 1: device path (loader excluded) ---------------------
        host_batches = []
        for batch in loader:
            batch.pop("token", None)
            host_batches.append(batch)
        t0 = time.perf_counter()
        predict(*upload(host_batches[0], None), ovw).cpu()  # cold: cuDNN plans, allocator
        first_s = time.perf_counter() - t0
        per_frame, results = [], []
        stages = {"h2d": [], "forward": [], "readback": []}  # host clock, synchronised
        for batch in host_batches:
            t0 = time.perf_counter()
            args = upload(batch, None)
            sync()
            t1 = time.perf_counter()
            pred = predict(*args, ovw).to(torch.uint8)
            sync()
            t2 = time.perf_counter()
            pred = pred.cpu().numpy()
            t3 = time.perf_counter()
            per_frame.append(t3 - t0)
            for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
                stages[k].append(dt * 1e3)
            results.extend(list(pred))

        def median(v):
            return sorted(v)[len(v) // 2]

        med = median(per_frame)

        # --- leg 1b: the same frames two in flight ---------------------
        preloaded = _Preloaded(host_batches, ds)
        pipe_fps = _loop_fps(predict, preloaded, ovw, 2, dev)

        # --- leg 3: hist + mIoU over the grids -------------------------
        t0 = time.perf_counter()
        metrics = ds.evaluate(results)
        hist_ms = (time.perf_counter() - t0) / len(results) * 1e3

        # --- leg 2: e2e, exactly `test` -------------------------------
        lines = []
        e2e_fps = _loop_fps(predict, loader, ovw, pipeline, dev, lines)

        out = {
            "metric": f"{preset}_eval_loop_frames_per_sec",
            "value": 1.0 / med,
            "unit": "frames/s",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "detail": {
                "device_path_ms_per_frame": med * 1e3,
                "device_path_fps": 1.0 / med,
                "h2d_ms": median(stages["h2d"]),
                "forward_ms": median(stages["forward"]),
                "readback_ms": median(stages["readback"]),
                "pipelined_fps": pipe_fps,
                "e2e_fps": e2e_fps,
                "e2e_inference_line": lines[0],
                "hist_ms_per_frame": hist_ms,
                "miou": float(metrics["mIoU"]),
                "n_frames": n_frames,
                "dtype": cfg.compute_dtype,
                "workers": workers,
                "mode": mode,
                "raw_uint8": raw_uint8,
                "pipeline": pipeline,
                "first_frame_s": first_s,
            },
        }
        print(json.dumps(out), flush=True)
        return out
    finally:
        if keep is None:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--preset", default="veon_b")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--mode", choices=("thread", "process"), default="thread")
    ap.add_argument("--keep", default=None)
    ap.add_argument("--raw-uint8", action="store_true",
                    help="uint8 frames normalized on the device")
    ap.add_argument("--pipeline", type=int, default=1,
                    help="predictions in flight in the e2e leg (evaluate_occ)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.frames, args.preset, args.dtype, args.workers, args.mode, args.keep,
        raw_uint8=args.raw_uint8, pipeline=args.pipeline, device=args.device)
