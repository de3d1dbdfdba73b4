"""Input-pipeline throughput: can the loader feed the model? (counterpart
of `veon_tpu/utils/loader_bench.py`)

`make_frames` writes N synthetic nuScenes-resolution (900x1600) 6-camera
frames as real JPEGs, one shared 200x200x16 label file and an infos pkl;
`loader_fps` measures DataLoader frames/s through the real
NuScenesOccDataset pipeline (JPEG decode, resize, normalization, meta
assembly) at a worker count and mode. It is host work: no device.

Usage: python -m veon_tpu_torch.utils.loader_bench [--frames 100] [--workers 4]
       [--size 900 1600] [--mode thread|process] [--scaling] [--raw-uint8] [--keep DIR]
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import tempfile
import time

import numpy as np

from ..configs import presets
from ..data.loader import DataLoader
from ..data.nuscenes import NuScenesOccDataset, load_infos


def make_frames(root: str, n_frames: int, hw=(900, 1600), quality: int = 90,
                grid_shape=(200, 200, 16)):
    """A shard of n_frames six-camera frames under root, one scene: JPEGs
    of hw (48 distinct, hard-linked across frames), the nuScenes-like rig,
    one seeded label file of grid_shape for every frame. Returns the infos
    pkl path."""
    from PIL import Image

    cams = ["CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
            "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT"]
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    # realistic JPEG entropy: smooth gradients + noise (a pure-noise image
    # decodes slower than real photos; pure-flat decodes faster)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    base = (127 + 60 * np.sin(xx / 97.0) * np.cos(yy / 53.0)).astype(np.float32)
    infos = []
    img_cache = {}
    for si in range(n_frames):
        cams_d = {}
        for ci, cam in enumerate(cams):
            p = os.path.join(root, "imgs", f"s{si}_{cam}.jpg")
            key = (si % 8, ci)  # 48 distinct JPEGs, reused across frames
            if key not in img_cache:
                noise = rng.normal(0, 12, size=(h, w, 3))
                img = np.clip(base[..., None] + noise + ci * 7, 0, 255)
                fp = os.path.join(root, "imgs", f"u{key[0]}_{ci}.jpg")
                Image.fromarray(img.astype(np.uint8)).save(fp, quality=quality)
                img_cache[key] = fp
            if not os.path.exists(p):
                os.link(img_cache[key], p)
            th = ci * np.pi / 3
            q = [np.cos(th / 2), 0.0, 0.0, np.sin(th / 2)]
            cams_d[cam] = {
                "data_path": p,
                "cam_intrinsic": [[1266.0, 0, 800], [0, 1266.0, 477], [0, 0, 1]],
                "sensor2ego_rotation": q,
                "sensor2ego_translation": [0.0, 0.0, 1.5],
                "ego2global_rotation": [1.0, 0, 0, 0],
                "ego2global_translation": [si * 1.0, 0.0, 0.0],
            }
        infos.append({
            "token": f"tok{si}",
            "timestamp": si,
            "scene_token": "scene0",
            "occ_path": os.path.join(root, "occ"),
            "ego2global_rotation": [1.0, 0, 0, 0],
            "ego2global_translation": [si * 1.0, 0.0, 0.0],
            "cams": cams_d,
        })
    occ_dir = os.path.join(root, "occ")
    os.makedirs(occ_dir, exist_ok=True)
    rng2 = np.random.default_rng(1)
    np.savez(os.path.join(occ_dir, "labels.npz"),
             semantics=rng2.integers(0, 18, size=grid_shape).astype(np.uint8),
             mask_lidar=np.ones(grid_shape, np.uint8),
             mask_camera=np.ones(grid_shape, np.uint8))
    pkl = os.path.join(root, "infos.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"infos": infos, "metadata": {"version": "bench"}}, f)
    return pkl


def loader_fps(pkl: str, root: str, workers: int = 4, mode: str = "thread",
               raw_uint8: bool = False, num_temporal: int = 1) -> float:
    """Frames/s of a VEON-B eval loader over the shard `pkl`, after one
    warm batch (pool start-up, file cache)."""
    cfg = presets.veon_b(num_temporal=num_temporal)
    ds = NuScenesOccDataset(infos=load_infos(pkl), data_cfg=cfg.data, grid=cfg.grid,
                            num_temporal=num_temporal, is_train=False, data_root=root,
                            load_lidar_depth=False, raw_uint8=raw_uint8)
    loader = DataLoader(ds, batch_size=1, shuffle=False, num_workers=workers,
                        drop_last=False, mode=mode)
    next(iter(loader))
    t0 = time.perf_counter()
    n = 0
    for batch in loader:
        n += batch["imgs"].shape[0]
    dt = time.perf_counter() - t0
    fps = n / dt
    print(f"loader: {n} frames in {dt:.1f}s = {fps:.2f} frames/s ({workers} {mode} workers, "
          f"{os.cpu_count()} cores{', raw-uint8' if raw_uint8 else ''}) — "
          f"{fps * 6:.1f} JPEG decodes+transforms/s")
    return fps


def run(n_frames=100, workers=4, hw=(900, 1600), keep=None, num_temporal=1, mode="thread",
        raw_uint8=False):
    """Write a shard of n_frames and return the loader's frames/s on it."""
    root = keep or tempfile.mkdtemp(prefix="veon_loader_bench_")
    try:
        t0 = time.perf_counter()
        pkl = make_frames(root, n_frames, hw)
        print(f"fixture: {n_frames} frames x 6 cams @ {hw} in {time.perf_counter() - t0:.1f}s")
        return loader_fps(pkl, root, workers, mode, raw_uint8, num_temporal)
    finally:
        if keep is None:
            shutil.rmtree(root, ignore_errors=True)


def scaling_table(n_frames=60, hw=(900, 1600), worker_counts=(1, 2, 4),
                  modes=("thread", "process"), raw_uint8=False):
    """Frames/s per (mode, workers) on one shard."""
    root = tempfile.mkdtemp(prefix="veon_loader_bench_")
    try:
        pkl = make_frames(root, n_frames, hw)
        rows = {(mode, w): loader_fps(pkl, root, w, mode, raw_uint8)
                for mode in modes for w in worker_counts}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("\nmode      workers  frames/s")
    for (mode, w), fps in rows.items():
        print(f"{mode:<9} {w:>7}  {fps:.3f}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--size", type=int, nargs=2, default=(900, 1600))
    ap.add_argument("--num-temporal", type=int, default=1)
    ap.add_argument("--mode", choices=("thread", "process"), default="thread")
    ap.add_argument("--scaling", action="store_true",
                    help="print the (mode x workers) scaling table")
    ap.add_argument("--raw-uint8", action="store_true",
                    help="uint8 samples (no host normalization)")
    ap.add_argument("--keep", default=None)
    args = ap.parse_args()
    if args.scaling:
        scaling_table(args.frames, tuple(args.size), raw_uint8=args.raw_uint8)
    else:
        run(args.frames, args.workers, tuple(args.size), args.keep, args.num_temporal,
            args.mode, raw_uint8=args.raw_uint8)
