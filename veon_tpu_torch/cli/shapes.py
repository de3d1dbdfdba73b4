"""Synthetic, geometrically sane example batches (counterpart of
`veon_tpu/cli/shapes.py`; the same numpy seeds give the same arrays).

The rig mimics nuScenes: N cameras ringed around the ego with horizontal
optical axes and nuScenes-like intrinsics, which sets the frustum's
in-grid fraction (~0.58) and so the lift's real workload. The drive
(`example_drive`) moves that fixed rig along a seeded path at
nuScenes-like global coordinates for temporal serving.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import VeonConfig
from ..data.transforms import depth_tower_size

# cam->ego axis permutation for a camera looking along ego +x
_CAM_TO_EGO_BASE = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]],
                            dtype=np.float32)


def camera_ring(N: int, radius: float = 0.5, height: float = 1.5) -> np.ndarray:
    """(N, 4, 4) cam->ego SE(3): camera i yawed 2*pi*i/N around ego z."""
    out = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    for i in range(N):
        th = 2.0 * np.pi * i / N
        c, s = np.cos(th), np.sin(th)
        rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
        out[i, :3, :3] = rz @ _CAM_TO_EGO_BASE
        out[i, :3, 3] = (radius * c, radius * s, height)
    return out


def example_batch(cfg: VeonConfig, B: int = 1, device="cuda"):
    """(imgs (B,F,N,H,W,3), depth (B,F,N,H/2,W/2) metric U(1, 44) m, metas)
    as fp32 tensors on `device`. metas carry the rig (sensor2egos,
    ego2globals, intrins, post_rots, post_trans, bda) and the loss's
    (lidarego2global, prev_lidarego2global, cam2camego, camego2global)."""
    F, N = cfg.num_temporal, cfg.data.num_cams
    H, W = cfg.data.input_size
    rng = np.random.default_rng(0)

    def eye(n, *lead):
        return np.tile(np.eye(n, dtype=np.float32), lead + (1, 1))

    ring = camera_ring(N)
    s2e = np.broadcast_to(ring, (B, F, N, 4, 4)).copy()
    # frame f (older) sat 0.8*f m behind the key frame in global coords
    e2g = eye(4, B, F, N)
    for f in range(1, F):
        e2g[:, f, :, 0, 3] = -0.8 * f
    prev_e2g = eye(4, B, max(F - 1, 1))
    for f in range(1, F):
        prev_e2g[:, f - 1, 0, 3] = -0.8 * f
    # nuScenes-like intrinsics at input scale: fx = 0.79 W, principal point
    # 0.34 H from the top
    K = eye(3, B, F, N)
    K[..., 0, 0] = K[..., 1, 1] = 0.79 * W
    K[..., 0, 2] = W / 2.0
    K[..., 1, 2] = 0.34 * H
    metas = {"sensor2egos": s2e, "ego2globals": e2g, "intrins": K,
             "post_rots": eye(3, B, F, N), "post_trans": np.zeros((B, F, N, 3), np.float32),
             "bda": eye(3, B), "lidarego2global": eye(4, B),
             "prev_lidarego2global": prev_e2g,
             "cam2camego": np.broadcast_to(ring, (B, N, 4, 4)).copy(),
             "camego2global": eye(4, B, N)}
    imgs = rng.standard_normal((B, F, N, H, W, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 44.0, size=(B, F, N, H // 2, W // 2)).astype(np.float32)
    return _to(imgs, device), _to(depth, device), {k: _to(v, device) for k, v in metas.items()}


def example_depth_imgs(cfg: VeonConfig, B: int = 1, device="cuda"):
    """(B,F,N,Hd,Wd,3) N(0, 1) depth-tower input at the depth branch's size
    (`data/transforms.py` `depth_tower_size`): the DA-V2 lower-bound size,
    or depth_input_size for the midas-normalized zoe branch."""
    dh, dw = depth_tower_size(cfg.data)
    shape = (B, cfg.num_temporal, cfg.data.num_cams, dh, dw, 3)
    return _to(np.random.default_rng(3).standard_normal(shape).astype(np.float32), device)


def example_batch_full(cfg: VeonConfig, B: int = 1, device="cuda"):
    """(imgs (B,F,N,H,W,3), depth_imgs (B,F,N,Hd,Wd,3), metas) as fp32
    tensors on `device`, for the pipeline with the depth tower."""
    imgs, _depth, metas = example_batch(cfg, B, device)
    return imgs, example_depth_imgs(cfg, B, device), metas


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def drive_poses(frames: int, seed: int = 0) -> np.ndarray:
    """(frames, 4, 4) fp32 lidarego2global poses of a seeded drive: a start
    at nuScenes-like map coordinates (600-1800 m, as the city maps' ego
    translations), then 2-5 m forward and a -4..4 degree yaw change
    between frames."""
    rng = np.random.default_rng(seed)
    pos = np.array([rng.uniform(600.0, 1800.0), rng.uniform(600.0, 1800.0), 0.0])
    yaw = rng.uniform(-np.pi, np.pi)
    out = np.tile(np.eye(4), (frames, 1, 1))
    for f in range(frames):
        if f:
            yaw += np.deg2rad(rng.uniform(-4.0, 4.0))
            pos = pos + rng.uniform(2.0, 5.0) * np.array([np.cos(yaw), np.sin(yaw), 0.0])
        c, s = np.cos(yaw), np.sin(yaw)
        out[f, :3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
        out[f, :3, 3] = pos
    return out.astype(np.float32)


def example_drive(cfg: VeonConfig, frames: int, device="cuda", seed: int = 0):
    """(rig_metas, requests) of a synthetic drive with the fixed rig: the
    rig's single-frame metas (sensor2egos, ego2globals, intrins, post_rots,
    post_trans, bda) and, in time order, one request per frame: imgs
    (1, 1, N, H, W, 3) N(0, 1), depth_imgs (1, 1, N, Hd, Wd, 3) N(0, 1) at
    the depth branch's size (as `example_depth_imgs`), lidarego2global
    (1, 4, 4) from `drive_poses`."""
    N, (H, W) = cfg.data.num_cams, cfg.data.input_size
    dh, dw = depth_tower_size(cfg.data)
    _imgs, _depth, metas = example_batch(dataclasses.replace(cfg, num_temporal=1), device=device)
    rig = {k: metas[k] for k in ("sensor2egos", "ego2globals", "intrins", "post_rots",
                                 "post_trans", "bda")}
    poses = drive_poses(frames, seed)
    rng = np.random.default_rng(seed + 1)
    requests = [{"imgs": _to(rng.standard_normal((1, 1, N, H, W, 3), np.float32), device),
                 "depth_imgs": _to(rng.standard_normal((1, 1, N, dh, dw, 3), np.float32),
                                   device),
                 "lidarego2global": _to(poses[f:f + 1], device)} for f in range(frames)]
    return rig, requests


def temporal_batch(rig, requests):
    """The batched (B=1, F) form of `requests` (time order, the last one
    current): imgs / depth_imgs (1, F, N, ...) with frame 0 the newest, the
    rig broadcast over F (a presorted lift in `rig` is left out), lidarego2global of the newest and
    prev_lidarego2global (1, F-1, 4, 4) of the others, newest first."""
    newest_first = requests[::-1]
    F = len(requests)
    metas = {k: rig[k].expand((1, F) + rig[k].shape[2:]).contiguous()
             for k in ("sensor2egos", "ego2globals", "intrins", "post_rots", "post_trans")}
    metas["bda"] = rig["bda"]
    metas["lidarego2global"] = newest_first[0]["lidarego2global"]
    metas["prev_lidarego2global"] = torch.stack(
        [r["lidarego2global"] for r in newest_first[1:]], 1)
    return (torch.cat([r["imgs"] for r in newest_first], 1),
            torch.cat([r["depth_imgs"] for r in newest_first], 1), metas)
