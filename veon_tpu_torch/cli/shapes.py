"""Synthetic, geometrically sane example batches (counterpart of
`veon_tpu/cli/shapes.py`; the same numpy seeds give the same arrays).

The rig mimics nuScenes: N cameras ringed around the ego with horizontal
optical axes and nuScenes-like intrinsics, which sets the frustum's
in-grid fraction (~0.58) and so the lift's real workload.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import VeonConfig
from ..data.transforms import dav2_size

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
    """(B,F,N,Hd,Wd,3) DA-V2-normalized depth-tower input at the DA-V2
    lower-bound size."""
    dh, dw = dav2_size(*cfg.data.depth_input_size, target=cfg.data.dav2_target)
    shape = (B, cfg.num_temporal, cfg.data.num_cams, dh, dw, 3)
    return _to(np.random.default_rng(3).standard_normal(shape).astype(np.float32), device)


def example_batch_full(cfg: VeonConfig, B: int = 1, device="cuda"):
    """(imgs (B,F,N,H,W,3), depth_imgs (B,F,N,Hd,Wd,3), metas) as fp32
    tensors on `device`, for the pipeline with the depth tower."""
    imgs, _depth, metas = example_batch(cfg, B, device)
    return imgs, example_depth_imgs(cfg, B, device), metas


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)
