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


def example_batch_full(cfg: VeonConfig, B: int = 1, device="cuda"):
    """(imgs (B,F,N,H,W,3), depth_imgs (B,F,N,Hd,Wd,3), metas) as fp32
    tensors on `device`; depth images at the DA-V2 lower-bound size."""
    F, N = cfg.num_temporal, cfg.data.num_cams
    H, W = cfg.data.input_size

    def eye(n, *lead):
        return np.tile(np.eye(n, dtype=np.float32), lead + (1, 1))

    s2e = np.broadcast_to(camera_ring(N), (B, F, N, 4, 4)).copy()
    e2g = eye(4, B, F, N)
    for f in range(1, F):
        e2g[:, f, :, 0, 3] = -0.8 * f
    K = eye(3, B, F, N)
    K[..., 0, 0] = K[..., 1, 1] = 0.79 * W
    K[..., 0, 2] = W / 2.0
    K[..., 1, 2] = 0.34 * H
    metas = {"sensor2egos": s2e, "ego2globals": e2g, "intrins": K,
             "post_rots": eye(3, B, F, N), "post_trans": np.zeros((B, F, N, 3), np.float32),
             "bda": eye(3, B)}
    imgs = np.random.default_rng(0).standard_normal((B, F, N, H, W, 3)).astype(np.float32)
    dh, dw = dav2_size(*cfg.data.depth_input_size, target=cfg.data.dav2_target)
    depth_imgs = np.random.default_rng(3).standard_normal((B, F, N, dh, dw, 3)).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return to(imgs), to(depth_imgs), {k: to(v) for k, v in metas.items()}
