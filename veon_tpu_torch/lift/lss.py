"""Lift-Splat-Shoot view transform, fixed-rig presorted form (counterpart
of `veon_tpu/lift/lss.py`: `min_pool_depth`, `two_hot_depth` and the
fused-pool layout of `LSSLift.precompute_sorted` / `lift_presorted`).
Channel-last throughout."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..configs.base import GridConfig
from ..geometry.frustum import create_frustum, frustum_to_ego, voxel_ranks
from ..ops.bev_pool import bev_pool_presorted_pooled, pooled_rank_remap

# The sorted prefix is the exact in-grid point count rounded up to this
# many rows (the JAX kernel's DMA chunk), so it holds every in-grid point;
# the pad rows carry overflow ranks >= num_cells, which lie past the last
# coarse cell's row range and are never pooled.
PREFIX_ROUND = 256


def min_pool_depth(depth: torch.Tensor, downsample: int) -> torch.Tensor:
    """Min-pool metric depth with 0 treated as missing: (..., H, W) -> (..., H/ds, W/ds)."""
    *lead, H, W = depth.shape
    d = depth.reshape(*lead, H // downsample, downsample, W // downsample, downsample)
    d = torch.where(d == 0.0, torch.full_like(d, 1e5), d)
    return d.amin(dim=(-3, -1))


def two_hot_depth(depth: torch.Tensor, grid: GridConfig, gamma: float = 4.0) -> torch.Tensor:
    """Metric depth (..., h, w) -> (..., D, h, w) soft distribution over the
    D depth bins: softmax of -gamma*|d - center| over D+1 bins (the far
    overflow bin dropped), logits clamped at -16."""
    D = grid.num_depth_bins
    d0, _, dd = grid.depth
    centers = torch.arange(D + 1, dtype=depth.dtype, device=depth.device) * dd + (d0 + dd / 2)
    gap = -(depth[..., None] - centers).abs() * gamma
    min_gap = -16.0
    # the reference's straight-through clamp, whose forward value is
    # gap + (min_gap - gap), rounded as such
    gap = torch.where(gap >= min_gap, gap, gap + (min_gap - gap))
    return torch.softmax(gap, dim=-1)[..., :D].movedim(-1, -3)


@dataclasses.dataclass(frozen=True)
class LSSLift:
    """(per-pixel features, two-hot depth, presorted rig) -> pooled voxel grid."""

    grid: GridConfig
    input_size: Tuple[int, int]
    downsample: int = 16
    ds_feat: Tuple[int, int, int] = (2, 2, 2)  # (z, h, w) output max-pool

    @classmethod
    def from_config(cls, cfg):
        return cls(grid=cfg.grid, input_size=cfg.data.input_size,
                   downsample=cfg.lss_downsample, ds_feat=cfg.lss_feat_ds)

    @property
    def frustum(self) -> np.ndarray:
        return create_frustum(self.grid, self.input_size, self.downsample)

    def precompute_sorted(self, sensor2ego, cam2img, post_rot, post_tran, bda
                          ) -> Dict[str, torch.Tensor]:
        """Fixed-rig accelerate precompute, once per rig: coarse-major voxel
        ranks of every frustum point, their stable sort, and the sorted
        prefix holding every in-grid point (`PREFIX_ROUND`).
        Returns {"order", "rk_pooled", "ranks"} on the inputs' device."""
        B = sensor2ego.shape[0]
        num_cells = B * int(np.prod(self.grid.size))
        if int(np.prod(self.ds_feat)) == 1:
            raise NotImplementedError("only the fused-pool layout (ds_feat != 1) is ported")
        frustum = torch.from_numpy(self.frustum).to(sensor2ego.device)
        coor = frustum_to_ego(frustum, sensor2ego, cam2img, post_rot, post_tran, bda)
        ranks = pooled_rank_remap(voxel_ranks(coor, self.grid), self.grid.size,
                                  self.ds_feat, num_cells)
        rk = ranks.permute(0, 1, 3, 4, 2).reshape(-1)  # pixel-major points
        order = torch.argsort(rk, stable=True)  # jnp.argsort is stable
        n_valid = int((rk < num_cells).sum())
        p_cap = min(-(-n_valid // PREFIX_ROUND) * PREFIX_ROUND, rk.shape[0])
        order = order[:p_cap]
        return {"order": order.to(torch.int32), "rk_pooled": rk[order].to(torch.int32),
                "ranks": ranks}

    def lift_presorted(self, feat, depth, precomp):
        """feat (B, N, h, w, C), depth (B, N, D, h, w) two-hot weights ->
        (B, nz/dz, ny/dy, nx/dx, C)."""
        return bev_pool_presorted_pooled(depth, feat, precomp["order"], precomp["rk_pooled"],
                                         self.grid.size, tuple(self.ds_feat))
