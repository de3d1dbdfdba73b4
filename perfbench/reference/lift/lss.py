"""Lift-Splat-Shoot view transform for a fixed rig (counterpart of
`veon_tpu/lift/lss.py` `min_pool_depth`, `two_hot_depth` and `LSSLift`'s
presorted lift): the rank sort of every frustum point precomputed once per
rig in the coarse-major layout whose pool fuses the output max-pool
(kernel #1 on the port's serving path), here through the plain fp32
`index_add_` pool (`ops/bev_pool.py`). Channel-last throughout."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..configs.base import GridConfig
from ..geometry.frustum import create_frustum, frustum_to_ego, voxel_ranks
from ..ops.bev_pool import PREFIX_ROUND, bev_pool_presorted_pooled, pooled_rank_remap

# The two-hot softmax clamps its logits at MIN_GAP (straight-through).
MIN_GAP = -16.0


def min_pool_depth(depth: torch.Tensor, downsample: int) -> torch.Tensor:
    """Min-pool metric depth with 0 treated as missing: (..., H, W) -> (..., H/ds, W/ds)."""
    *lead, H, W = depth.shape
    d = depth.reshape(*lead, H // downsample, downsample, W // downsample, downsample)
    d = torch.where(d == 0.0, torch.full_like(d, 1e5), d)
    return d.amin(dim=(-3, -1))


def _clamp_gap(gap):
    """The reference's straight-through clamp at MIN_GAP: the forward value
    is gap + (MIN_GAP - gap), rounded as such; the gradient is gap's."""
    return torch.where(gap >= MIN_GAP, gap, gap + (MIN_GAP - gap).detach())


def two_hot_depth(depth: torch.Tensor, grid: GridConfig, gamma: float = 4.0) -> torch.Tensor:
    """Metric depth (..., h, w) -> (..., D, h, w) soft distribution over the
    D depth bins: softmax of -gamma*|d - center| over D+1 bins (the far
    overflow bin dropped), logits clamped at MIN_GAP."""
    D = grid.num_depth_bins
    d0, _, dd = grid.depth
    centers = torch.arange(D + 1, dtype=depth.dtype, device=depth.device) * dd + (d0 + dd / 2)
    gap = _clamp_gap(-(depth[..., None] - centers).abs() * gamma)
    return torch.softmax(gap, dim=-1)[..., :D].movedim(-1, -3)


@dataclasses.dataclass(frozen=True)
class LSSLift:
    """(per-pixel features, depth, camera metas) -> pooled voxel grid."""

    grid: GridConfig
    input_size: Tuple[int, int]
    downsample: int = 16
    ds_feat: Tuple[int, int, int] = (2, 2, 2)  # (z, h, w) output max-pool

    @classmethod
    def from_config(cls, cfg):
        return cls(grid=cfg.grid, input_size=cfg.data.input_size,
                   downsample=cfg.lss_downsample, ds_feat=cfg.lss_feat_ds)

    def precompute_ranks(self, sensor2ego, cam2img, post_rot, post_tran, bda):
        """Flat voxel ranks (B, N, D, Hf, Wf) of every frustum point."""
        frustum = torch.from_numpy(create_frustum(self.grid, self.input_size, self.downsample))
        coor = frustum_to_ego(frustum.to(sensor2ego.device), sensor2ego, cam2img, post_rot,
                              post_tran, bda)
        return voxel_ranks(coor, self.grid)

    def precompute_sorted(self, sensor2ego, cam2img, post_rot, post_tran, bda
                          ) -> Dict[str, torch.Tensor]:
        """Fixed-rig precompute, once per rig: the coarse-major voxel ranks
        of every frustum point, their stable sort, and the sorted prefix
        holding every in-grid point (`PREFIX_ROUND`), as JAX's
        {"order", "rk_pooled", "ranks"} on the inputs' device."""
        num_cells = sensor2ego.shape[0] * int(np.prod(self.grid.size))
        ranks = pooled_rank_remap(self.precompute_ranks(sensor2ego, cam2img, post_rot,
                                                        post_tran, bda),
                                  self.grid.size, self.ds_feat, num_cells)
        rk = ranks.permute(0, 1, 3, 4, 2).reshape(-1)  # pixel-major points
        order = torch.argsort(rk, stable=True)  # jnp.argsort is stable
        n_valid = int((rk < num_cells).sum())
        p_cap = min(-(-n_valid // PREFIX_ROUND) * PREFIX_ROUND, rk.shape[0])
        order = order[:p_cap]
        return {"order": order.to(torch.int32), "rk_pooled": rk[order].to(torch.int32),
                "ranks": ranks}

    def lift_presorted(self, feat, depth, precomp):
        """feat (B, N, h, w, C), depth (B, N, D, h, w) two-hot weights ->
        (B, nz/dz, ny/dy, nx/dx, C), the max-pool fused into the pool."""
        return bev_pool_presorted_pooled(depth, feat, precomp["order"], precomp["rk_pooled"],
                                         self.grid.size, tuple(self.ds_feat))
