"""Lift-Splat-Shoot view transform (counterpart of `veon_tpu/lift/lss.py`):
`min_pool_depth`, `absolute_depth_from_bins`, `sid_depth_values` (the SID
frustum's planes), `two_hot_depth`, `one_hot_depth` and
`depth_bins_one_hot_gt` (the stage-1 losses' targets),
`banded_two_hot(_with_floor)` and
`LSSLift` with its three lifts:
  * `lift_presorted`: fixed rig, rank sort precomputed once (serving), in
    the coarse-major layout whose pool fuses the max-pool ("rk_pooled",
    kernel #1) or in the flat one ("rk_sorted", kernel #2, then the
    max-pool);
  * `lift_from_metric`: K-banded two-hot straight from metric depth plus
    the far-depth spray, ranks from per-pixel rays every call (training);
  * `__call__`: the reference formulation over the whole frustum.
Every pool routes by its tensors' device: the card's kernels (#1-#3) on
CUDA tensors, their plain versions on CPU tensors. The plain route is the
counterpart of JAX's `LSSLift(impl="scan")`, which only JAX's tests use.
Channel-last throughout.

Camera sharding (`cam_group`, JAX's `psum_axis`): each rank lifts its own
cameras and `_ds_pool` sums the ranks' full-resolution grids
(`collectives.cam_sum`) before the max-pool, since the max of a sum is
not the sum of the maxes where several cameras put mass in one coarse
cell. The fused-pool layout max-pools inside the kernel, before any sum
could run, so it is refused under a cam group. The sum runs in the grid's
dtype, as JAX's psum does: in bf16 each rank's partial grid is rounded
before the sum (`PERF.md` holds fp32 partial sums against it)."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..collectives import CamGroup, cam_sum
from ..configs.base import GridConfig
from ..geometry.frustum import create_frustum, frustum_to_ego, pixel_ray_geometry, voxel_ranks
from ..ops.bev_pool import (PREFIX_ROUND, bev_pool, bev_pool_banded, bev_pool_banded2,
                            bev_pool_presorted, bev_pool_presorted_pooled, pooled_rank_remap)

# The two-hot softmax clamps its logits at MIN_GAP (straight-through).
MIN_GAP = -16.0


def min_pool_depth(depth: torch.Tensor, downsample: int) -> torch.Tensor:
    """Min-pool metric depth with 0 treated as missing: (..., H, W) -> (..., H/ds, W/ds)."""
    *lead, H, W = depth.shape
    d = depth.reshape(*lead, H // downsample, downsample, W // downsample, downsample)
    d = torch.where(d == 0.0, torch.full_like(d, 1e5), d)
    return d.amin(dim=(-3, -1))


def absolute_depth_from_bins(bins: torch.Tensor, grid: GridConfig):
    """Bin distribution (..., K) -> (expected, hard-argmax) metric depth
    (`view_transformer_raw.py:376-391` get_absolute_depth), the bin centres
    arange(K)*dd + (d0 - dd/2); the argmax takes the first of a tie."""
    d0, _, dd = grid.depth
    centers = torch.arange(bins.shape[-1], dtype=bins.dtype, device=bins.device) * dd + (
        d0 - dd / 2)
    avg = (bins * centers).sum(-1)
    hard = torch.nn.functional.one_hot(bins.argmax(-1), bins.shape[-1]).to(bins.dtype)
    return avg, (hard * centers).sum(-1)


def sid_depth_values(grid: GridConfig) -> np.ndarray:
    """Spacing-Increasing Discretization plane depths (sid=True,
    `view_transformer_raw.py:107-112`): exp(log d0 + i/(D-1) log((d1-1)/d0)),
    computed in float64, then cast to float32."""
    D = grid.num_depth_bins
    d0, d1, _ = grid.depth
    i = np.arange(D, dtype=np.float64)
    return np.exp(np.log(d0) + i / (D - 1) * np.log((d1 - 1.0) / d0)).astype(np.float32)


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


def one_hot_depth(depth: torch.Tensor, grid: GridConfig) -> torch.Tensor:
    """Metric depth (..., h, w) -> (..., D, h, w) hard one-hot over the D
    bins: the nearest of D+1 centres (first on a tie, depth clipped at
    500 m), the far overflow bin dropped."""
    D = grid.num_depth_bins
    d0, _, dd = grid.depth
    centers = torch.arange(D + 1, dtype=depth.dtype, device=depth.device) * dd + (d0 + dd / 2)
    gap = -(torch.clamp(depth, max=500.0)[..., None] - centers).abs()
    onehot = torch.nn.functional.one_hot(gap.argmax(-1), D + 1).to(depth.dtype)[..., :D]
    return onehot.movedim(-1, -3)


def depth_bins_one_hot_gt(gt_depth: torch.Tensor, grid: GridConfig, downsample: int
                          ) -> torch.Tensor:
    """Sparse LiDAR depth (..., H, W) -> (..., H/ds, W/ds, D) one-hot bin
    targets: min-pooled (0 = missing), binned as (d - (d0 - dd)) / dd, out
    of range -> bin 0, which is dropped (all-zero rows: no GT there)."""
    D = grid.num_depth_bins
    d0, _, dd = grid.depth
    q = (min_pool_depth(gt_depth, downsample) - (d0 - dd)) / dd
    q = torch.where((q < D + 1) & (q >= 0.0), q, torch.zeros_like(q))
    return torch.nn.functional.one_hot(q.long(), D + 1).to(gt_depth.dtype)[..., 1:]


def banded_two_hot_with_floor(depth: torch.Tensor, grid: GridConfig, K: int,
                              gamma: float = 4.0):
    """The two-hot weights restricted to the K bins around the metric depth,
    exact because every bin farther out carries the clamped floor
    exp(MIN_GAP)/Z. depth (..., h, w) -> (weights (..., h, w, K), int32
    bins (..., h, w, K) in [0, D] (D = the dropped overflow bin), floor
    (..., h, w) = the weight of every out-of-band bin)."""
    D = grid.num_depth_bins
    d0, _, dd = grid.depth
    K = min(K, D + 1)
    i_near = torch.round((depth - (d0 + dd / 2)) / dd)  # half to even, as jnp.round
    i0 = torch.clamp(i_near - (K - 1) // 2, 0, D + 1 - K).to(torch.int32)
    bins = i0[..., None] + torch.arange(K, dtype=torch.int32, device=depth.device)
    centers = bins.to(depth.dtype) * dd + (d0 + dd / 2)
    e = torch.exp(_clamp_gap(-(depth[..., None] - centers).abs() * gamma))
    z = e.sum(-1, keepdim=True) + (D + 1 - K) * np.exp(MIN_GAP)
    # a tensor numerator: python_scalar / tensor would multiply by 1/z
    return e / z, bins, z.new_tensor(np.exp(MIN_GAP)) / z[..., 0]


def banded_two_hot(depth: torch.Tensor, grid: GridConfig, K: int, gamma: float = 4.0):
    """`banded_two_hot_with_floor` without the floor: (weights, bins)."""
    w, bins, _ = banded_two_hot_with_floor(depth, grid, K, gamma)
    return w, bins


@dataclasses.dataclass(frozen=True)
class LSSLift:
    """(per-pixel features, depth, camera metas) -> pooled voxel grid."""

    grid: GridConfig
    input_size: Tuple[int, int]
    downsample: int = 16
    ds_feat: Tuple[int, int, int] = (2, 2, 2)  # (z, h, w) output max-pool
    # capped sorted prefix of the full-frustum pool: 1.0 is lossless, a
    # smaller cap drops the sorted tail once the in-grid count exceeds it
    valid_cap: float = 1.0
    # bins per pixel of the banded lift: 17 = 2*|MIN_GAP|/(gamma*dd) + 1
    # covers every unclamped bin at the default 0.5 m bins
    band_k: int = 17
    # far-depth spray: where the floor weight of a pixel reaches spray_eps
    # (predicted depth past ~46 m) a second stream deposits it on all D bins
    far_spray: bool = True
    spray_eps: float = 1e-6
    # optional capped prefix of the spray stream (None = lossless)
    spray_cap: Optional[float] = None
    # camera sharding: the ranks whose lifted grids `_ds_pool` sums
    cam_group: Optional[CamGroup] = None

    @classmethod
    def from_config(cls, cfg, **overrides):
        kw = dict(grid=cfg.grid, input_size=cfg.data.input_size,
                  downsample=cfg.lss_downsample, ds_feat=cfg.lss_feat_ds)
        kw.update(overrides)
        return cls(**kw)

    @property
    def frustum(self) -> np.ndarray:
        return create_frustum(self.grid, self.input_size, self.downsample)

    def _num_cells(self, batch: int) -> int:
        return batch * int(np.prod(self.grid.size))

    def precompute_ranks(self, sensor2ego, cam2img, post_rot, post_tran, bda):
        """Flat voxel ranks (B, N, D, Hf, Wf) of every frustum point."""
        frustum = torch.from_numpy(self.frustum).to(sensor2ego.device)
        coor = frustum_to_ego(frustum, sensor2ego, cam2img, post_rot, post_tran, bda)
        return voxel_ranks(coor, self.grid)

    def precompute_sorted(self, sensor2ego, cam2img, post_rot, post_tran, bda,
                          fuse_ds_pool: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """Fixed-rig accelerate precompute, once per rig: voxel ranks of
        every frustum point, their stable sort, and the sorted prefix
        holding every in-grid point (`PREFIX_ROUND`). fuse_ds_pool (default:
        whenever valid, i.e. without a cam group and with a max-pool) picks
        the coarse-major layout that kernel #1 pools and max-pools in one
        pass; else the flat one. The dict's key names the layout, as JAX's:
        {"order", "rk_pooled" or "rk_sorted", "ranks"} on the inputs'
        device."""
        num_cells = self._num_cells(sensor2ego.shape[0])
        if fuse_ds_pool is None:
            fuse_ds_pool = self.cam_group is None and int(np.prod(self.ds_feat)) > 1
        if fuse_ds_pool and self.cam_group is not None:
            raise ValueError(
                "fuse_ds_pool under camera sharding: the cam-axis psum needs "
                "the full-resolution grid before the max-pool")
        ranks = self.precompute_ranks(sensor2ego, cam2img, post_rot, post_tran, bda)
        if fuse_ds_pool:
            ranks = pooled_rank_remap(ranks, self.grid.size, self.ds_feat, num_cells)
        rk = ranks.permute(0, 1, 3, 4, 2).reshape(-1)  # pixel-major points
        order = torch.argsort(rk, stable=True)  # jnp.argsort is stable
        n_valid = int((rk < num_cells).sum())
        p_cap = min(-(-n_valid // PREFIX_ROUND) * PREFIX_ROUND, rk.shape[0])
        order = order[:p_cap]
        return {"order": order.to(torch.int32),
                "rk_pooled" if fuse_ds_pool else "rk_sorted": rk[order].to(torch.int32),
                "ranks": ranks}

    def lift_presorted(self, feat, depth, precomp):
        """feat (B, N, h, w, C), depth (B, N, D, h, w) two-hot weights ->
        (B, nz/dz, ny/dy, nx/dx, C): a "rk_pooled" precompute through kernel
        #1 (the max-pool fused), a "rk_sorted" one through kernel #2 and
        `_ds_pool`."""
        if "rk_pooled" in precomp:
            assert self.cam_group is None, "pooled presorted lift cannot feed a cam-axis psum"
            return bev_pool_presorted_pooled(depth, feat, precomp["order"], precomp["rk_pooled"],
                                             precomp["ranks"], self.grid.size,
                                             tuple(self.ds_feat))
        return self._ds_pool(bev_pool_presorted(depth, feat, precomp["order"],
                                                precomp["rk_sorted"], precomp["ranks"],
                                                self.grid.size))

    def __call__(self, feat, depth, sensor2ego, cam2img, post_rot, post_tran, bda,
                 ranks=None):
        """The reference lift over the whole frustum: feat (B, N, h, w, C),
        depth (B, N, D, h, w) bin weights -> (B, nz/dz, ny/dy, nx/dx, C)."""
        if ranks is None:
            ranks = self.precompute_ranks(sensor2ego, cam2img, post_rot, post_tran, bda)
        return self._ds_pool(bev_pool(depth, feat, ranks, self.grid.size, self.valid_cap))

    def _ds_pool(self, vox):
        """Under a cam group the sum of the ranks' full-resolution grids,
        then the [dz, dy, dx] output max-pool; `amax` splits the gradient of
        a tie evenly, as jnp.max does (the sparse grid has many zero ties)."""
        if self.cam_group is not None:
            vox = cam_sum(vox, self.cam_group)
        dz, dh, dw = self.ds_feat
        if (dz, dh, dw) == (1, 1, 1):
            return vox
        B, Z, Y, X, C = vox.shape
        vox = vox.reshape(B, Z // dz, dz, Y // dh, dh, X // dw, dw, C)
        return vox.amax(dim=(2, 4, 6))

    def banded_streams(self, metric_depth, sensor2ego, cam2img, post_rot, post_tran, bda):
        """The point streams of the banded lift: (weights, ranks) of the K
        in-band bins of every pixel (B, N, h, w, K) and, with the far-depth
        spray, (spray_w, spray_ranks) over all D bins (B, N, h, w, D), else
        (None, None). Ranks are int32 with overflow = B*nz*ny*nx."""
        D = self.grid.num_depth_bins
        d0, _, dd = self.grid.depth
        # exact only if every out-of-band bin is clamped
        k_needed = 2 * int(math.ceil(16.0 / (4.0 * dd))) + 1
        if self.band_k < min(k_needed, D + 1):
            raise ValueError(f"band_k={self.band_k} too narrow for depth bin width {dd}: "
                             f"the two-hot clamp radius spans {k_needed} bins")
        weights, bins, floor = banded_two_hot_with_floor(metric_depth, self.grid, self.band_k)
        dirs, origin = pixel_ray_geometry(self.input_size, self.downsample, sensor2ego,
                                          cam2img, post_rot, post_tran, bda)

        def ranks_at(depth_vals):
            """Ranks of the ray points at the given bin depths (..., h, w, K)."""
            coor = (depth_vals[..., None] * dirs[:, :, :, :, None, :]
                    + origin[:, :, None, None, None, :])
            return voxel_ranks(coor, self.grid)

        dev = metric_depth.device
        overflow = torch.full((), self._num_cells(metric_depth.shape[0]), dtype=torch.int32,
                              device=dev)
        # frustum planes sit at the bin lower edges d0 + k*dd; the overflow
        # bin D (dropped by the reference) goes to the overflow cell
        ranks = torch.where(bins >= D, overflow, ranks_at(bins.float() * dd + d0))
        if not (self.far_spray and self.band_k < D + 1):
            return weights, ranks, None, None
        spray_px = floor >= self.spray_eps  # (B, N, h, w)
        spray_floor = torch.where(spray_px, floor, torch.zeros_like(floor))
        shape = metric_depth.shape + (D,)
        plane = torch.arange(D, dtype=torch.float32, device=dev) * dd + d0
        spray_ranks = torch.where(spray_px[..., None], ranks_at(plane.expand(shape)), overflow)
        return (weights - spray_floor[..., None], ranks, spray_floor[..., None].expand(shape),
                spray_ranks)

    def lift_from_metric(self, feat, metric_depth, sensor2ego, cam2img, post_rot,
                         post_tran, bda):
        """Banded lift straight from metric depth, exact two-hot semantics:
        the main stream carries the K in-band weights of every pixel; where
        a pixel's floor weight reaches spray_eps, the spray stream deposits
        it on all D bins and the in-band weights give it up. feat
        (B, N, h, w, C), metric_depth (B, N, h, w) at the feature grid ->
        (B, nz/dz, ny/dy, nx/dx, C)."""
        weights, ranks, spray_w, spray_ranks = self.banded_streams(
            metric_depth, sensor2ego, cam2img, post_rot, post_tran, bda)
        dt = feat.dtype
        if spray_w is None:
            vox = bev_pool_banded(weights.to(dt), feat, ranks, self.grid.size)
        else:
            vox = bev_pool_banded2(weights.to(dt), feat, ranks, spray_w.to(dt), spray_ranks,
                                   self.grid.size, self.spray_cap)
        return self._ds_pool(vox)
