"""The lift's voxel pool over a fixed rig's presorted point stream, in
plain PyTorch: the fp32 `index_add_` version that stands in for the
port's hand-written kernel #1 (the pooled presorted lift)."""

from __future__ import annotations

import torch

# The presorted stream keeps its sorted prefix rounded up to this many rows
# (the JAX kernel's DMA chunk), as the JAX ops do.
PREFIX_ROUND = 256


def pooled_rank_remap(ranks, grid_size, ds, num_cells):
    """Flat voxel rank -> COARSE-MAJOR rank coarse_cell * R + fine_offset
    (R = dz*dy*dx), so each pooling group is contiguous in the sorted
    stream. Overflow ranks (>= num_cells) are kept."""
    nx, ny, nz = grid_size
    dz, dy, dx = ds
    r = ranks
    x = r % nx
    y = (r // nx) % ny
    zb = r // (nx * ny)
    z = zb % nz
    b = zb // nz
    coarse = ((b * (nz // dz) + z // dz) * (ny // dy) + y // dy) * (nx // dx) + x // dx
    off = ((z % dz) * dy + (y % dy)) * dx + (x % dx)
    return torch.where(r >= num_cells, r, coarse * (dz * dy * dx) + off)


def presorted_vals(depth, feat, order):
    """vals[p] = feat[order[p] // D] * w[order[p]] over the pixel-major
    point set; depth (B, N, D, h, w), feat (B, N, h, w, C) -> (P_cap, C)."""
    D = depth.shape[2]
    C = feat.shape[-1]
    order = order.long()
    wts = depth.permute(0, 1, 3, 4, 2).reshape(-1)
    return feat.reshape(-1, C)[order // D] * wts[order][:, None]


def bev_pool_pooled_plain(vals, rk_sorted, num_cells: int, pool_r: int, out_dtype):
    """Plain PyTorch version of the pool: fp32 index_add_ of the gathered
    rows `vals` (`presorted_vals`) into (num_cells + 1, C) with overflow
    rows in the last row, max over each group of pool_r fine cells, one
    cast."""
    acc = torch.zeros(num_cells + 1, vals.shape[1], dtype=torch.float32, device=vals.device)
    acc.index_add_(0, rk_sorted.long().clamp(max=num_cells), vals.float())
    return acc[:num_cells].reshape(num_cells // pool_r, pool_r, -1).amax(1).to(out_dtype)


def bev_pool_pooled(depth, feat, order, rk_sorted, num_cells: int, pool_r: int):
    """The presorted pooled lift's forward in plain PyTorch: the gather
    (`presorted_vals`) and `bev_pool_pooled_plain`."""
    if num_cells % pool_r:
        raise ValueError(f"num_cells {num_cells} is not a multiple of pool_r {pool_r}")
    return bev_pool_pooled_plain(presorted_vals(depth, feat, order), rk_sorted, num_cells,
                                 pool_r, feat.dtype)


def bev_pool_presorted_pooled(depth, feat, order, rk_pooled, grid_size, ds):
    """The presorted lift with the [dz,dy,dx] max-pool fused into the pool:
    depth (B, N, D, h, w) weights, feat (B, N, h, w, C), `order` /
    `rk_pooled` (coarse-major) from `LSSLift.precompute_sorted`
    -> (B, nz/dz, ny/dy, nx/dx, C)."""
    B, C = depth.shape[0], feat.shape[-1]
    nx, ny, nz = grid_size
    dz, dy, dx = ds
    out = bev_pool_pooled(depth, feat, order, rk_pooled, B * nz * ny * nx, dz * dy * dx)
    return out.reshape(B, nz // dz, ny // dy, nx // dx, C)
