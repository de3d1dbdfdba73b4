"""Presorted voxel pool with the fused output max-pool (counterpart of
`veon_tpu/ops/bev_pool.py` `pooled_rank_remap` and
`bev_pool_pallas_presorted_pooled`).

The per-frame lift is: gather + weight the rig's presorted point stream
(`presorted_vals`, torch ops), then the hand-written CUDA kernel
`csrc/bev_pool_pooled.cu` sums each fine cell and max-pools each group of
pool_r fine cells in one pass (`bev_pool_pooled`). On a CPU tensor the
wrapper runs the kernel's plain PyTorch version; on a CUDA tensor it
launches the kernel or raises. Forward only: the backward comes with the
training slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import native

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
    """Plain PyTorch version of the kernel: fp32 index_add_ into
    (num_cells + 1, C) with overflow rows in the last row, max over each
    group of pool_r fine cells, one cast."""
    acc = torch.zeros(num_cells + 1, vals.shape[1], dtype=torch.float32, device=vals.device)
    acc.index_add_(0, rk_sorted.long().clamp(max=num_cells), vals.float())
    return acc[:num_cells].reshape(num_cells // pool_r, pool_r, -1).amax(1).to(out_dtype)


def bev_pool_pooled(vals, rk_sorted, num_cells: int, pool_r: int, out_dtype):
    """(P_cap, C) rows sorted by coarse-major rank -> (num_cells // pool_r, C)
    pooled grid. Counts its kernel launches in `bev_pool_pooled.launches`."""
    if vals.requires_grad:
        raise NotImplementedError("bev_pool_pooled is forward-only")
    if vals.device.type == "cpu":
        return bev_pool_pooled_plain(vals, rk_sorted, num_cells, pool_r, out_dtype)
    if vals.device.type != "cuda" or rk_sorted.device != vals.device:
        raise ValueError(f"bev_pool_pooled: vals on {vals.device}, ranks on {rk_sorted.device}")
    if vals.dtype not in _DTYPE_CODE or out_dtype != vals.dtype:
        raise TypeError(f"bev_pool_pooled takes float32/bfloat16 vals and out of the "
                        f"same dtype, got {vals.dtype} -> {out_dtype}")
    if vals.dim() != 2 or rk_sorted.shape != vals.shape[:1] or rk_sorted.dtype != torch.int32:
        raise ValueError(f"bad shapes: vals {tuple(vals.shape)}, ranks "
                         f"{tuple(rk_sorted.shape)} {rk_sorted.dtype}")
    if num_cells % pool_r:
        raise ValueError(f"num_cells {num_cells} is not a multiple of pool_r {pool_r}")
    if not (vals.is_contiguous() and rk_sorted.is_contiguous()):
        raise ValueError("bev_pool_pooled needs contiguous vals and ranks")
    n_coarse = num_cells // pool_r
    out = torch.empty(n_coarse, vals.shape[1], dtype=out_dtype, device=vals.device)
    if vals.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("bev_pool_pooled needs 16-byte aligned rows")
    bounds = torch.arange(n_coarse + 1, dtype=torch.int32, device=vals.device) * pool_r
    starts = torch.searchsorted(rk_sorted, bounds, out_int32=True)
    lib = native.load("bev_pool_pooled")
    fn = lib.veon_bev_pool_pooled
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(vals.data_ptr(), rk_sorted.data_ptr(), starts.data_ptr(), out.data_ptr(),
             n_coarse, vals.shape[1], pool_r, _DTYPE_CODE[vals.dtype],
             torch.cuda.current_stream(vals.device).cuda_stream)
    if err:
        raise RuntimeError(f"bev_pool_pooled launch failed: cudaError {err}")
    bev_pool_pooled.launches += 1
    return out


bev_pool_pooled.launches = 0


def bev_pool_presorted_pooled(depth, feat, order, rk_pooled, grid_size, ds):
    """Accelerate-mode lift with the [dz,dy,dx] max-pool fused into the pool:
    depth (B, N, D, h, w) weights, feat (B, N, h, w, C), `order`/`rk_pooled`
    from `LSSLift.precompute_sorted` -> (B, nz/dz, ny/dy, nx/dx, C)."""
    B, C = depth.shape[0], feat.shape[-1]
    nx, ny, nz = grid_size
    dz, dy, dx = ds
    vals = presorted_vals(depth, feat, order)
    out = bev_pool_pooled(vals, rk_pooled, B * nz * ny * nx, dz * dy * dx, feat.dtype)
    return out.reshape(B, nz // dz, ny // dy, nx // dx, C)
