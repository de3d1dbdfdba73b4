"""Voxel pools over sorted point streams (counterpart of
`veon_tpu/ops/bev_pool.py`).

Every pool here sums the weighted feature rows of the lift's points, sorted
by voxel rank, per cell in one pass of a hand-written CUDA kernel:
  * `bev_pool_pooled` (`csrc/bev_pool_pooled.cu`, TPU kernel
    `_bev_pool_block_kernel_pooled` and its gather): one presorted
    coarse-major stream whose rows the kernel gathers and weights itself,
    fine-cell sums max-pooled per group of pool_r cells (serving);
  * `bev_pool_sorted` (`csrc/bev_pool_sorted.cu`, TPU kernel
    `_bev_pool_block_kernel`): one stream gathered and weighted by torch
    ops, per-cell sums (the full-frustum and K-banded lifts, and the
    pooled op's backward);
  * `bev_pool_sorted2` (same source, TPU kernel `_bev_pool_block_kernel2`):
    two streams summed into one grid (the banded lift with its far-depth
    spray, the training default).
On a CPU tensor a wrapper runs its kernel's plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. Each wrapper counts its launches
in `<wrapper>.launches`.

The differentiable ops (`bev_pool`, `bev_pool_banded`, `bev_pool_banded2`,
`bev_pool_presorted_pooled`) are `torch.autograd.Function`s whose backwards
are the JAX package's gather adjoints, in torch ops.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import native

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_POOLED_ARGTYPES = (ctypes.c_void_p,) * 2 + (ctypes.c_longlong,) * 2 + (ctypes.c_void_p,) * 5 + \
    (ctypes.c_int,) * 5 + (ctypes.c_void_p,)

# A capped stream (`valid_cap`) keeps its sorted prefix rounded up to this
# many rows (the JAX kernel's DMA chunk), as the JAX ops do.
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


def _check_stream(name, vals, rk, device, dtype):
    if vals.device != device or rk.device != device:
        raise ValueError(f"{name}: vals on {vals.device}, ranks on {rk.device}, expected {device}")
    if vals.dtype != dtype or dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32/bfloat16 vals of one dtype, got {vals.dtype}")
    if vals.dim() != 2 or rk.shape != vals.shape[:1] or rk.dtype != torch.int32:
        raise ValueError(f"{name}: bad shapes: vals {tuple(vals.shape)}, ranks "
                         f"{tuple(rk.shape)} {rk.dtype}")
    if not (vals.is_contiguous() and rk.is_contiguous()):
        raise ValueError(f"{name} needs contiguous vals and ranks")
    if vals.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned rows")


def _cell_starts(rk_sorted, num_cells: int, step: int = 1):
    """CSR row offsets: the first row of every cell (every `step`-th cell)
    and the end of the last, by binary search of the sorted ranks."""
    bounds = torch.arange(0, num_cells + 1, step, dtype=torch.int32, device=rk_sorted.device)
    return torch.searchsorted(rk_sorted, bounds, out_int32=True)


def bev_pool_pooled_plain(vals, rk_sorted, num_cells: int, pool_r: int, out_dtype):
    """Plain PyTorch version of the pool: fp32 index_add_ of the gathered
    rows `vals` (`presorted_vals`) into (num_cells + 1, C) with overflow
    rows in the last row, max over each group of pool_r fine cells, one
    cast."""
    acc = torch.zeros(num_cells + 1, vals.shape[1], dtype=torch.float32, device=vals.device)
    acc.index_add_(0, rk_sorted.long().clamp(max=num_cells), vals.float())
    return acc[:num_cells].reshape(num_cells // pool_r, pool_r, -1).amax(1).to(out_dtype)


def _weight_strides(depth):
    """(weights, pixel stride, bin stride), strides in elements, such that
    the weight of point pix * D + d lies pix * pixel stride + d * bin stride
    elements past weights' data pointer. The sliced softmax view of `two_hot_depth`
    (pixel stride D + 1, bin stride 1) is read in place; a view those two
    strides cannot describe is made contiguous."""
    view = depth.permute(0, 1, 3, 4, 2)  # (B, N, h, w, D), pixel-major
    *sizes, D = view.shape
    *strides, bin_stride = view.stride()
    pix_stride = strides[-1]
    expect = pix_stride
    for size, stride in zip(reversed(sizes), reversed(strides)):
        if size > 1 and stride != expect:
            view = view.contiguous()
            return view, D, 1
        expect *= size
    return view, pix_stride, bin_stride


def bev_pool_pooled(depth, feat, order, rk_sorted, num_cells: int, pool_r: int):
    """The presorted pooled lift's forward, gather included: depth
    (B, N, D, h, w) two-hot weights, feat (B, N, h, w, C) of one dtype,
    `order` / `rk_sorted` (int32, P_cap) from `LSSLift.precompute_sorted`
    -> (num_cells // pool_r, C) pooled grid in feat's dtype. Counts its
    kernel launches in `bev_pool_pooled.launches`. Forward only:
    `bev_pool_presorted_pooled` differentiates it."""
    if torch.is_grad_enabled() and (depth.requires_grad or feat.requires_grad):
        raise NotImplementedError("bev_pool_pooled is forward-only")
    if depth.dtype != feat.dtype or feat.dtype not in _DTYPE_CODE:
        raise TypeError(f"bev_pool_pooled takes float32/bfloat16 depth and feat of one dtype, "
                        f"got {depth.dtype} and {feat.dtype}")
    if num_cells % pool_r:
        raise ValueError(f"num_cells {num_cells} is not a multiple of pool_r {pool_r}")
    dev = feat.device
    if dev.type == "cpu":
        return bev_pool_pooled_plain(presorted_vals(depth, feat, order), rk_sorted, num_cells,
                                     pool_r, feat.dtype)
    if dev.type != "cuda":
        raise ValueError(f"bev_pool_pooled: feat on {dev}")
    for name, t in (("depth", depth), ("order", order), ("ranks", rk_sorted)):
        if t.device != dev:
            raise ValueError(f"bev_pool_pooled: {name} on {t.device}, feat on {dev}")
    if (depth.dim() != 5 or feat.dim() != 5 or depth.shape[:2] != feat.shape[:2]
            or depth.shape[3:] != feat.shape[2:4]):
        raise ValueError(f"bev_pool_pooled: depth {tuple(depth.shape)} and feat "
                         f"{tuple(feat.shape)} do not match")
    if (order.dtype != torch.int32 or rk_sorted.dtype != torch.int32 or order.dim() != 1
            or rk_sorted.shape != order.shape):
        raise ValueError(f"bev_pool_pooled: order {tuple(order.shape)} {order.dtype} and ranks "
                         f"{tuple(rk_sorted.shape)} {rk_sorted.dtype} must be int32 (P_cap,)")
    if not (order.is_contiguous() and rk_sorted.is_contiguous()):
        raise ValueError("bev_pool_pooled needs contiguous order and ranks")
    C = feat.shape[-1]
    if C > 1024:
        raise ValueError(f"bev_pool_pooled takes C <= 1024 channels, got {C}")
    feat = feat.contiguous()  # 8.65 MB at the flagship; a no-op for the lift's output
    if feat.data_ptr() % 16:
        raise ValueError("bev_pool_pooled needs 16-byte aligned feat")
    weights, pix_stride, bin_stride = _weight_strides(depth)
    n_coarse = num_cells // pool_r
    out = torch.empty(n_coarse, C, dtype=feat.dtype, device=dev)
    starts = _cell_starts(rk_sorted, num_cells, pool_r)
    long_list = torch.empty(n_coarse + 65, dtype=torch.int32, device=dev)  # the kernel's scratch
    fn = native.function("bev_pool_pooled", "veon_bev_pool_pooled", _POOLED_ARGTYPES)
    with torch.cuda.device(dev):  # the tensors' card, whichever is current
        err = fn(feat.data_ptr(), weights.data_ptr(), pix_stride, bin_stride, order.data_ptr(),
                 rk_sorted.data_ptr(), starts.data_ptr(), out.data_ptr(), long_list.data_ptr(),
                 n_coarse, C, depth.shape[2], pool_r, _DTYPE_CODE[feat.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"bev_pool_pooled launch failed: cudaError {err}")
    bev_pool_pooled.launches += 1
    return out


bev_pool_pooled.launches = 0


def bev_pool_sorted_plain(streams: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                          num_cells: int, out_dtype):
    """Plain PyTorch version of both sorted-stream kernels: fp32 index_add_
    of every (vals, rk) stream into (num_cells + 1, C), overflow rows in
    the last row, then one cast."""
    vals0 = streams[0][0]
    acc = torch.zeros(num_cells + 1, vals0.shape[1], dtype=torch.float32, device=vals0.device)
    for vals, rk in streams:
        acc.index_add_(0, rk.long().clamp(max=num_cells), vals.float())
    return acc[:num_cells].to(out_dtype)


def _launch_sorted(name, streams, num_cells: int):
    """Validate the streams, build their CSR offsets and launch the one-
    or two-stream entry of csrc/bev_pool_sorted.cu; returns (num_cells, C)."""
    vals1 = streams[0][0]
    dev, dtype, C = vals1.device, vals1.dtype, vals1.shape[1]
    if dev.type != "cuda":
        raise ValueError(f"{name}: vals on {dev}")
    for vals, rk in streams:
        _check_stream(name, vals, rk, dev, dtype)
        if vals.shape[1] != C:
            raise ValueError(f"{name}: streams of {C} and {vals.shape[1]} channels")
    out = torch.empty(num_cells, C, dtype=dtype, device=dev)
    starts = [_cell_starts(rk, num_cells) for _vals, rk in streams]
    ptrs = [p for (vals, _rk), s in zip(streams, starts) for p in (vals.data_ptr(), s.data_ptr())]
    symbol = "veon_bev_pool_sorted" if len(streams) == 1 else "veon_bev_pool_sorted2"
    fn = native.function("bev_pool_sorted", symbol, (ctypes.c_void_p,) * (len(ptrs) + 1)
                         + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
    with torch.cuda.device(dev):  # the tensors' card, whichever is current
        err = fn(*ptrs, out.data_ptr(), num_cells, C, _DTYPE_CODE[dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def bev_pool_sorted(vals, rk_sorted, num_cells: int):
    """One sorted (P, C) stream -> (num_cells, C) per-cell sums in vals'
    dtype (kernel #2). Counts launches in `bev_pool_sorted.launches`."""
    if vals.device.type == "cpu":
        return bev_pool_sorted_plain([(vals, rk_sorted)], num_cells, vals.dtype)
    out = _launch_sorted("bev_pool_sorted", [(vals, rk_sorted)], num_cells)
    bev_pool_sorted.launches += 1
    return out


bev_pool_sorted.launches = 0


def bev_pool_sorted2(vals1, rk1, vals2, rk2, num_cells: int):
    """Two sorted streams -> one (num_cells, C) grid of per-cell sums, stream
    1 rows before stream 2 rows (kernel #3). Counts launches in
    `bev_pool_sorted2.launches`."""
    if vals1.device.type == "cpu":
        return bev_pool_sorted_plain([(vals1, rk1), (vals2, rk2)], num_cells, vals1.dtype)
    out = _launch_sorted("bev_pool_sorted2", [(vals1, rk1), (vals2, rk2)], num_cells)
    bev_pool_sorted2.launches += 1
    return out


bev_pool_sorted2.launches = 0


def sorted_stream(weights, feat_flat, ranks, valid_cap: Optional[float] = None):
    """A pixel-major point set as one sorted stream: weights / ranks
    (B, N, h, w, K), feat_flat (B*N*h*w, C) -> (int32 ranks (P,), rows
    feat[pix] * w (P, C)), stable-sorted by rank (as jnp.argsort). A
    `valid_cap` keeps only the sorted prefix of cap * P rows (rounded up to
    PREFIX_ROUND), which is lossless only while the in-grid count fits."""
    K = weights.shape[-1]
    rk = ranks.reshape(-1)
    order = torch.argsort(rk, stable=True)
    if valid_cap is not None:
        P = rk.shape[0]
        p_cap = -(-int(P * valid_cap) // PREFIX_ROUND) * PREFIX_ROUND
        order = order[:min(p_cap, -(-P // PREFIX_ROUND) * PREFIX_ROUND)]
    vals = feat_flat[order // K] * weights.reshape(-1)[order][:, None]
    return rk[order].to(torch.int32).contiguous(), vals.contiguous()


def _gather_adjoint(g, weights, feat, ranks, num_cells: int, need_w: bool, need_f: bool):
    """Backward of a pixel-major pool: the cotangent of every point is its
    cell's row of g (0 for overflow), so d_weights[.., k] = <feat, g_at[k]>
    and d_feat = sum_k weights[k] g_at[k]. weights / ranks (B, N, h, w, K)."""
    C = feat.shape[-1]
    gpad = torch.cat([g.reshape(num_cells, C), g.new_zeros(1, C)])
    g_at = gpad[ranks.long().clamp(max=num_cells)]  # (B, N, h, w, K, C)
    dw = torch.einsum("bnhwc,bnhwkc->bnhwk", feat, g_at) if need_w else None
    df = torch.einsum("bnhwk,bnhwkc->bnhwc", weights, g_at) if need_f else None
    return dw, df


def _num_cells(feat, grid_size):
    nx, ny, nz = grid_size
    return feat.shape[0] * nz * ny * nx


class _BandedPool(torch.autograd.Function):
    """bev_pool_pallas_banded: one pixel-major stream through kernel #2."""

    @staticmethod
    def forward(ctx, weights, feat, ranks, grid_size, valid_cap):
        B, C = feat.shape[0], feat.shape[-1]
        nx, ny, nz = grid_size
        num_cells = _num_cells(feat, grid_size)
        rk, vals = sorted_stream(weights, feat.reshape(-1, C), ranks, valid_cap)
        out = bev_pool_sorted(vals, rk, num_cells)
        ctx.save_for_backward(weights, feat, ranks)
        ctx.num_cells = num_cells
        return out.reshape(B, nz, ny, nx, C)

    @staticmethod
    def backward(ctx, g):
        weights, feat, ranks = ctx.saved_tensors
        # the exact adjoint of the uncapped forward (as the JAX backward)
        dw, df = _gather_adjoint(g, weights, feat, ranks, ctx.num_cells,
                                 ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return dw, df, None, None, None


class _Banded2Pool(torch.autograd.Function):
    """bev_pool_pallas_banded2: two pixel-major streams through kernel #3."""

    @staticmethod
    def forward(ctx, weights, feat, ranks, weights2, ranks2, grid_size, valid_cap2):
        B, C = feat.shape[0], feat.shape[-1]
        nx, ny, nz = grid_size
        num_cells = _num_cells(feat, grid_size)
        feat_flat = feat.reshape(-1, C)
        rk1, vals1 = sorted_stream(weights, feat_flat, ranks)
        rk2, vals2 = sorted_stream(weights2, feat_flat, ranks2, valid_cap2)
        out = bev_pool_sorted2(vals1, rk1, vals2, rk2, num_cells)
        ctx.save_for_backward(weights, feat, ranks, weights2, ranks2)
        ctx.num_cells = num_cells
        return out.reshape(B, nz, ny, nx, C)

    @staticmethod
    def backward(ctx, g):
        weights, feat, ranks, weights2, ranks2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        dw1, df1 = _gather_adjoint(g, weights, feat, ranks, ctx.num_cells, need[0], need[1])
        dw2, df2 = _gather_adjoint(g, weights2, feat, ranks2, ctx.num_cells, need[3], need[1])
        return dw1, (df1 + df2 if need[1] else None), None, dw2, None, None, None


def bev_pool_banded(weights, feat, ranks, grid_size, valid_cap: Optional[float] = None):
    """K-banded pool: weights / ranks (B, N, h, w, K), feat (B, N, h, w, C)
    -> (B, nz, ny, nx, C); overflow rank = B*nz*ny*nx."""
    return _BandedPool.apply(weights, feat, ranks, tuple(grid_size), valid_cap)


def bev_pool_banded2(weights, feat, ranks, weights2, ranks2, grid_size,
                     valid_cap2: Optional[float] = None):
    """Two pixel-major streams (the K-banded main stream, uncapped, and e.g.
    the far-depth spray over all D bins) into ONE grid: weights / ranks
    (B, N, h, w, K), weights2 / ranks2 (B, N, h, w, K2), shared feat."""
    return _Banded2Pool.apply(weights, feat, ranks, weights2, ranks2, tuple(grid_size),
                              valid_cap2)


def bev_pool(depth, feat, ranks, grid_size, valid_cap: Optional[float] = None):
    """Full-frustum pool (in-graph form of `bev_pool_pallas`): depth
    (B, N, D, h, w) weights, feat (B, N, h, w, C), ranks (B, N, D, h, w)
    -> (B, nz, ny, nx, C). valid_cap None keeps every point (lossless)."""
    return bev_pool_banded(depth.permute(0, 1, 3, 4, 2), feat, ranks.permute(0, 1, 3, 4, 2),
                           grid_size, valid_cap)


class _PresortedPooled(torch.autograd.Function):
    """bev_pool_pallas_presorted_pooled: kernel #1 forward (gather fused
    in, no (P_cap, C) rows in device memory); the backward
    recomputes the fine grid with kernel #2, routes the cotangent through
    the group max (ties split evenly, as jnp.max's VJP) and applies the
    gather adjoints."""

    @staticmethod
    def forward(ctx, depth, feat, order, rk_pooled, ranks, grid_size, ds):
        B, C = depth.shape[0], feat.shape[-1]
        nx, ny, nz = grid_size
        dz, dy, dx = ds
        out = bev_pool_pooled(depth, feat, order, rk_pooled, _num_cells(feat, grid_size),
                              dz * dy * dx)
        ctx.save_for_backward(depth, feat, order, rk_pooled, ranks)
        ctx.grid_size, ctx.pool_r = grid_size, dz * dy * dx
        return out.reshape(B, nz // dz, ny // dy, nx // dx, C)

    @staticmethod
    def backward(ctx, g):
        depth, feat, order, rk_pooled, ranks = ctx.saved_tensors
        C = feat.shape[-1]
        num_cells = _num_cells(feat, ctx.grid_size)
        vals = presorted_vals(depth, feat, order).contiguous()
        fine = bev_pool_sorted(vals, rk_pooled, num_cells)  # coarse-major layout
        with torch.enable_grad():
            f = fine.reshape(num_cells // ctx.pool_r, ctx.pool_r, C).requires_grad_()
            (g_fine,) = torch.autograd.grad(f.amax(1), f, g.reshape(-1, C))
        need = ctx.needs_input_grad
        dw, df = _gather_adjoint(g_fine, depth.permute(0, 1, 3, 4, 2), feat,
                                 ranks.permute(0, 1, 3, 4, 2), num_cells, need[0], need[1])
        return (None if dw is None else dw.permute(0, 1, 4, 2, 3)), df, None, None, None, None, None


def bev_pool_presorted_pooled(depth, feat, order, rk_pooled, ranks, grid_size, ds):
    """Accelerate-mode lift with the [dz,dy,dx] max-pool fused into the pool:
    depth (B, N, D, h, w) weights, feat (B, N, h, w, C), `order` /
    `rk_pooled` / `ranks` (coarse-major) from `LSSLift.precompute_sorted`
    -> (B, nz/dz, ny/dy, nx/dx, C)."""
    return _PresortedPooled.apply(depth, feat, order, rk_pooled, ranks, tuple(grid_size),
                                  tuple(ds))
