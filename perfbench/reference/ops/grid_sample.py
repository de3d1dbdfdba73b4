"""Channel-last grid sampling over `F.grid_sample` (counterpart of
`veon_tpu/ops/grid_sample.py`, which was written to torch's semantics and
is pinned to it by `tests/test_ops_parity.py`: grid (..., 2|3) holds
normalized (x, y[, z]) in [-1, 1], x indexing the innermost axis W and z
the outermost D)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C), grid (N, ..., 2) -> (N, ..., C): bilinear, zeros
    outside, align_corners=False (the distillation loss's sampling)."""
    N, C = x.shape[0], x.shape[-1]
    g = grid.reshape(N, -1, 1, 2).to(x.dtype)
    out = F.grid_sample(x.permute(0, 3, 1, 2), g, mode="bilinear", padding_mode="zeros",
                        align_corners=False)  # (N, C, L, 1)
    return out[..., 0].transpose(1, 2).reshape(grid.shape[:-1] + (C,))


def grid_sample_3d(x: torch.Tensor, grid: torch.Tensor, align_corners: bool = False,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Trilinear sampling: x (N, D, H, W, C), grid (N, ..., 3) -> (N, ..., C)
    in the promoted dtype of x and grid, as the JAX op's arithmetic gives
    (bf16 features sampled at fp32 coordinates come back fp32).
    padding_mode "zeros" (the ego-motion warp) or "border" (the deformable
    attention's taps)."""
    N, C = x.shape[0], x.shape[-1]
    dt = torch.promote_types(x.dtype, grid.dtype)
    g = grid.reshape(N, -1, 1, 1, 3).to(dt)
    out = F.grid_sample(x.to(dt).permute(0, 4, 1, 2, 3), g, mode="bilinear",
                        padding_mode=padding_mode, align_corners=align_corners)  # (N, C, L, 1, 1)
    return out[..., 0, 0].transpose(1, 2).reshape(grid.shape[:-1] + (C,))
