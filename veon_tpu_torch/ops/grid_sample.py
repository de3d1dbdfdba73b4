"""Channel-last bilinear grid sampling over `F.grid_sample` (counterpart of
`veon_tpu/ops/grid_sample.py` `grid_sample_2d`, which was written to
torch's semantics: grid (..., 2) holds normalized (x, y) in [-1, 1], x
indexing W)."""

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
