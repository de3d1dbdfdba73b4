"""Channel-last resize ops over `F.interpolate` / `F.adaptive_max_pool2d`.

Counterpart of `veon_tpu/ops/resize.py`, whose weight-matrix resizes are
pinned to these torch semantics by `tests/test_ops_parity.py`.
x is (..., H, W, C) for the 2D ops and (..., D, H, W, C) for trilinear.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor, spatial: int):
    """(..., *S, C) -> (N, C, *S) and the leading shape to restore."""
    lead = x.shape[: x.dim() - spatial - 1]
    y = x.reshape((-1,) + tuple(x.shape[-spatial - 1:]))
    return y.movedim(-1, 1), lead


def _back(y: torch.Tensor, lead) -> torch.Tensor:
    y = y.movedim(1, -1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


def _interp(x, size, spatial, **kw):
    if tuple(x.shape[-spatial - 1:-1]) == tuple(size):
        return x
    y, lead = _nchw(x, spatial)
    return _back(F.interpolate(y, size=tuple(size), **kw), lead)


def resize_bilinear(x: torch.Tensor, out_size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    return _interp(x, out_size, 2, mode="bilinear", align_corners=align_corners)


def resize_bicubic(x: torch.Tensor, out_size: Tuple[int, int],
                   align_corners: bool = False) -> torch.Tensor:
    return _interp(x, out_size, 2, mode="bicubic", align_corners=align_corners)


def resize_bicubic_scaled(x: torch.Tensor, out_size: Tuple[int, int],
                          scales: Tuple[float, float]) -> torch.Tensor:
    """Bicubic resize whose coordinate map uses explicit scale factors
    (src = (dst + 0.5) / s - 0.5), as DINOv2's pos-embed interpolation."""
    y, lead = _nchw(x, 2)
    y = F.interpolate(y, scale_factor=tuple(scales), mode="bicubic",
                      align_corners=False, recompute_scale_factor=False)
    if tuple(y.shape[-2:]) != tuple(out_size):
        raise ValueError(f"scale {scales} gives {tuple(y.shape[-2:])}, "
                         f"not {tuple(out_size)}")
    return _back(y, lead)


def resize_nearest(x: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    """torch legacy 'nearest' (floor of the scaled index)."""
    return _interp(x, out_size, 2, mode="nearest")


def resize_trilinear(x: torch.Tensor, out_size: Tuple[int, int, int],
                     align_corners: bool = False) -> torch.Tensor:
    return _interp(x, out_size, 3, mode="trilinear", align_corners=align_corners)


def adaptive_max_pool2d(x: torch.Tensor, out_size: Tuple[int, int]) -> torch.Tensor:
    if tuple(x.shape[-3:-1]) == tuple(out_size):
        return x
    y, lead = _nchw(x, 2)
    return _back(F.adaptive_max_pool2d(y, tuple(out_size)), lead)
