"""The input normalizer of raw uint8 frames on the device (counterpart of
`veon_tpu/data/transforms.py` `normalize_in_graph`)."""

from __future__ import annotations

import numpy as np
import torch

_CLIPSAN_MEAN = np.array([122.7709, 116.7460, 104.0937], np.float32)
_CLIPSAN_STD = np.array([68.5005, 66.6322, 70.3232], np.float32)
_MMLAB_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
_MMLAB_STD = np.array([58.395, 57.12, 57.375], np.float32)
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# (divide_by_255, mean, std) per method; every method also reverses the
# channels: mmcv's imnormalize(to_rgb=True) swaps channels of what it takes
# for BGR, and the reference feeds it RGB, so the trained checkpoints'
# input contract is the reversed order.
_NORM_TABLE = {
    "clipsan": (False, _CLIPSAN_MEAN, _CLIPSAN_STD),
    "mmlab": (False, _MMLAB_MEAN, _MMLAB_STD),
    "midas": (True, np.float32(0.5), np.float32(0.5)),
    "depthanythingv2": (True, _IMAGENET_MEAN, _IMAGENET_STD),
}


def normalize_in_graph(img: torch.Tensor, method: str) -> torch.Tensor:
    """Normalize HWC RGB frames (uint8 or float, any leading dims) on their
    own device, in fp32: reverse the channels, optionally /255, then
    (x - mean) / std, as the port's serving session does with raw
    uint8 frames."""
    if method not in _NORM_TABLE:
        raise ValueError(f"unknown normalization method {method!r}")
    div255, mean, std = _NORM_TABLE[method]
    x = img.to(torch.float32).flip(-1)
    if div255:
        # a divisor on the device: CUDA multiplies by the reciprocal of a
        # Python scalar, one rounding away from the host's division
        x = x / torch.tensor(255.0, device=x.device)
    mean = torch.as_tensor(mean, device=x.device)
    std = torch.as_tensor(std, device=x.device)
    return (x - mean) / std
