"""Input normalizers, image augmentation with its homography, BEV data
augmentation and the SE(3) helpers of the host data plane (counterpart of
`veon_tpu/data/transforms.py`).

The homography bookkeeping (post_rot / post_tran) follows the reference's
`img_transform` exactly, since the LSS geometry depends on it bit for bit;
images are resampled with PIL bicubic everywhere, in the reference
package's order, so samples are bit-equal to its.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import DataConfig
from ..utils import tracing

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


def _normalize_host(img, method: str) -> np.ndarray:
    div255, mean, std = _NORM_TABLE[method]
    x = np.asarray(img, np.float32)[..., ::-1]
    if div255:
        x = x / 255.0
    return (x - mean) / std


def normalize_clipsan(img) -> np.ndarray:
    return _normalize_host(img, "clipsan")


def normalize_mmlab(img) -> np.ndarray:
    return _normalize_host(img, "mmlab")


def normalize_midas(img) -> np.ndarray:
    return _normalize_host(img, "midas")


def normalize_dav2(img) -> np.ndarray:
    return _normalize_host(img, "depthanythingv2")


# host normalizers of HWC RGB frames (uint8 or float) -> float32, numpy
NORMALIZERS = {
    "clipsan": normalize_clipsan,
    "mmlab": normalize_mmlab,
    "midas": normalize_midas,
    "depthanythingv2": normalize_dav2,
}


def normalize_consts(method: str, device) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                                   torch.Tensor]:
    """`normalize_in_graph`'s constants of `method` on `device`: the divisor
    255 (None where the method takes no /255), the means and the stds."""
    if method not in _NORM_TABLE:
        raise ValueError(f"unknown normalization method {method!r}")
    div255, mean, std = _NORM_TABLE[method]
    # a divisor on the device: CUDA multiplies by the reciprocal of a Python
    # scalar, one rounding away from the host's division
    return (torch.tensor(255.0, device=device) if div255 else None,
            torch.as_tensor(mean, device=device), torch.as_tensor(std, device=device))


def normalize_in_graph(img: torch.Tensor, method: str, consts=None) -> torch.Tensor:
    """Normalize HWC RGB frames (uint8 or float, any leading dims) on their
    own device, in fp32: reverse the channels, optionally /255, then
    (x - mean) / std, bit-equal to the host `NORMALIZERS`. Serving sessions
    and the eval loop's raw-uint8 mode take raw uint8 frames with it.
    `consts`, the method's `normalize_consts` on the frames' device, saves
    their upload on each call."""
    if consts is None:
        consts = [t if t is None else tracing.uploaded(t)
                  for t in normalize_consts(method, img.device)]
    div, mean, std = consts
    x = img.to(torch.float32).flip(-1)
    if div is not None:
        x = x / div
    return (x - mean) / std


def dav2_size(h: int, w: int, target: int = 252) -> Tuple[int, int]:
    """DA-V2 lower-bound keep-aspect resize to a multiple of 14: scale so the
    smaller relative side reaches `target`, round each side to a multiple
    of 14 (ceiling where rounding would fall below `target`)."""

    def constrain(x: float) -> int:
        y = int(np.round(x / 14) * 14)
        if y < target:
            y = int(np.ceil(x / 14) * 14)
        return y

    scale = max(target / h, target / w)
    return constrain(scale * h), constrain(scale * w)


def depth_tower_size(cfg) -> Tuple[int, int]:
    """(h, w) of the depth tower's input for a `DataConfig`: the DA-V2
    lower-bound size for the DA-V2 branch; `depth_input_size` as it is for
    the midas-normalized zoe branch (midasNormalize does no resize)."""
    if cfg.depth_norm_method == "depthanythingv2":
        return dav2_size(*cfg.depth_input_size, target=cfg.dav2_target)
    return tuple(cfg.depth_input_size)


def quaternion_matrix(q: Sequence[float]) -> np.ndarray:
    """(w, x, y, z) unit quaternion -> 3x3 rotation, float64 (pyquaternion's
    layout, as the reference's `get_sensor_transforms` reads it)."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ],
        dtype=np.float64,
    )


def se3(rotation_q: Sequence[float], translation: Sequence[float]) -> np.ndarray:
    """4x4 float32 SE(3) from a (w, x, y, z) quaternion and a translation."""
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = quaternion_matrix(rotation_q)
    m[:3, 3] = np.asarray(translation, np.float64)
    return m


@dataclasses.dataclass(frozen=True)
class ImageAug:
    """One camera's augmentation: `resize_dims` is (W', H') as PIL takes it,
    `crop` (left, top, right, bottom) in the resized image."""

    resize: float
    resize_dims: Tuple[int, int]
    crop: Tuple[int, int, int, int]
    flip: bool
    rotate: float


def _rot2(deg: float) -> np.ndarray:
    h = deg / 180.0 * np.pi
    return np.array([[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]], np.float64)


def aug_homography(aug: ImageAug) -> Tuple[np.ndarray, np.ndarray]:
    """post_rot (3, 3) and post_tran (3,) float32 of an ImageAug: scale,
    crop shift, the optional horizontal flip about the crop width, then the
    rotation about the crop centre, in float64; the third row and column
    stay identity so they compose with (u, v, depth) triples."""
    rot = np.eye(2, dtype=np.float64) * aug.resize
    tran = -np.asarray(aug.crop[:2], np.float64)
    if aug.flip:
        A = np.array([[-1.0, 0.0], [0.0, 1.0]])
        b = np.array([aug.crop[2] - aug.crop[0], 0.0])
        rot = A @ rot
        tran = A @ tran + b
    A = _rot2(aug.rotate)
    b = np.array([aug.crop[2] - aug.crop[0], aug.crop[3] - aug.crop[1]]) / 2.0
    b = A @ (-b) + b
    rot = A @ rot
    tran = A @ tran + b
    rot3 = np.eye(3, dtype=np.float32)
    rot3[:2, :2] = rot
    tran3 = np.zeros(3, dtype=np.float32)
    tran3[:2] = tran
    return rot3, tran3


def sample_augmentation(data_cfg: DataConfig, src_hw: Tuple[int, int], is_train: bool = False,
                        rng: Optional[np.random.Generator] = None) -> ImageAug:
    """One camera's augmentation. Train: random resize jitter, crop_h, flip
    and rotation from the config's ranges; test: the source fitted to
    `input_size` with a bottom-anchored crop. With the VEON configs' zero
    ranges the train augmentation equals the test one."""
    H, W = src_hw
    fH, fW = data_cfg.input_size
    rng = rng or np.random.default_rng()
    if is_train:
        resize = float(fW) / float(W) + rng.uniform(*data_cfg.resize)
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - rng.uniform(*data_cfg.crop_h)) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = bool(data_cfg.flip and rng.integers(0, 2))
        rotate = float(rng.uniform(*data_cfg.rot))
    else:
        resize = float(fW) / float(W) + data_cfg.resize_test
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - np.mean(data_cfg.crop_h)) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = False
        rotate = 0.0
    return ImageAug(resize=resize, resize_dims=resize_dims, crop=crop, flip=flip, rotate=rotate)


def apply_image_aug(img, aug: ImageAug):
    """A PIL image resized (bicubic), cropped, flipped and rotated."""
    from PIL import Image

    img = img.resize(aug.resize_dims, resample=Image.BICUBIC)
    img = img.crop(aug.crop)
    if aug.flip:
        img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
    if aug.rotate:
        img = img.rotate(aug.rotate)
    return img


def bda_matrix(rotate_deg: float = 0.0, scale: float = 1.0, flip_dx: bool = False,
               flip_dy: bool = False) -> np.ndarray:
    """3x3 float32 BEV augmentation, flip @ (scale * z-rotation), applied to
    ego points as `bda @ x`; the identity by default."""
    h = rotate_deg / 180.0 * np.pi
    rot = np.array(
        [[np.cos(h), -np.sin(h), 0.0], [np.sin(h), np.cos(h), 0.0], [0.0, 0.0, 1.0]],
        np.float64,
    )
    m = rot * scale
    if flip_dx:
        m = np.diag([-1.0, 1.0, 1.0]) @ m
    if flip_dy:
        m = np.diag([1.0, -1.0, 1.0]) @ m
    return m.astype(np.float32)


def sample_bda_augmentation(cfg: DataConfig, is_train: bool, rng
                            ) -> Tuple[float, float, bool, bool]:
    """(rotate_deg, scale, flip_dx, flip_dy): uniform rotation and scale
    inside the configured limits and Bernoulli flips for training; the
    identity for evaluation."""
    if not is_train:
        return 0.0, 1.0, False, False
    rotate = float(rng.uniform(*cfg.bda_rot_lim))
    scale = float(rng.uniform(*cfg.bda_scale_lim))
    flip_dx = bool(rng.uniform() < cfg.bda_flip_dx_ratio)
    flip_dy = bool(rng.uniform() < cfg.bda_flip_dy_ratio)
    return rotate, scale, flip_dx, flip_dy


def flip_occ_gt(sample: dict, flip_dx: bool, flip_dy: bool) -> None:
    """Flip the (X, Y, Z) occ GT and masks of `sample` in place to match a
    flipped bda: flip_dx reverses axis 0, flip_dy axis 1 (the grid is
    symmetric about 0, so cell i maps onto cell n-1-i exactly)."""
    for k in ("voxel_semantics", "mask_lidar", "mask_camera"):
        if k not in sample:
            continue
        v = sample[k]
        if flip_dx:
            v = v[::-1, ...]
        if flip_dy:
            v = v[:, ::-1, ...]
        sample[k] = np.ascontiguousarray(v)
