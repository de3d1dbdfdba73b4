"""Occ3D-nuScenes mIoU (counterpart of `veon_tpu/eval/miou.py`): an 18×18
confusion histogram over camera-masked voxels, per-class IoU =
diag / (row + col - diag), mean over the 17 non-free classes.
`confusion_hist` is a bincount on the tensors' own device, so a served grid
is scored on the card; `MIoUMetric` accumulates on the host in numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

OCC3D_CLASS_NAMES = [
    "others", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation", "free",
]


def confusion_hist(pred: torch.Tensor, gt: torch.Tensor, mask: Optional[torch.Tensor],
                   num_classes: int = 18) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts, rows gt and columns pred,
    over the voxels where mask != 0 (all voxels for mask None); gt values
    outside [0, num_classes) (255) are left out, pred is clipped into range."""
    nc = num_classes
    pred = pred.reshape(-1).long()
    gt = gt.reshape(-1).long()
    valid = (gt >= 0) & (gt < nc)
    if mask is not None:
        valid = valid & (mask.reshape(-1) != 0)
    idx = torch.where(valid, gt * nc + pred.clamp(0, nc - 1), nc * nc)
    return torch.bincount(idx, minlength=nc * nc + 1)[:-1].reshape(nc, nc)


def per_class_iou(hist: np.ndarray) -> np.ndarray:
    diag = np.diag(hist).astype(np.float64)
    denom = hist.sum(1) + hist.sum(0) - np.diag(hist)
    with np.errstate(divide="ignore", invalid="ignore"):
        return diag / denom


class MIoUMetric:
    """Streaming mIoU accumulator over samples (numpy on the host)."""

    def __init__(self, num_classes: int = 18, use_image_mask: bool = True,
                 use_lidar_mask: bool = False):
        self.num_classes = num_classes
        self.use_image_mask = use_image_mask
        self.use_lidar_mask = use_lidar_mask
        self.hist = np.zeros((num_classes, num_classes), np.int64)
        self.cnt = 0

    def add_batch(self, pred, gt, mask_lidar=None, mask_camera=None):
        nc = self.num_classes
        pred = np.asarray(pred).reshape(-1).astype(np.int64)
        gt = np.asarray(gt).reshape(-1).astype(np.int64)
        valid = (gt >= 0) & (gt < nc)
        if self.use_image_mask and mask_camera is not None:
            valid &= np.asarray(mask_camera).reshape(-1) != 0
        elif self.use_lidar_mask and mask_lidar is not None:
            valid &= np.asarray(mask_lidar).reshape(-1) != 0
        idx = gt[valid] * nc + np.clip(pred[valid], 0, nc - 1)
        self.hist += np.bincount(idx, minlength=nc * nc).reshape(nc, nc)
        self.cnt += 1

    def count_miou(self) -> Tuple[List[str], np.ndarray, float]:
        iou = per_class_iou(self.hist)
        miou = float(np.nanmean(iou[: self.num_classes - 1]) * 100)
        print(f"===> per class IoU of {self.cnt} samples:")
        for i in range(self.num_classes - 1):
            print(f"===> {OCC3D_CLASS_NAMES[i]} - IoU = {round(iou[i] * 100, 2)}")
        print(f"===> mIoU of {self.cnt} samples: {round(miou, 2)}")
        return OCC3D_CLASS_NAMES, iou, miou
