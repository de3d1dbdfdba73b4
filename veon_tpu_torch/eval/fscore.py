"""Chamfer-style occupancy F-score (counterpart of `veon_tpu/eval/fscore.py`):
the centres of occupied voxels, nearest-neighbour distances both ways
(scipy's cKDTree), F1 of accuracy and completeness at a distance threshold,
camera-masked."""

from __future__ import annotations

from typing import Optional

import numpy as np


class FScoreMetric:
    def __init__(self, leaf_size: int = 10, threshold_acc: float = 0.4,
                 threshold_complete: float = 0.4, voxel_size: float = 0.4,
                 range_: tuple = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4),
                 void: tuple = (17, 255), use_image_mask: bool = True):
        self.leaf_size = leaf_size
        self.threshold_acc = threshold_acc
        self.threshold_complete = threshold_complete
        self.voxel_size = voxel_size
        self.range = range_
        self.void = void
        self.use_image_mask = use_image_mask
        self.tot_acc = 0.0
        self.tot_cmpl = 0.0
        self.tot_f1 = 0.0
        self.cnt = 0

    def _voxel_points(self, occ: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
        occupied = ~np.isin(occ, self.void)
        if mask is not None:
            occupied &= mask.astype(bool)
        idx = np.argwhere(occupied).astype(np.float64)
        return idx * self.voxel_size + np.asarray(self.range[:3]) + self.voxel_size / 2

    def add_batch(self, pred: np.ndarray, gt: np.ndarray, mask_lidar=None, mask_camera=None):
        from scipy.spatial import cKDTree

        mask = mask_camera if self.use_image_mask else mask_lidar
        p = self._voxel_points(pred, mask)
        g = self._voxel_points(gt, mask)
        if len(p) == 0 or len(g) == 0:
            self.cnt += 1
            return
        d_p2g, _ = cKDTree(g, leafsize=self.leaf_size).query(p)  # accuracy: pred -> gt
        d_g2p, _ = cKDTree(p, leafsize=self.leaf_size).query(g)  # completeness: gt -> pred
        acc = float(np.mean(d_p2g < self.threshold_acc))
        cmpl = float(np.mean(d_g2p < self.threshold_complete))
        f1 = 2 * acc * cmpl / max(acc + cmpl, 1e-8)
        self.tot_acc += acc
        self.tot_cmpl += cmpl
        self.tot_f1 += f1
        self.cnt += 1

    def count_fscore(self):
        n = max(self.cnt, 1)
        out = {"accuracy": self.tot_acc / n, "completeness": self.tot_cmpl / n,
               "fscore": self.tot_f1 / n}
        print(f"===> F-score of {self.cnt} samples: "
              + ", ".join(f"{k}={v:.4f}" for k, v in out.items()))
        return out
