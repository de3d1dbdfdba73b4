"""Occ3D mIoU, POP-3D retrieval AP and the occupancy F-score (counterpart
of `veon_tpu/eval`)."""

from .fscore import FScoreMetric
from .miou import OCC3D_CLASS_NAMES, MIoUMetric, confusion_hist, per_class_iou
from .retrieval import average_precision, retrieval_scores

__all__ = ["FScoreMetric", "OCC3D_CLASS_NAMES", "MIoUMetric", "confusion_hist",
           "per_class_iou", "average_precision", "retrieval_scores"]
