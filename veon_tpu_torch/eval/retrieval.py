"""POP-3D language retrieval metrics (counterpart of
`veon_tpu/eval/retrieval.py`): cosine of per-voxel CLIP features against a
free-text prompt embedding, scored as average precision over the annotated
points and over their camera-visible subset."""

from __future__ import annotations

from typing import Dict

import numpy as np


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """Average precision of binary labels, as sklearn's
    average_precision_score: sum_k (R_k - R_{k-1}) P_k over the descending
    distinct-score thresholds; NaN without a positive label."""
    labels = np.asarray(labels).astype(np.float64).reshape(-1)
    scores = np.asarray(scores).astype(np.float64).reshape(-1)
    n_pos = labels.sum()
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-scores, kind="stable")
    labels = labels[order]
    scores = scores[order]
    distinct = np.where(np.diff(scores))[0]  # tied scores form one threshold
    idxs = np.r_[distinct, labels.size - 1]
    tp = np.cumsum(labels)[idxs]
    fp = (idxs + 1) - tp
    precision = tp / (tp + fp)
    recall = tp / n_pos
    prev_recall = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - prev_recall) * precision))


def retrieval_scores(occ_feat: np.ndarray, prompt_embedding: np.ndarray,
                     point_indices: np.ndarray, matching_points: np.ndarray,
                     anno: np.ndarray) -> Dict[str, float]:
    """Per-prompt retrieval AP: occ_feat (X, Y, Z, C) voxel features,
    prompt_embedding (C,), point_indices (P, 3) voxel indices of the
    annotated points, matching_points (M,) indices into P of the
    camera-visible ones, anno (P,) binary relevance. Returns {"map",
    "map_visible"}."""
    idx = point_indices.astype(np.int64)
    feats = occ_feat[idx[:, 0], idx[:, 1], idx[:, 2]]
    q = prompt_embedding.reshape(-1)
    denom = np.maximum(np.linalg.norm(feats, axis=-1) * np.linalg.norm(q), 1e-8)
    cos = feats @ q / denom
    out = {"map": average_precision(anno, cos)}
    m = matching_points.astype(np.int64)
    out["map_visible"] = average_precision(anno[m], cos[m])
    return out
