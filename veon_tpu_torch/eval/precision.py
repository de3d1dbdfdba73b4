"""The bf16 serving forward held against the fp32 one (counterpart of the
battery in `tests/test_precision.py`): the fusion-rule class flip rate,
the cosine of the CLIP-space voxel field `feat_occ` that retrieval reads,
and the mean absolute difference of the occupancy probability, between two
forwards of the same weights and inputs."""

from __future__ import annotations

from typing import Dict

import torch

from ..model.veon import fused_classes


def precision_battery(ref: Dict[str, torch.Tensor], low: Dict[str, torch.Tensor],
                      membership) -> Dict[str, float]:
    """{"flip_rate", "feat_cos", "occ_prob_mad"} of the outputs `low` (the
    bf16 forward) against `ref` (the fp32 forward), on their device;
    `membership` is the vocabulary's merge matrix."""
    flips = (fused_classes(ref, membership) != fused_classes(low, membership)).double().mean()
    a, b = ref["feat_occ"].double().reshape(-1), low["feat_occ"].double().reshape(-1)
    cos = a @ b / (torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b) + 1e-12)
    p_ref = torch.softmax(ref["bin_occ"].float(), -1)[..., 0]
    p_low = torch.softmax(low["bin_occ"].float(), -1)[..., 0]
    mad = (p_ref - p_low).abs().double().mean()
    return {"flip_rate": flips.item(), "feat_cos": cos.item(), "occ_prob_mad": mad.item()}
