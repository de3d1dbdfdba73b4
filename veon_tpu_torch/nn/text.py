"""Open-vocabulary class merging (counterpart of `veon_tpu/nn/text.py`):
the nuScenes vocabulary with synonyms, the class-reflection membership
matrix and the group-max merge. The tokenizer and text tower come with the
text-tower slice."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

NUSCENES_BRIEF: List[Tuple[str, List[str]]] = [
    ("others", [
        "debris", "animal", "personal mobility", "skateboard", "segway",
        "scooter", "stroller", "wheelchair", "trash bag", "road sign",
        "trash can", "wheel barrow", "garbage-bin with wheels", "bicycle rack",
        "ambulance vehicle", "police vehicle",
    ]),
    ("barrier", ["traffic barrier"]),
    ("bicycle", ["bicycle"]),
    ("bus", ["bus"]),
    ("car", ["car", "sedan", "hatch-back", "wagon", "van", "mini-van", "SUV", "jeep"]),
    ("construction_vehicle", ["construction vehicle"]),
    ("motorcycle", ["motorcycle"]),
    ("pedestrian", ["pedestrian", "construction worker", "police officer"]),
    ("traffic_cone", ["traffic cone"]),
    ("trailer", ["trailer"]),
    ("truck", ["truck"]),
    ("driveable surface", ["road"]),
    ("other flat", ["traffic delimiter", "traffic island", "rail track", "lake", "river"]),
    ("sidewalk", ["sidewalk", "pedestrian walkway", "bike path"]),
    ("terrain", ["grass", "rolling hill", "soil", "sand", "gravel"]),
    ("manmade", [
        "building", "wall", "guard rail", "fence", "drainage", "hydrant",
        "flag", "banner", "street sign", "electric circuit box",
        "traffic light", "parking meter", "stairs",
    ]),
    ("vegetation", ["vegetation", "plants", "bushes", "tree"]),
]


def build_vocabulary(name: str = "nuscenes_brief") -> Tuple[List[str], List[int]]:
    """(prompts, class_reflection): class_reflection[i] is the semantic
    class of prompt i."""
    if name != "nuscenes_brief":
        raise NotImplementedError(f"vocabulary {name!r} is not ported")
    prompts, reflection = [], []
    for cls_id, (_cat, items) in enumerate(NUSCENES_BRIEF):
        for it in items:
            prompts.append(it.lower().strip())
            reflection.append(cls_id)
    return prompts, reflection


def merge_matrix(class_reflection: Sequence[int]) -> np.ndarray:
    """(num_groups + 1, num_prompts + 1) bool membership matrix; the last
    row/column carries the background logit through."""
    refl = np.asarray(class_reflection)
    num_groups = int(refl.max()) + 1
    m = np.zeros((num_groups + 1, len(refl) + 1), dtype=bool)
    m[refl, np.arange(len(refl))] = True
    m[num_groups, len(refl)] = True
    return m


def merge_classes_max(x: torch.Tensor, membership, axis: int) -> torch.Tensor:
    """Group-max along `axis`: out[..., g, ...] = max over the prompts of group g."""
    x = x.movedim(axis, -1)
    # one gather + max per group: the masked (..., G, P) broadcast would
    # materialize G x the input (3 GB at the flagship's 640k voxels)
    groups = [torch.as_tensor(np.flatnonzero(row), device=x.device)
              for row in np.asarray(membership)]
    out = torch.stack([x.index_select(-1, g).amax(-1) for g in groups], -1)
    return out.movedim(-1, axis)
