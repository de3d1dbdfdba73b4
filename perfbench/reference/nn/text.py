"""Open-vocabulary class merge (counterpart of `veon_tpu/nn/text.py`): the
four named vocabularies with their synonyms, the class-reflection
membership matrix and the group-max merge.
"""

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

# Detailed nuScenes taxonomy ("nuscenes_default"): per-item official
# annotator-instruction descriptions (nuScenes devkit taxonomy; reference
# vocabulary/nuscenes_vol.py NUSCENES_CLASSES). Prompts become
# "<name>, in detail '<description>'".
NUSCENES_DETAILED: List[Tuple[str, List[Tuple[str, ...]]]] = [
    ("others", [
        ("animal", "All animals, e.g. cats, rats, dogs, deer, birds."),
        ("personal mobility", "A small electric or self-propelled vehicle, e.g. skateboard, segway, or scooters, on which the person typically travels in a upright position."),
        ("stroller", "Any stroller."),
        ("wheelchair", "Any type of wheelchair."),
        ("debris", "Debris or movable object that is too large to be driven over safely. Includes misc. things like trash bags, temporary road-signs, objects around construction zones, and trash cans."),
        ("pushable pullable objects", "Objects that a pedestrian may push or pull. For example dolleys, wheel barrows, garbage-bins with wheels, or shopping carts. Typically not designed to carry humans."),
        ("bicycle rack", "Area or device intended to park or secure the bicycles in a row. It includes all the bicycles parked in it and any empty slots that are intended for parking bicycles. Bicycles that are not part of the rack should not be included."),
        ("ambulance vehicle", "All types of ambulances."),
        ("police vehicle", "All types of police vehicles including police bicycles and motorcycles."),
        ("ego vehicle", "The vehicle on which the cameras, radar and lidar are mounted, that is sometimes visible at the bottom of the image."),
    ]),
    ("barrier", [("traffic barrier", "Any metal, concrete or water barrier temporarily placed in the scene in order to re-direct vehicle or pedestrian traffic. In particular, includes barriers used at construction zones.")]),
    ("bicycle", [("bicycle", "Human or electric powered 2-wheeled vehicle designed to travel at lower speeds either on road surface, sidewalks or bicycle paths.")]),
    ("bus", [("bus", "Any types of buses and shuttles designed to carry more than 10 people.")]),
    ("car", [("car", "Vehicle designed primarily for personal use, e.g. sedans, hatch-backs, wagons, vans, mini-vans, SUVs and jeeps.")]),
    ("construction_vehicle", [("construction_vehicle", "Vehicles primarily designed for construction. Typically very slow moving or stationary. Cranes and extremities of construction vehicles are only included in annotations if they interfere with traffic. Trucks used to hauling rocks or building materials are considered trucks rather than construction vehicles.")]),
    ("motorcycle", [("motorcycle", "Gasoline or electric powered 2-wheeled vehicle designed to move rapidly (at the speed of standard cars) on the road surface. This category includes all motorcycles, vespas and scooters. It also includes light 3-wheel vehicles, often with a light plastic roof and open on the sides, that tend to be common in Asia.")]),
    ("pedestrian", [
        ("pedestrian", "A pedestrian moving around the cityscape."),
        ("construction worker", "A human in the scene whose main purpose is construction work."),
        ("police_officer", "Any type of police officer, regardless whether directing the traffic or not."),
    ]),
    ("traffic_cone", [("traffic_cone", "All types of traffic cones.")]),
    ("trailer", [("trailer", "Any vehicle trailer, both for trucks, cars and motorcycles (regardless of whether currently being towed or not).")]),
    ("truck", [("truck", "Vehicles primarily designed to haul cargo including pick-ups, lorrys, trucks and semi-tractors.")]),
    ("driveable surface", [("driveable surface", "All paved or unpaved surfaces that a car can drive on with no concern of traffic rules.")]),
    ("other flat", [("other flat", "All other forms of horizontal ground-level structures that do not belong to any of driveable surface, curb, sidewalk and terrain. Includes elevated parts of traffic islands, delimiters, rail tracks, stairs with at most 3 steps and larger bodies of water (lakes, rivers).")]),
    ("sidewalk", [("sidewalk", "Sidewalk, pedestrian walkways, bike paths, etc. Part of the ground designated for pedestrians or cyclists. Sidewalks do not have to be next to a road.")]),
    ("terrain", [("terrain", "Natural horizontal surfaces such as ground level horizontal vegetation (< 20 cm tall), grass, rolling hills, soil, sand and gravel.")]),
    ("manmade", [("manmade", "Includes man-made structures but not limited to: buildings, walls, guard rails, fences, poles, drainages, hydrants, flags, banners, street signs, electric circuit boxes, traffic lights, parking meters and stairs with more than 3 steps.")]),
    ("vegetation", [("vegetation", "Any vegetation in the frame that is higher than the ground, including bushes, plants, potted plants, trees, etc. Only tall grass (> 20cm) is part of this")]),
]

# SemanticKITTI 20-class vocabulary with synonyms ("semkitti_brief";
# reference vocabulary/semkitti_vol.py). Note: class 0 is "unlabeled"; the
# reference moves the merged free class to index 0 at merge time.
SEMKITTI_BRIEF: List[Tuple[str, List[str]]] = [
    ("unlabeled", ["unlabeled"]),
    ("car", ["car"]),
    ("bicycle", ["bicycle"]),
    ("motorcycle", ["motorcycle"]),
    ("truck", ["truck"]),
    ("other-vehicle", ["bus", "sedan", "wagon", "van", "mini-van", "jeep",
                       "construction vehicle"]),
    ("person", ["pedestrian", "construction worker", "police officer"]),
    ("bicyclist", ["bicyclist"]),
    ("motorcyclist", ["motorcyclist"]),
    ("road", ["road"]),
    ("parking", ["parking"]),
    ("sidewalk", ["sidewalk", "bike path"]),
    ("other-ground", ["traffic delimiter", "traffic island", "rail track",
                      "lake", "river"]),
    ("building", ["building", "wall", "stairs"]),
    ("fence", ["fence", "guard rail"]),
    ("vegetation", ["vegetation", "plants", "bushes", "tree"]),
    ("trunk", ["trunk"]),
    ("terrain", ["grass", "rolling hill", "soil", "sand", "gravel"]),
    ("pole", ["pole"]),
    ("traffic-sign", ["traffic sign"]),
]

# Standard COCO-Stuff-171 label set ("coco_default"; one class per prompt —
# `san_in_veon_entry_temporal.py:264-271` appends them with identity
# class_reflection).
COCO_STUFF_171 = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush", "banner",
    "blanket", "branch", "bridge", "building-other", "bush", "cabinet",
    "cage", "cardboard", "carpet", "ceiling-other", "ceiling-tile", "cloth",
    "clothes", "clouds", "counter", "cupboard", "curtain", "desk-stuff",
    "dirt", "door-stuff", "fence", "floor-marble", "floor-other",
    "floor-stone", "floor-tile", "floor-wood", "flower", "fog",
    "food-other", "fruit", "furniture-other", "grass", "gravel",
    "ground-other", "hill", "house", "leaves", "light", "mat", "metal",
    "mirror-stuff", "moss", "mountain", "mud", "napkin", "net", "paper",
    "pavement", "pillow", "plant-other", "plastic", "platform",
    "playingfield", "railing", "railroad", "river", "road", "rock", "roof",
    "rug", "salad", "sand", "sea", "shelf", "sky-other", "skyscraper",
    "snow", "solid-other", "stairs", "stone", "straw", "structural-other",
    "table", "tent", "textile-other", "towel", "tree", "vegetable",
    "wall-brick", "wall-concrete", "wall-other", "wall-panel", "wall-stone",
    "wall-tile", "wall-wood", "water-other", "waterdrops", "window-blind",
    "window-other", "wood",
]

def build_vocabulary(name: str = "nuscenes_brief") -> Tuple[List[str], List[int]]:
    """(prompts, class_reflection) of a named vocabulary: class_reflection[i]
    is the semantic class of prompt i. nuscenes_default prompts read
    "<name>, in detail '<description>'"; coco_default has one prompt per
    class."""
    prompts: List[str] = []
    reflection: List[int] = []
    if name == "nuscenes_brief":
        for cls_id, (_cat, items) in enumerate(NUSCENES_BRIEF):
            for it in items:
                prompts.append(it.lower().strip())
                reflection.append(cls_id)
    elif name == "nuscenes_default":
        for cls_id, (_cat, items) in enumerate(NUSCENES_DETAILED):
            for it in items:
                text = it[0] if len(it) == 1 else f"{it[0]}, in detail '{it[1]}'"
                prompts.append(text.lower().strip())
                reflection.append(cls_id)
    elif name == "semkitti_brief":
        for cls_id, (_cat, items) in enumerate(SEMKITTI_BRIEF):
            for it in items:
                prompts.append(it.lower().strip())
                reflection.append(cls_id)
    elif name == "coco_default":
        prompts = [c.lower().strip() for c in COCO_STUFF_171]
        reflection = list(range(len(prompts)))
    else:
        raise ValueError(f"unknown vocabulary {name!r}")
    return prompts, reflection


def merge_matrix(class_reflection: Sequence[int], extra_rows: int = 1) -> np.ndarray:
    """(num_groups + extra, num_prompts + extra) bool membership matrix; the
    trailing `extra_rows` rows/columns carry the background logit through."""
    refl = np.asarray(class_reflection)
    num_groups = int(refl.max()) + 1
    m = np.zeros((num_groups + extra_rows, len(refl) + extra_rows), dtype=bool)
    m[refl, np.arange(len(refl))] = True
    for e in range(extra_rows):
        m[num_groups + e, len(refl) + e] = True
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
