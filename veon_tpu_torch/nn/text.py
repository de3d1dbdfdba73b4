"""Open-vocabulary text machinery (counterpart of `veon_tpu/nn/text.py`):
the four named vocabularies with their synonyms, the CLIP prompt
templates, the CLIP BPE tokenizer, the template-ensemble classifier
weights, the class-reflection membership matrix and the group-max merge.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import tracing

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

# The "vild" prompt-template ensemble (clip_utils/utils.py:90-107).
VILD_TEMPLATES = [
    "a photo of a {}.",
    "This is a photo of a {}",
    "There is a {} in the scene",
    "There is the {} in the scene",
    "a photo of a {} in the scene",
    "a photo of a small {}.",
    "a photo of a medium {}.",
    "a photo of a large {}.",
    "This is a photo of a small {}.",
    "This is a photo of a medium {}.",
    "This is a photo of a large {}.",
    "There is a small {} in the scene.",
    "There is a medium {} in the scene.",
    "There is a large {} in the scene.",
]


# The standard 80-template CLIP zero-shot ensemble ("imagenet" set,
# clip_utils/utils.py:8-89), chosen by `SANConfig.template_set`.
IMAGENET_TEMPLATES = [
    "a bad photo of a {}.", "a photo of many {}.", "a sculpture of a {}.",
    "a photo of the hard to see {}.", "a low resolution photo of the {}.",
    "a rendering of a {}.", "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.", "the embroidered {}.",
    "a photo of a hard to see {}.", "a bright photo of a {}.",
    "a photo of a clean {}.", "a photo of a dirty {}.",
    "a dark photo of the {}.", "a drawing of a {}.", "a photo of my {}.",
    "the plastic {}.", "a photo of the cool {}.", "a close-up photo of a {}.",
    "a black and white photo of the {}.", "a painting of the {}.",
    "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a plastic {}.", "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.", "a blurry photo of the {}.",
    "a photo of the {}.", "a good photo of the {}.", "a rendering of the {}.",
    "a {} in a video game.", "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "a photo of a {}.", "the origami {}.",
    "the {} in a video game.", "a sketch of a {}.", "a doodle of the {}.",
    "a origami {}.", "a low resolution photo of a {}.", "the toy {}.",
    "a rendition of the {}.", "a photo of the clean {}.",
    "a photo of a large {}.", "a rendition of a {}.", "a photo of a nice {}.",
    "a photo of a weird {}.", "a blurry photo of a {}.", "a cartoon {}.",
    "art of a {}.", "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.", "a photo of the small {}.",
    "a photo of the weird {}.", "the cartoon {}.", "art of the {}.",
    "a drawing of the {}.", "a photo of the large {}.",
    "a black and white photo of a {}.", "the plushie {}.",
    "a dark photo of a {}.", "itap of a {}.", "graffiti of the {}.",
    "a toy {}.", "itap of my {}.", "a photo of a cool {}.",
    "a photo of a small {}.", "a tattoo of the {}.",
]

TEMPLATE_SETS: Dict[str, List[str]] = {"vild": VILD_TEMPLATES, "imagenet": IMAGENET_TEMPLATES}


def get_templates(name: str = "vild") -> List[str]:
    """The named prompt-template set ("vild" or "imagenet")."""
    return TEMPLATE_SETS[name]


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
    groups = [tracing.uploaded(torch.as_tensor(np.flatnonzero(row), device=x.device))
              for row in np.asarray(membership)]
    out = torch.stack([x.index_select(-1, g).amax(-1) for g in groups], -1)
    return out.movedim(-1, axis)


# --------------------------------------------------------------------------
# CLIP BPE tokenizer (the openai/CLIP simple tokenizer algorithm). The merges
# table ships with CLIP distributions (bpe_simple_vocab_16e6.txt.gz). Without
# it the tokenizer falls back to deterministic hash ids, so the graph runs
# without weights; those ids are not CLIP's.
# --------------------------------------------------------------------------


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


class ClipTokenizer:
    """CLIP BPE tokenizer; context length 77, sot=49406, eot=49407."""

    CONTEXT = 77
    SOT = 49406
    EOT = 49407

    def __init__(self, bpe_path: Optional[str] = None):
        self.byte_encoder = _bytes_to_unicode()
        self.fallback = bpe_path is None or not os.path.exists(bpe_path)
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE)
        if not self.fallback:
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
            merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
            vocab = list(self.byte_encoder.values())
            vocab = vocab + [v + "</w>" for v in vocab]
            vocab += ["".join(m) for m in merges]
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = dict(zip(vocab, range(len(vocab))))
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
            self.cache = {"<|startoftext|>": "<|startoftext|>",
                          "<|endoftext|>": "<|endoftext|>"}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids of `text` without the SOT/EOT framing."""
        text = _whitespace_clean(_basic_clean(text)).lower()
        if self.fallback:
            # deterministic hash ids in [1000, 40000): they exercise the graph only
            ids = []
            for tok in text.split(" "):
                h = 0
                for ch in tok:
                    h = (h * 131 + ord(ch)) % 39000
                ids.append(1000 + h)
            return ids
        bpe_tokens: List[int] = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return bpe_tokens

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        """(len(texts), 77) int32 with SOT/EOT framing; a longer sequence is
        cut to 77 with EOT last."""
        out = np.zeros((len(texts), self.CONTEXT), dtype=np.int32)
        for i, t in enumerate(texts):
            toks = [self.SOT] + self.encode(t) + [self.EOT]
            if len(toks) > self.CONTEXT:
                toks = toks[: self.CONTEXT]
                toks[-1] = self.EOT
            out[i, : len(toks)] = toks
        return out


def classifier_weights_from_embeddings(per_template_embeds: torch.Tensor) -> torch.Tensor:
    """Template-ensemble average: (T, N, C) normalized embeddings -> mean
    over T, renormalized."""
    mean = per_template_embeds.mean(0)
    return mean / torch.linalg.vector_norm(mean, dim=-1, keepdim=True)


def ov_classifier_weight(cat_embeddings: torch.Tensor, bg_embed: torch.Tensor,
                         logit_scale: torch.Tensor) -> torch.Tensor:
    """Open-vocabulary classifier with a learnable background: append the bg
    row, L2-normalize the rows, multiply by exp(logit_scale)."""
    w = torch.cat([cat_embeddings, bg_embed], 0)
    w = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    return torch.exp(logit_scale) * w


def check_text_tower(cfg, tokenizer: ClipTokenizer, vocab_rows: int, require_bpe: bool = True):
    """The reference's refusals before a real text tower encodes the
    vocabulary, in its order: no BPE merges (the hash-fallback tokenizer
    would silently scramble every prompt) unless require_bpe=False, then a
    token-embedding row count other than the config's vocabulary size."""
    if tokenizer.fallback and require_bpe:
        raise ValueError(
            "a real CLIP text tower was given but no BPE vocab is available: pass bpe_path "
            "pointing at bpe_simple_vocab_16e6.txt.gz (the hash-fallback tokenizer would "
            "silently corrupt every class prompt)")
    if vocab_rows != cfg.san.text_vocab_size:
        raise ValueError(f"text tower vocab size {vocab_rows} != configured "
                         f"{cfg.san.text_vocab_size}; checkpoint/config mismatch")


def text_classifier(cfg, prompts, text_tower, bg_embed, logit_scale, bpe_path=None,
                    require_bpe=True) -> torch.Tensor:
    """The open-vocabulary classifier (len(prompts) + 1, C) fp32 on the
    tower's device (counterpart of `veon_tpu/cli/main.py`
    `_text_classifier`): each template of `cfg.san.template_set` over the
    prompts through the text tower (a `CLIPTextEncoder`), the template
    average renormalised, the bg row appended, rows normalised, times
    exp(logit_scale).

    Real tower weights need the real BPE merges: without `bpe_path` the
    hash-fallback tokenizer would silently scramble every prompt, so that
    raises unless require_bpe=False. A tower whose vocabulary differs from
    the config's raises too."""
    tok = ClipTokenizer(bpe_path)
    check_text_tower(cfg, tok, text_tower.token_embedding.weight.shape[0], require_bpe)
    dev = text_tower.positional_embedding.device
    with torch.no_grad():
        embeds = [text_tower(torch.from_numpy(tok.tokenize([t.format(p) for p in prompts])).to(dev))
                  for t in get_templates(cfg.san.template_set)]
        w = classifier_weights_from_embeddings(torch.stack(embeds))
        return ov_classifier_weight(
            w, torch.as_tensor(np.asarray(bg_embed, np.float32), device=dev),
            torch.as_tensor(np.asarray(logit_scale, np.float32), device=dev))
