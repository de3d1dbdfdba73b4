"""Dataclass configuration tree of the PyTorch port.

A copy of the fields of `veon_tpu/configs/base.py` that the serving
forwards (F=1 and temporal), the text tower and the stage-2 train step
read, the ZoeDepth-NK branch's `ZoeConfig`, and the host data plane's
`DataConfig` (the port imports nothing of `veon_tpu`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Voxel grid + depth bins: each axis is (lower_bound, upper_bound, interval)."""

    x: Tuple[float, float, float] = (-40.0, 40.0, 0.4)
    y: Tuple[float, float, float] = (-40.0, 40.0, 0.4)
    z: Tuple[float, float, float] = (-1.0, 5.4, 0.4)
    depth: Tuple[float, float, float] = (1.0, 45.0, 0.5)

    @property
    def lower_bound(self) -> Tuple[float, float, float]:
        return (self.x[0], self.y[0], self.z[0])

    @property
    def interval(self) -> Tuple[float, float, float]:
        return (self.x[2], self.y[2], self.z[2])

    @property
    def size(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) voxel counts."""
        return (
            int(round((self.x[1] - self.x[0]) / self.x[2])),
            int(round((self.y[1] - self.y[0]) / self.y[2])),
            int(round((self.z[1] - self.z[0]) / self.z[2])),
        )

    def scaled(self, ds_zyx: Tuple[int, int, int]) -> "GridConfig":
        """Grid with z/y/x intervals multiplied by the feature downsample factors."""
        dz, dy, dx = ds_zyx
        return dataclasses.replace(self, x=(self.x[0], self.x[1], self.x[2] * dx),
                                   y=(self.y[0], self.y[1], self.y[2] * dy),
                                   z=(self.z[0], self.z[1], self.z[2] * dz))

    @property
    def num_depth_bins(self) -> int:
        """D: number of frustum depth planes (88 for the default config)."""
        return int(math.ceil((self.depth[1] - self.depth[0]) / self.depth[2]))


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """DINOv2 trunk size (MLP ratio 4 for all): patch size, and the
    position-embedding grid the pretrained weights were trained at."""

    width: int = 768
    depth: int = 12
    heads: int = 12
    patch_size: int = 14
    pretrain_grid: Tuple[int, int] = (37, 37)


@dataclasses.dataclass(frozen=True)
class SANConfig:
    """SAN side adapter + CLIP recognition stack."""

    clip_width: int = 768
    clip_heads: int = 12
    clip_layers: int = 12
    clip_patch_size: int = 16
    clip_embed_dim: int = 512
    clip_pretrain_grid: Tuple[int, int] = (14, 14)
    feature_last_layer_idx: int = 9
    rec_downsample_method: str = "max"
    rec_cross_attn: bool = True
    template_set: str = "vild"

    side_width: int = 240
    side_depth: int = 8
    side_heads: int = 6
    side_patch_size: int = 16
    side_pretrain_grid: Tuple[int, int] = (40, 40)
    num_queries: int = 100
    # (side_block_idx, clip_layer_idx)
    fusion_map: Tuple[Tuple[int, int], ...] = ((0, 0), (1, 3), (2, 6), (3, 9))

    attn_bias_heads: int = 12
    attn_bias_layers: int = 1
    attn_bias_embed_channels: int = 256
    attn_bias_mlp_channels: int = 256
    attn_bias_mlp_num_layers: int = 3
    rescale_attn_bias: bool = True

    # text tower (CLIP text transformer)
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    text_context_length: int = 77
    text_vocab_size: int = 49408


@dataclasses.dataclass(frozen=True)
class HSAConfig:
    """High-resolution side adaptor."""

    dim: int = 384
    clip_dim: int = 768
    mlp_dim: int = 384
    patch_shape: Tuple[int, int] = (8, 8)
    num_heads: int = 12
    # each entry: (block_idx, clip_cross_layer, clip_add_layer)
    fusion_map: Tuple[Tuple[int, int, int], ...] = ((0, 3, 3), (1, 6, 6), (2, 9, 9))
    manip_dim_head: int = 32
    manip_attn_layers: int = 6
    manip_supp_dim: int = 384


@dataclasses.dataclass(frozen=True)
class PropagationConfig:
    """3D occupancy decoder."""

    dim: int = 256
    layer_depth: int = 5
    clip_proj_dim: int = 512


@dataclasses.dataclass(frozen=True)
class DepthConfig:
    """DepthAnythingV2 adaptor. `use_lora`/`lora_r`/`lora_alpha` describe
    the adapters of a depth-pretrain checkpoint; the serving tower folds
    them into the base weights when it loads one (`ckpt/convert.py`
    `merge_lora`, scale lora_alpha / r), so it has none. The stage-1 tower
    (`pretrain-depth`) is built with them (`nn/dpt.py` lora=True)."""

    encoder: str = "vitl"
    features: int = 256
    out_channels: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    max_depth: float = 80.0
    use_lora: bool = True
    lora_r: int = 16
    lora_alpha: int = 1

    @property
    def vit(self) -> ViTConfig:
        return {
            "vits": ViTConfig(width=384, depth=12, heads=6),
            "vitb": ViTConfig(width=768, depth=12, heads=12),
            "vitl": ViTConfig(width=1024, depth=24, heads=16),
        }[self.encoder]

    @property
    def intermediate_layer_idx(self) -> Tuple[int, ...]:
        return {"vits": (2, 5, 8, 11), "vitb": (2, 5, 8, 11),
                "vitl": (4, 11, 17, 23)}[self.encoder]


@dataclasses.dataclass(frozen=True)
class ZoeConfig:
    """ZoeDepth-NK on MiDaS DPT-BEiT-L-384: the BEiT-L/16 trunk, the MiDaS
    decoder and the kitti metric-bins head. `use_lora`/`lora_r` describe
    the adapters of a depth-pretrain checkpoint; like `DepthConfig`, the
    serving tower folds them into the base weights when it loads one
    (scale 1 / r, the adapters' alpha 1), so it has none; the stage-1
    tower is built with them (`nn/zoedepth.py` lora=True)."""

    # BEiT-L/16-384 trunk
    width: int = 1024
    depth: int = 24
    heads: int = 16
    patch_size: int = 16
    hooks: Tuple[int, int, int, int] = (5, 11, 17, 23)
    pyramid_channels: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    features: int = 256
    # metric bins head (kitti-only in the VEON adaptor)
    n_bins: int = 64
    min_depth: float = 1e-3
    max_depth: float = 80.0
    bin_embedding_dim: int = 128
    n_attractors: Tuple[int, int, int, int] = (16, 8, 4, 1)
    attractor_alpha: float = 1000.0
    attractor_gamma: int = 2
    attractor_kind: str = "mean"
    attractor_type: str = "inv"
    min_temp: float = 0.0212
    max_temp: float = 50.0
    use_lora: bool = True
    lora_r: int = 8


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Camera + input geometry and the host data plane's augmentation."""

    cams: Tuple[str, ...] = (
        "CAM_FRONT_LEFT",
        "CAM_FRONT",
        "CAM_FRONT_RIGHT",
        "CAM_BACK_LEFT",
        "CAM_BACK",
        "CAM_BACK_RIGHT",
    )
    num_cams: int = 6
    input_size: Tuple[int, int] = (512, 1408)
    depth_norm_method: str = "depthanythingv2"  # or "midas" for the zoe branch
    depth_input_size: Tuple[int, int] = (256, 704)
    # DA-V2 lower-bound resize target (multiple of 14)
    dav2_target: int = 252
    src_size: Tuple[int, int] = (900, 1600)
    # image augmentation ranges, all off as in the VEON configs
    resize: Tuple[float, float] = (0.0, 0.0)
    rot: Tuple[float, float] = (0.0, 0.0)
    flip: bool = False
    crop_h: Tuple[float, float] = (0.0, 0.0)
    resize_test: float = 0.0
    # BEV data augmentation, sampled per train sample: the geometry gets the
    # 3x3 bda matrix, the occ GT and masks the matching axis flips;
    # identity / off as in the published recipe
    bda_rot_lim: Tuple[float, float] = (0.0, 0.0)
    bda_scale_lim: Tuple[float, float] = (1.0, 1.0)
    bda_flip_dx_ratio: float = 0.0
    bda_flip_dy_ratio: float = 0.0
    # the dataset emits post-aug uint8 frames and normalization runs on the
    # device (`data/transforms.py` `normalize_in_graph`): bit-exact against
    # the host normalizers, 4x less host memory and host-to-device copy
    raw_uint8: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Stage-2 occupancy loss weights and the stage-1 depth bin-CE weight."""

    out_channel: int = 18
    empty_idx: int = 17
    ignore_idx: int = 255
    high_conf_thr: float = 0.99
    stage2_start: int = 2
    ov_class_number: int = 17
    priority: Tuple[int, ...] = (2, 2, 3, 2, 2, 3, 3, 2, 3, 2, 2, 1, 1, 1, 1, 1, 1)
    loss_voxel_ce_weight: float = 1.5
    loss_featalign_det_weight: float = 35.0
    loss_featalign_soft_weight: float = 25.0
    bin_class_weights: Tuple[float, float] = (1.0, 0.5)
    # depth pretraining (stage 1)
    loss_depth_ce_weight: float = 0.05


@dataclasses.dataclass(frozen=True)
class VeonConfig:
    grid: GridConfig = GridConfig()
    data: DataConfig = DataConfig()
    san: SANConfig = SANConfig()
    hsa: HSAConfig = HSAConfig()
    propagation: PropagationConfig = PropagationConfig()
    depth: DepthConfig = DepthConfig()
    zoe: ZoeConfig = ZoeConfig()
    depth_mode: str = "depthanythingv2"  # or "zoedepth"
    loss: LossConfig = LossConfig()

    lss_feat_ds: Tuple[int, int, int] = (2, 2, 2)  # (z, h, w)
    lss_downsample: int = 16
    # lift without a presorted rig (training): the K-banded two-hot with
    # the far-depth spray (True) or the reference full-frustum lift (False)
    lss_banded: bool = True
    num_temporal: int = 1  # F: the current frame and F-1 previous ones
    vocabulary: str = "nuscenes_brief"
    compute_dtype: str = "float32"  # "bfloat16" for the serving path

    @property
    def feat_hw(self) -> Tuple[int, int]:
        h, w = self.data.input_size
        return (h // self.lss_downsample, w // self.lss_downsample)
