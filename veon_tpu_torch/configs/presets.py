"""Model presets of the port: VEON-B and its fast serving tiers, VEON-L,
both on the ZoeDepth-NK depth branch too, and the unit-test miniature (the
same values as `veon_tpu/configs/presets.py`)."""

from __future__ import annotations

import dataclasses

from .base import (DataConfig, DepthConfig, GridConfig, HSAConfig,
                   PropagationConfig, SANConfig, VeonConfig)


def san_vit_l_14_336() -> SANConfig:
    """SAN ViT-L-14-336 (san_clip_vit_large_res4_coco_temporal.yaml)."""
    return SANConfig(
        clip_width=1024, clip_heads=16, clip_layers=24, clip_patch_size=14,
        clip_embed_dim=768, clip_pretrain_grid=(24, 24), feature_last_layer_idx=18,
        fusion_map=((0, 0), (1, 6), (2, 12), (3, 18)), attn_bias_heads=16,
        text_width=768, text_heads=12, text_layers=12,
    )


def veon_b(num_temporal: int = 1, compute_dtype: str = "float32") -> VeonConfig:
    """VEON-B @ 512x1408 with DepthAnythingV2-L depth; num_temporal frames
    (F) per forward, 2 for the flagship's temporal serving."""
    return VeonConfig(
        compute_dtype=compute_dtype,
        num_temporal=num_temporal,
        san=SANConfig(),
        hsa=HSAConfig(clip_dim=768, num_heads=12, fusion_map=((0, 3, 3), (1, 6, 6), (2, 9, 9))),
        propagation=PropagationConfig(dim=256, layer_depth=5, clip_proj_dim=512),
        depth=DepthConfig(encoder="vitl"),
    )


def veon_l(num_temporal: int = 1) -> VeonConfig:
    """VEON-L: SAN ViT-L-14-336 + DAV2-L, fp32 (no compute_dtype, as in
    JAX). Its HSA blocks take the CLIP map of one layer for the attention
    grid and add that of another, (3, 6) / (9, 12) / (15, 18); its CLIP
    input 256x704 gives an 18x50 token grid (patch 14 does not divide it)."""
    return VeonConfig(
        num_temporal=num_temporal,
        san=san_vit_l_14_336(),
        hsa=HSAConfig(clip_dim=1024, num_heads=16,
                      fusion_map=((0, 3, 6), (1, 9, 12), (2, 15, 18))),
        propagation=PropagationConfig(dim=256, layer_depth=4, clip_proj_dim=768),
        depth=DepthConfig(encoder="vitl"),
    )


def veon_b_fast(num_temporal: int = 1, compute_dtype: str = "float32") -> VeonConfig:
    """VEON-B fast serving tier 1: DA-V2 input lower bound 224 instead of
    252 (fewer depth-tower tokens; the same weights, the ViT interpolates
    its position embedding). Its accuracy cost waits for real weights."""
    cfg = veon_b(num_temporal=num_temporal, compute_dtype=compute_dtype)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dav2_target=224))


def veon_b_fast2(num_temporal: int = 1, compute_dtype: str = "float32") -> VeonConfig:
    """VEON-B fast serving tier 2: DA-V2 lower bound 196; as `veon_b_fast`."""
    cfg = veon_b(num_temporal=num_temporal, compute_dtype=compute_dtype)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dav2_target=196))


def veon_b_zoe(num_temporal: int = 1, compute_dtype: str = "float32") -> VeonConfig:
    """VEON-B with the ZoeDepth-NK (MiDaS BEiT-L-384) depth branch
    (configs/veon/veon-temporal-base-512x1408-zoe-nodepthcache.py): its
    depth input is midas-normalized at `depth_input_size`, not resized."""
    cfg = veon_b(num_temporal=num_temporal, compute_dtype=compute_dtype)
    return dataclasses.replace(cfg, depth_mode="zoedepth",
                               data=dataclasses.replace(cfg.data, depth_norm_method="midas"))


def veon_l_zoe(num_temporal: int = 1) -> VeonConfig:
    """VEON-L with the ZoeDepth-NK depth branch (fp32 only, as `veon_l`)."""
    cfg = veon_l(num_temporal=num_temporal)
    return dataclasses.replace(cfg, depth_mode="zoedepth",
                               data=dataclasses.replace(cfg.data, depth_norm_method="midas"))


def veon_tiny_test(num_temporal: int = 1) -> VeonConfig:
    """A miniature config for unit tests: same topology, tiny dims/resolution."""
    return VeonConfig(
        num_temporal=num_temporal,
        grid=GridConfig(
            x=(-40.0, 40.0, 4.0), y=(-40.0, 40.0, 4.0), z=(-1.0, 5.4, 1.6), depth=(1.0, 45.0, 5.5)
        ),
        san=SANConfig(
            clip_width=32, clip_heads=2, clip_layers=4, clip_patch_size=16,
            clip_embed_dim=16, clip_pretrain_grid=(2, 2), feature_last_layer_idx=3,
            side_width=16, side_depth=2, side_heads=2, num_queries=8,
            fusion_map=((0, 0), (1, 3)), side_pretrain_grid=(4, 4),
            attn_bias_heads=2, attn_bias_embed_channels=8, attn_bias_mlp_channels=8,
            text_width=32, text_heads=2, text_layers=2, text_context_length=77,
        ),
        hsa=HSAConfig(
            dim=16, clip_dim=32, mlp_dim=16, patch_shape=(8, 8), num_heads=2,
            fusion_map=((0, 1, 1), (1, 2, 2)), manip_dim_head=4,
            manip_attn_layers=1, manip_supp_dim=16,
        ),
        propagation=PropagationConfig(dim=16, layer_depth=2, clip_proj_dim=16),
        depth=DepthConfig(encoder="vits", features=16, out_channels=(8, 16, 16, 16)),
        data=dataclasses.replace(DataConfig(), input_size=(64, 176),
                                 depth_input_size=(32, 88), dav2_target=28),
        lss_feat_ds=(2, 2, 2),
        lss_downsample=16,
    )
