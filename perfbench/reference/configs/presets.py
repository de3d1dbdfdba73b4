"""The unit-test miniature (the same values as
`veon_tpu/configs/presets.py`). The benchmark's configurations are not
presets here: the reference builds each from its `configs/<name>.json`
(`harness.config_from_file`)."""

from __future__ import annotations

import dataclasses

from .base import (DataConfig, DepthConfig, GridConfig, HSAConfig,
                   PropagationConfig, SANConfig, VeonConfig)


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
