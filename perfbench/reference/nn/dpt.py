"""DPT metric-depth head + DepthAnythingV2 adaptor, channel-last
(counterpart of `veon_tpu/nn/dpt.py`)."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import DepthConfig
from ..ops.resize import resize_bilinear
from .layers import Conv2d, ConvTranspose2d
from .vit import DinoV2Trunk


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3 -> +x (no BN)."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1, dtype=dtype)
        self.conv2 = Conv2d(features, features, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """Optional skip RCU, RCU, bilinear up (align_corners=True), 1x1 out conv."""

    def __init__(self, features: int, skip: bool = True, dtype=torch.float32):
        super().__init__()
        if skip:
            self.rcu1 = ResidualConvUnit(features, dtype)
        self.rcu2 = ResidualConvUnit(features, dtype)
        self.out_conv = Conv2d(features, features, 1, dtype=dtype)

    def forward(self, x, skip=None, size: Tuple[int, int] = None):
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        if size is None:
            size = (x.shape[-3] * 2, x.shape[-2] * 2)
        return self.out_conv(resize_bilinear(x, size, align_corners=True))


class DPTHead(nn.Module):
    """DPT head (use_clstoken=False): 4 token maps -> (B, H, W, 1) sigmoid depth."""

    def __init__(self, in_dim: int, features: int, out_channels: Tuple[int, int, int, int],
                 patch_size: int = 14, dtype=torch.float32):
        super().__init__()
        self.patch_size = patch_size
        oc = out_channels
        for i in range(4):
            self.add_module(f"projects_{i}", Conv2d(in_dim, oc[i], 1, dtype=dtype))
        self.resize_0 = ConvTranspose2d(oc[0], oc[0], 4, dtype=dtype)
        self.resize_1 = ConvTranspose2d(oc[1], oc[1], 2, dtype=dtype)
        self.resize_3 = Conv2d(oc[3], oc[3], 3, stride=2, padding=1, dtype=dtype)
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn",
                            Conv2d(oc[i], features, 3, padding=1, bias=False, dtype=dtype))
        for i in (4, 3, 2, 1):
            self.add_module(f"refinenet{i}", FeatureFusionBlock(features, skip=i != 4, dtype=dtype))
        self.output_conv1 = Conv2d(features, features // 2, 3, padding=1, dtype=dtype)
        self.output_conv2_0 = Conv2d(features // 2, 32, 3, padding=1, dtype=dtype)
        self.output_conv2_2 = Conv2d(32, 1, 1, dtype=dtype)

    def forward(self, layer_tokens: List[torch.Tensor], patch_hw: Tuple[int, int]):
        ph, pw = patch_hw
        outs = []
        for i, t in enumerate(layer_tokens):
            B, L, C = t.shape
            x = getattr(self, f"projects_{i}")(t.reshape(B, ph, pw, C))
            if i in (0, 1, 3):
                x = getattr(self, f"resize_{i}")(x)
            outs.append(x)
        rn = [getattr(self, f"layer{i + 1}_rn")(outs[i]) for i in range(4)]
        path = self.refinenet4(rn[3], size=rn[2].shape[-3:-1])
        path = self.refinenet3(path, rn[2], size=rn[1].shape[-3:-1])
        path = self.refinenet2(path, rn[1], size=rn[0].shape[-3:-1])
        path = self.refinenet1(path, rn[0])
        x = self.output_conv1(path)
        x = resize_bilinear(x, (ph * self.patch_size, pw * self.patch_size), align_corners=True)
        x = self.output_conv2_2(F.relu(self.output_conv2_0(x)))
        return torch.sigmoid(x)


class DepthAnythingV2(nn.Module):
    """DINOv2 -> DPT -> metric depth = sigmoid * max_depth.
    images (B, H, W, 3) DA-V2-normalized -> (B, H, W). lora=True (the
    stage-1 tower) gives the trunk cfg.lora_r adapters with cfg.lora_alpha
    where cfg.use_lora is set; the serving tower has none (folded at load)."""

    def __init__(self, cfg: DepthConfig, dtype=torch.float32, lora: bool = False):
        super().__init__()
        vit = cfg.vit
        self.max_depth = cfg.max_depth
        self.patch_size = vit.patch_size
        self.pretrained = DinoV2Trunk(vit.width, vit.depth, vit.heads, patch_size=vit.patch_size,
                                      pretrain_grid=vit.pretrain_grid[0],
                                      take_layers=cfg.intermediate_layer_idx, dtype=dtype,
                                      lora_r=cfg.lora_r if lora and cfg.use_lora else 0,
                                      lora_alpha=cfg.lora_alpha)
        self.depth_head = DPTHead(vit.width, cfg.features, cfg.out_channels,
                                  patch_size=vit.patch_size, dtype=dtype)

    def forward(self, images):
        ph, pw = images.shape[1] // self.patch_size, images.shape[2] // self.patch_size
        tokens = [t for t, _cls in self.pretrained(images)]
        return self.depth_head(tokens, (ph, pw))[..., 0] * self.max_depth
