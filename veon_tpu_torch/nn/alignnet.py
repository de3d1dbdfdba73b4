"""AlignNet3D refinement and heads plus the lift-input fusion
(counterpart of `veon_tpu/nn/alignnet.py`), F=1: channel-last 3D
(B, Z, Y, X, C). `train=True` runs BatchNorm on batch statistics and
updates its running stats (flax semantics, `nn/layers.py` BatchNorm)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import PropagationConfig
from .layers import BatchNorm, CatFusionLift, Conv3d
from .vit import stack


class ConvBN3D(nn.Module):
    """Conv3d -> BN -> optional ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, bias: bool = False,
                 relu: bool = True, dtype=torch.float32):
        super().__init__()
        self.relu = relu
        self.conv = Conv3d(cin, cout, kernel, bias=bias, dtype=dtype)
        self.bn = BatchNorm(cout)

    def forward(self, x, train: bool = False):
        x = self.bn(self.conv(x), train)
        return F.relu(x) if self.relu else x


class ResBlock3D(nn.Module):
    """conv-BN-relu, conv-BN, + identity, relu."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvBN3D(features, features, relu=True, dtype=dtype)
        self.conv2 = ConvBN3D(features, features, relu=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        return F.relu(self.conv2(self.conv1(x, train), train) + x)


class PredHead3DOcc(nn.Module):
    """1x1 conv-BN-relu -> 1x1 conv to 2 channels."""

    def __init__(self, cin: int, out_channels: int = 2, dtype=torch.float32):
        super().__init__()
        self.occ_conv1 = ConvBN3D(cin, cin // 4, kernel=1, dtype=dtype)
        self.occ_conv2 = Conv3d(cin // 4, out_channels, 1, bias=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        return self.occ_conv2(self.occ_conv1(x, train))


class PredHead3DSem(nn.Module):
    """Three 1x1 conv stages -> sigmoid - 0.5."""

    def __init__(self, cin: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.occ_conv1 = ConvBN3D(cin, cin, kernel=1, bias=True, dtype=dtype)
        self.occ_conv2 = ConvBN3D(cin, cin, kernel=1, dtype=dtype)
        self.occ_conv3 = Conv3d(cin, out_channels, 1, bias=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = self.occ_conv2(self.occ_conv1(x, train), train)
        return torch.sigmoid(self.occ_conv3(x)) - 0.5


class AlignNet3D(nn.Module):
    """3D ResBlocks + occupancy / CLIP-embedding heads on the lifted voxels."""

    def __init__(self, cfg: PropagationConfig, clip_outdim: int, dtype=torch.float32):
        super().__init__()
        self.res3d = stack(cfg.layer_depth, block=lambda: ResBlock3D(cfg.dim, dtype))
        self.occupancy_pred = PredHead3DOcc(cfg.dim, 2, dtype)
        self.feat_pred = PredHead3DSem(cfg.dim, clip_outdim, dtype)

    def forward(self, x, occ_feat_prevs: Optional[List[torch.Tensor]] = None,
                train: bool = False) -> Dict[str, torch.Tensor]:
        if occ_feat_prevs:
            raise NotImplementedError("temporal fusion (F>1) is not ported yet")
        for body in self.res3d:
            x = body["block"](x, train)
        return {"bin_occ": self.occupancy_pred(x, train), "feat_occ": self.feat_pred(x, train)}


class LiftFusion(nn.Module):
    """The fuse() input projection: CatFusionLift of (supp, clip) maps
    resized to the lift grid."""

    def __init__(self, cfg: PropagationConfig, supp_dim: int, clip_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.fusion_layer_0 = CatFusionLift(supp_dim, clip_dim, cfg.dim, dtype)

    def forward(self, supp, clip, lift_hw: Tuple[int, int]):
        return self.fusion_layer_0(supp, clip, lift_hw)
