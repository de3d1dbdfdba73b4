"""AlignNet3D refinement and heads, the temporal fusion stack in front of
them (F>1) and the lift-input fusion (counterpart of
`veon_tpu/nn/alignnet.py`): channel-last 3D (B, Z, Y, X, C). `train=True`
runs BatchNorm on batch statistics and updates its running stats (flax
semantics, `nn/layers.py` BatchNorm), the temporal stack's included: its
shared BatchNorms move once per call, in JAX's call order."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import PropagationConfig
from ..ops.deform_stencil import deform_stencil, sample_grid
from ..ops.grid_sample import grid_sample_3d
from ..utils import tracing
from .layers import BatchNorm, CatFusionLift, Conv3d
from .rematutil import RematSpec, remat_wrap
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


class TemporalDeformable(nn.Module):
    """3D deformable attention from a reference feature into another frame's
    feature: learned offsets, num_heads x num_samples trilinear taps.
    feat layout (B, Z, Y, X, C).

    Offsets are bounded by tanh(.)/size, so every sample lands within
    +-0.5 cell of its own voxel and trilinear sampling reduces to a fixed
    3x3x3 stencil with per-sample hat weights (use_stencil=True, the
    model's form: `ops/deform_stencil.py`, its CUDA kernel on the card,
    the plain version's gradients); use_stencil=False is the general gather through
    `grid_sample_3d` with border padding, kept for the cross-check. Dtypes
    of every intermediate follow JAX's promotion: offsets in the compute
    dtype, the sampling grid, hat weights and weighted sums in fp32, the
    softmax in fp32 cast back to the compute dtype."""

    def __init__(self, dim: int, num_heads: int = 4, num_samples: int = 8,
                 use_stencil: bool = True, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.num_samples, self.use_stencil = num_heads, num_samples, use_stencil
        self.key_value_proj = Conv3d(dim, dim * 2, 1, bias=True, dtype=dtype)
        self.query_proj = Conv3d(dim, dim, 1, bias=True, dtype=dtype)
        self.offset_conv1 = Conv3d(dim, dim, 3, bias=True, dtype=dtype)
        self.offset_conv2 = Conv3d(dim, num_heads * num_samples * 3, 3, bias=False, dtype=dtype)
        self.out_proj = Conv3d(dim, dim, 1, bias=True, dtype=dtype)
        self.final_norm = BatchNorm(dim)

    def forward(self, feat_prev, feat_curr, train: bool = False):
        B, D, H, W, C = feat_curr.shape
        nh, ns = self.num_heads, self.num_samples
        hd = C // nh
        kv = self.key_value_proj(feat_prev)
        query = self.query_proj(feat_curr)
        off = torch.tanh(self.offset_conv2(F.gelu(self.offset_conv1(feat_curr))))
        if self.use_stencil:
            fused = deform_stencil(off, query, kv, nh, ns)
        else:
            _base, grid_zyx = sample_grid(off.reshape(B, D, H, W, nh, ns, 3))
            q = query.reshape(B, D, H, W, nh, hd)
            kvh = kv.reshape(B, D, H, W, nh, 2 * hd)
            grid = grid_zyx.flip(-1)  # (x, y, z)
            kv_h = kvh.permute(0, 4, 1, 2, 3, 5).reshape(B * nh, D, H, W, 2 * hd)
            grid_h = grid.permute(0, 4, 1, 2, 3, 5, 6).reshape(B * nh, D, H, W, ns, 3)
            sampled = grid_sample_3d(kv_h, grid_h, align_corners=True, padding_mode="border")
            sampled = sampled.reshape(B, nh, D, H, W, ns, 2 * hd)
            key, value = sampled[..., :hd], sampled[..., hd:]
            qh = q.permute(0, 4, 1, 2, 3, 5) * hd ** -0.5
            dt = torch.promote_types(qh.dtype, key.dtype)
            attn = torch.einsum("bmdhwc,bmdhwsc->bmdhws", qh.to(dt), key.to(dt))
            attn = torch.softmax(attn.float(), -1).to(q.dtype)
            fused = torch.einsum("bmdhws,bmdhwsc->bmdhwc", attn.to(dt), value.to(dt))
            fused = fused.permute(0, 2, 3, 4, 1, 5).reshape(B, D, H, W, C)
        return F.relu(self.final_norm(self.out_proj(fused), train))


class TemporalFusion(nn.Module):
    """The multi-frame fusion in front of the 3D ResBlocks: `before_fusion`
    on every frame, a pairwise cat-conv chain over the previous frames
    taken newest-last (t_fuse_0 .. t_fuse_{T-2}), the last t_fuse merging
    the current frame into a reference feature, one shared deformable
    attention applied twice (into the current frame and into the merged
    previous frames), and `t_final` over the three. With train=True each
    call moves its BatchNorm's running stats: `before_fusion`'s F times
    (current frame first), `t_deform.final_norm`'s twice, as flax does."""

    def __init__(self, dim: int, num_prev: int, dtype=torch.float32):
        super().__init__()
        self.before_fusion = ConvBN3D(dim, dim, relu=False, dtype=dtype)
        for i in range(num_prev):
            self.add_module(f"t_fuse_{i}", ConvBN3D(2 * dim, dim, relu=False, dtype=dtype))
        self.t_deform = TemporalDeformable(dim, dtype=dtype)
        self.t_final = ConvBN3D(3 * dim, dim, relu=False, dtype=dtype)

    def forward(self, cur, prevs: List[torch.Tensor], train: bool = False):
        cur = self.before_fusion(cur, train)
        prevs = [self.before_fusion(p, train) for p in prevs]
        prev_feat, idx = prevs[-1], 0
        for f in prevs[-2::-1]:
            prev_feat = getattr(self, f"t_fuse_{idx}")(torch.cat([f, prev_feat], -1), train)
            idx += 1
        ref = getattr(self, f"t_fuse_{idx}")(torch.cat([cur, prev_feat], -1), train)
        d1 = self.t_deform(ref, cur, train)
        d2 = self.t_deform(ref, prev_feat, train)
        return self.t_final(torch.cat([ref, d1, d2], -1), train)


class AlignNet3D(nn.Module):
    """Temporal fusion (num_temporal > 1), 3D ResBlocks and the occupancy /
    CLIP-embedding heads on the lifted voxels; each ResBlock is one
    recomputed region under `remat`."""

    def __init__(self, cfg: PropagationConfig, clip_outdim: int, num_temporal: int = 1,
                 dtype=torch.float32, remat: RematSpec = False):
        super().__init__()
        self.remat = remat
        if num_temporal > 1:
            self.temporal_fusion = TemporalFusion(cfg.dim, num_temporal - 1, dtype)
        self.res3d = stack(cfg.layer_depth, block=lambda: ResBlock3D(cfg.dim, dtype))
        self.occupancy_pred = PredHead3DOcc(cfg.dim, 2, dtype)
        self.feat_pred = PredHead3DSem(cfg.dim, clip_outdim, dtype)

    def forward(self, x, occ_feat_prevs: Optional[List[torch.Tensor]] = None,
                train: bool = False) -> Dict[str, torch.Tensor]:
        if occ_feat_prevs:
            with tracing.span("model.temporal_fusion"):
                x = self.temporal_fusion(x, occ_feat_prevs, train)
        for body in self.res3d:
            x = remat_wrap(body["block"], self.remat)(x, train)
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
