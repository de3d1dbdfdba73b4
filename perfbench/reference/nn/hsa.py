"""High-resolution side adaptor (counterpart of `veon_tpu/nn/hsa.py`):
patch-embed the full-res image, conv-FFN blocks with CLIP-feature
injection, and a rear block emitting factorized attention biases for the
deep CLIP trunk plus a supp map for the lift."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.base import HSAConfig
from ..ops.resize import resize_bilinear, resize_nearest
from .layers import Conv2d, ConvFFNBlock, Dense, FeedForward, LayerNorm
from .vit import stack


class HSABlock(nn.Module):
    """x = ConvFFN(ln_3(x)) + x; x += nearest-resize(neck_add(clip)); ln_4."""

    def __init__(self, dim: int, mlp_dim: int, clip_dim: int, dtype=torch.float32):
        super().__init__()
        self.ln_3 = LayerNorm(dim)
        self.ff = ConvFFNBlock(dim, mlp_dim, dtype=dtype)
        self.neck_add = Dense(clip_dim, dim, bias=False, dtype=dtype)
        self.ln_4 = LayerNorm(dim)

    def forward(self, x, clip_add, grid_hw: Tuple[int, int]):
        x = self.ff(self.ln_3(x), grid_hw) + x
        off = resize_nearest(self.neck_add(clip_add), grid_hw)
        return self.ln_4(x + off.reshape(x.shape[0], -1, x.shape[-1]))


class AttnManipulateBlock(nn.Module):
    """ConvFFN -> heads for the attention factors (A, B, L, heads, dh) and
    the supp map (B, Hs, Ws, C)."""

    def __init__(self, dim: int, mlp_dim: int, heads: int, dim_head: int, attn_layers: int,
                 supp_dim: int, dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.attn_layers = heads, dim_head, attn_layers
        self.supp_dim = supp_dim
        self.ln_3 = LayerNorm(dim)
        self.ff = ConvFFNBlock(dim, mlp_dim, out_dim=mlp_dim, dtype=dtype)
        self.ln_4 = LayerNorm(mlp_dim)
        self.head_attn = FeedForward(mlp_dim, mlp_dim, attn_layers * heads * dim_head, dtype)
        self.head_supp = FeedForward(mlp_dim, mlp_dim, supp_dim, dtype)

    def forward(self, x, side_hw, clip_hw):
        B = x.shape[0]
        H, W = side_hw
        h, w = clip_hw
        y = self.ln_4(self.ff(self.ln_3(x), side_hw))
        attns = resize_bilinear(self.head_attn(y).reshape(B, H, W, -1), (h, w))
        attns = attns.reshape(B, h * w, self.attn_layers, self.heads, self.dim_head)
        supp = self.head_supp(y).reshape(B, H, W, self.supp_dim)
        return attns.permute(2, 0, 1, 3, 4), supp


class HighresSideAdaptor(nn.Module):
    """images (B, H, W, 3) + CLIP feats -> (factors (A, B, L, heads, dh),
    supp (B, Hs, Ws, supp_dim))."""

    def __init__(self, cfg: HSAConfig, dtype=torch.float32):
        super().__init__()
        c = self.cfg = cfg
        ph, pw = c.patch_shape
        self.patch_embed = Conv2d(3, c.dim, (ph, pw), stride=(ph, pw), dtype=dtype)
        self.pre_norm = LayerNorm(c.dim)
        self.hsa_blocks = stack(len(c.fusion_map),
                                block=lambda: HSABlock(c.dim, c.mlp_dim, c.clip_dim, dtype))
        self.rear_block = AttnManipulateBlock(c.dim, c.mlp_dim, c.num_heads, c.manip_dim_head,
                                              c.manip_attn_layers, c.manip_supp_dim, dtype)

    def forward(self, images, clip_feats: Dict[str, torch.Tensor]):
        c = self.cfg
        B, H, W, _ = images.shape
        gh, gw = H // c.patch_shape[0], W // c.patch_shape[1]
        x = self.pre_norm(self.patch_embed(images).reshape(B, gh * gw, c.dim))
        for body, (_blk, _ca, add_id) in zip(self.hsa_blocks, c.fusion_map):
            x = body["block"](x, clip_feats[str(add_id)], (gh, gw))
        clip_hw = tuple(clip_feats[str(c.fusion_map[0][1])].shape[1:3])
        return self.rear_block(x, (gh, gw), clip_hw)
