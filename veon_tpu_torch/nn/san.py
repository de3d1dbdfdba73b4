"""SAN region-wise side adapter: query-token ViT + MLP mask decoder
(counterpart of `veon_tpu/nn/san.py`), inference path."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..configs.base import SANConfig
from ..ops.resize import resize_bicubic
from ..utils import graphs
from .layers import MLP, AddFusion, Conv2d
from .rematutil import RematSpec, remat_wrap
from .vit import TimmBlock, stack


class MLPMaskDecoder(nn.Module):
    """Query / pixel / attn-bias MLP branches.
    query (B, Q, C), x (B, h, w, C) -> mask_preds (B, Q, h, w),
    attn_bias (B, layers, heads, Q, h, w)."""

    def __init__(self, in_dim: int, total_heads: int, total_layers: int, embed_channels: int,
                 mlp_channels: int, mlp_num_layers: int, dtype=torch.float32):
        super().__init__()
        self.total_heads, self.total_layers = total_heads, total_layers
        self.embed_channels = embed_channels
        self.query_mlp = MLP(in_dim, mlp_channels, embed_channels, mlp_num_layers, dtype)
        self.pix_mlp = MLP(in_dim, mlp_channels, embed_channels, mlp_num_layers, dtype)
        self.attn_mlp = MLP(in_dim, mlp_channels, embed_channels * total_heads * total_layers,
                            mlp_num_layers, dtype)
        # torch nn.Linear(1, 1) on the trailing singleton: a scalar affine
        self.bias_scaling_w = nn.Parameter(torch.ones(()))
        self.bias_scaling_b = nn.Parameter(torch.zeros(()))

    def forward(self, query, x):
        B, h, w, _ = x.shape
        q = self.query_mlp(query)
        mask_preds = torch.einsum("bqc,bhwc->bqhw", q, self.pix_mlp(x))
        attn = self.attn_mlp(x).reshape(B, h, w, self.total_layers, self.total_heads,
                                        self.embed_channels)
        attn_bias = torch.einsum("bqc,bhwlnc->blnqhw", q, attn)
        attn_bias = (attn_bias * self.bias_scaling_w.to(attn_bias.dtype)
                     + self.bias_scaling_b.to(attn_bias.dtype))
        return mask_preds, attn_bias


class SideAdapterNetwork(nn.Module):
    """RegionwiseSideAdapterNetwork: images (B, H, W, 3) + CLIP feats ->
    (mask_preds (B,Q,h,w), attn_bias (B,heads,Q,h,w), [pix (B,h,w,C)])."""

    def __init__(self, cfg: SANConfig, dtype=torch.float32, remat: RematSpec = False):
        super().__init__()
        c = self.cfg = cfg
        self.remat = remat
        sw = c.side_width
        self.fusion = dict(c.fusion_map)
        fuse_idxs = sorted(self.fusion)
        if fuse_idxs != list(range(len(fuse_idxs))):
            raise ValueError(f"fusion blocks must be a prefix 0..k: {c.fusion_map}")
        n_fused = len(fuse_idxs) - 1
        n_plain = c.side_depth - n_fused - 1
        p = c.side_patch_size
        self.patch_embed = Conv2d(3, sw, p, stride=p, dtype=dtype)
        self.pos_embed = nn.Parameter(
            torch.zeros(c.side_pretrain_grid[0] * c.side_pretrain_grid[1], sw))
        self.query_embed = nn.Parameter(torch.zeros(c.num_queries, sw))
        self.query_pos_embed = nn.Parameter(torch.zeros(c.num_queries, sw))
        self.fusion_layer_0 = AddFusion(c.clip_width, sw, dtype=dtype)
        self.fused_blocks = stack(
            n_fused, block=lambda: TimmBlock(sw, c.side_heads, dtype=dtype),
            fusion=lambda: AddFusion(c.clip_width, sw, dtype=dtype))
        self.plain_blocks = stack(n_plain, block=lambda: TimmBlock(sw, c.side_heads, dtype=dtype))
        self.last_block = TimmBlock(sw, c.side_heads, dtype=dtype)
        self.mask_decoder = MLPMaskDecoder(
            sw, c.attn_bias_heads, c.attn_bias_layers, c.attn_bias_embed_channels,
            c.attn_bias_mlp_channels, c.attn_bias_mlp_num_layers, dtype=dtype)

    def forward(self, images, clip_feats: Dict[str, torch.Tensor]):
        return graphs.region("side_adapter", self._forward, images, clip_feats)

    def _forward(self, images, clip_feats):
        c = self.cfg
        B, H, W, _ = images.shape
        p = c.side_patch_size
        h, w = H // p, W // p
        L = h * w
        x = self.patch_embed(images).reshape(B, L, c.side_width)
        pos = self.pos_embed
        if (h, w) != tuple(c.side_pretrain_grid):
            g = pos.reshape(c.side_pretrain_grid[0], c.side_pretrain_grid[1], -1)
            pos = resize_bicubic(g, (h, w)).reshape(L, -1)
        full_pos = torch.cat([self.query_pos_embed, pos], 0).to(x.dtype)[None]
        x = torch.cat([self.query_embed.to(x.dtype).expand(B, -1, -1), x], 1) + full_pos

        patches = self.fusion_layer_0(x[:, -L:], clip_feats[str(self.fusion[0])], (h, w))
        x = torch.cat([x[:, :-L], patches], 1)

        def fused(body, x, clip):  # one scan body: block, CLIP fusion, pos re-add
            x = body["block"](x)
            patches = body["fusion"](x[:, -L:], clip, (h, w))
            return torch.cat([x[:, :-L], patches], 1) + full_pos

        def plain(body, x):
            return body["block"](x) + full_pos

        for i, body in enumerate(self.fused_blocks):
            x = remat_wrap(fused, self.remat)(body, x, clip_feats[str(self.fusion[i + 1])])
        for body in self.plain_blocks:
            x = remat_wrap(plain, self.remat)(body, x)
        x = self.last_block(x)
        query, pix = x[:, :-L], x[:, -L:].reshape(B, h, w, c.side_width)
        mask_preds, attn_bias = self.mask_decoder(query, pix)
        return mask_preds, attn_bias[:, 0], [pix]
