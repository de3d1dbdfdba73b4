"""ViT cores (counterpart of `veon_tpu/nn/vit.py`): the CLIP visual trunk
and recognition head, the CLIP text tower, timm-style blocks (side
adapter), and the DINOv2 trunk. Batch-first tokens (B, L, C); images channel-last (B, H, W, 3).

The JAX side runs identical blocks under `nn.scan` with stacked params;
here a stack is a `ModuleList` of per-layer bodies named as the scan body's
children, so `ckpt/from_jax.py` unstacks axis 0 into the list index.

Each run of CLIP blocks (the trunk's segments, the rec head's deep layers,
their rerun) is one `clip.blocks` span of `utils/tracing.py`, which adds
its token rows times its layers to the counter `clip_token_layers`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..ops.resize import (adaptive_max_pool2d, resize_bicubic, resize_bicubic_scaled,
                          resize_bilinear)
from ..utils import tracing
from .attention import FusedQKVAttention, SimpleAttention
from .layers import Conv2d, Embed, LayerNorm, TransformerMLP, quick_gelu
from .rematutil import RematSpec, remat_wrap


def stack(n: int, **make) -> nn.ModuleList:
    """n scan bodies; `make` maps each body child name to a factory."""
    return nn.ModuleList(nn.ModuleDict({k: f() for k, f in make.items()}) for _ in range(n))


def resize_pos_embed_2d(posemb, src_grid, tgt_grid, num_prefix: int = 1):
    """Bicubic pos-embed resize, align_corners=False: (P + Hs*Ws, C) -> (P + Ht*Wt, C)."""
    if tuple(src_grid) == tuple(tgt_grid):
        return posemb
    prefix, grid = posemb[:num_prefix], posemb[num_prefix:]
    grid = resize_bicubic(grid.reshape(src_grid[0], src_grid[1], -1), tgt_grid)
    return torch.cat([prefix, grid.reshape(tgt_grid[0] * tgt_grid[1], -1)], 0)


def dinov2_pos_embed(posemb, src_grid: int, tgt_grid, offset: float = 0.1):
    """DINOv2's scale-factor pos-embed interpolation: (1 + S*S, C) -> (1 + Ht*Wt, C)."""
    ht, wt = tgt_grid
    if src_grid * src_grid == ht * wt and ht == wt:
        return posemb
    grid = posemb[1:].reshape(src_grid, src_grid, -1)
    scales = (float(ht + offset) / src_grid, float(wt + offset) / src_grid)
    grid = resize_bicubic_scaled(grid, (ht, wt), scales)
    return torch.cat([posemb[:1], grid.reshape(ht * wt, -1)], 0)


class CLIPBlock(nn.Module):
    """open_clip ResidualAttentionBlock with QuickGELU; `mode="cross"` is the
    rec head's cross-attention sharing this block's parameters."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = FusedQKVAttention(width, heads, dtype=dtype)
        self.ln_2 = LayerNorm(width)
        self.mlp = TransformerMLP(width, int(width * mlp_ratio), act=quick_gelu, dtype=dtype)

    def forward(self, x, attn_mask=None, mode: str = "self", mem=None, extra_qk=None):
        if mode == "self":
            x = x + self.attn(self.ln_1(x), bias=attn_mask, extra_qk=extra_qk)
        else:
            x = x + self.attn(self.ln_1(x), bias=attn_mask, mode="cross", mem=self.ln_1(mem))
        return x + self.mlp(self.ln_2(x))


class ScanBlocks(nn.Module):
    """`length` identical blocks run in sequence (flax ScanBlocks), each
    block one recomputed region under `remat` (`nn/rematutil.py`)."""

    def __init__(self, length: int, make, remat: RematSpec = False):
        super().__init__()
        self.blocks = stack(length, block=make)
        self.remat = remat

    def forward(self, x):
        for body in self.blocks:
            x = remat_wrap(body["block"], self.remat)(x)
        return x


class CLIPVisualExtractor(nn.Module):
    """CLIP ViT shallow trunk saving the layers named in `save_layers`.
    Returns {"0": (B,h,w,C), "0_cls": (B,1,C), ...} per saved layer."""

    def __init__(self, width: int, heads: int, num_layers: int, patch_size: int,
                 pretrain_grid: Tuple[int, int], save_layers: Tuple[int, ...] = (),
                 dtype=torch.float32, remat: RematSpec = False):
        super().__init__()
        self.width, self.patch_size, self.pretrain_grid = width, patch_size, pretrain_grid
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size, bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(pretrain_grid[0] * pretrain_grid[1] + 1, width))
        self.ln_pre = LayerNorm(width)
        self.saves = tuple(sorted(set(save_layers) | {0, num_layers}))
        for a, b in zip(self.saves[:-1], self.saves[1:]):
            self.add_module(f"segment_{a}_{b}", ScanBlocks(
                b - a, lambda: CLIPBlock(width, heads, dtype=dtype), remat))

    def forward(self, images) -> Dict[str, torch.Tensor]:
        B, H, W, _ = images.shape
        h, w = H // self.patch_size, W // self.patch_size
        x = self.conv1(images).reshape(B, h * w, self.width)
        cls = self.class_embedding.to(x.dtype).expand(B, 1, self.width)
        pos = resize_pos_embed_2d(self.positional_embedding, self.pretrain_grid, (h, w))
        x = self.ln_pre(torch.cat([cls, x], 1) + pos.to(x.dtype)[None])
        feats = {}

        def save(i, t):
            feats[str(i)] = t[:, 1:].reshape(B, h, w, self.width)
            feats[f"{i}_cls"] = t[:, :1]

        save(0, x)
        with tracing.span("clip.blocks"):
            tracing.count("clip_token_layers", B * x.shape[1] * self.saves[-1])
            for a, b in zip(self.saves[:-1], self.saves[1:]):
                x = getattr(self, f"segment_{a}_{b}")(x)
                save(b, x)
        return feats


def format_attn_biases(attn_bias, target_hw, num_heads: int, method: str = "max"):
    """SAN attn-bias formatting: (B, Hb, Q, h, w) -> (B, num_heads, Q, Ht*Wt),
    the spatial map adaptive-max ("max") or bilinearly ("bilinear",
    align_corners=False) downsampled, heads broadcast when Hb == 1; another
    method raises ValueError, as in JAX."""
    B, hb, Q, h, w = attn_bias.shape
    x = attn_bias.reshape(B, hb * Q, h, w).permute(0, 2, 3, 1)
    if method == "max":
        x = adaptive_max_pool2d(x, target_hw)
    elif method == "bilinear":
        x = resize_bilinear(x, target_hw, align_corners=False)
    else:
        raise ValueError(method)
    ht, wt = target_hw
    x = x.permute(0, 3, 1, 2).reshape(B, hb, Q, ht * wt)
    if hb == 1 and num_heads > 1:
        x = x.expand(B, num_heads, Q, ht * wt)
    return x


def rec_self_attn_mask(bias):
    """The dense additive mask of REC_CROSS_ATTN=False (`visual.py:240-253`),
    bias (B, heads, Q, L) -> (B, heads, Q+1+L, Q+1+L) over the joint [sos,
    cls, pixels] sequence: no token attends to the sos tokens (-100) but
    each sos to itself (0); the sos tokens do not attend to cls (-100); the
    sos -> pixel entries carry the SAN bias. -100, not -inf, as the
    reference. Its bytes: B x heads x (Q+1+L)^2 x the bias's element size
    (VEON-B on the half-resolution trunk, L = 16 x 44 = 704: 6 x 12 x 805^2
    x 4 B = 186.6 MB in fp32)."""
    B, nh, Q, L = bias.shape
    S = Q + 1 + L
    base = torch.zeros(S, S, dtype=bias.dtype, device=bias.device)
    base[:, :Q] = -100.0
    base[torch.arange(Q), torch.arange(Q)] = 0.0
    base[:Q, Q] = -100.0
    top = torch.cat([base[:Q, :Q + 1].expand(B, nh, Q, Q + 1), bias], -1)
    return torch.cat([top, base[Q:].expand(B, nh, 1 + L, S)], -2)


class CLIPRecHead(nn.Module):
    """CLIP deep trunk with attention bias:
      * forward(feats, attn_bias) -> normalized mask embeddings (B, Q, out_dim):
        cross_attn=True (REC_CROSS_ATTN) interleaves the sos cross-attention
        with the patch trunk; cross_attn=False runs [sos, cls, pixels] as one
        self-attention sequence under `rec_self_attn_mask`, through the same
        blocks (one parameter tree, so one checkpoint loads either way);
      * update_remaining(feats, attn_factors) -> feats extended to the last
        layer plus "clip_feat_proj" (B, h, w, out_dim), the same in both modes.
    Each layer is one recomputed region under `remat`.
    """

    def __init__(self, width: int, heads: int, first_layer_idx: int, total_layers: int,
                 out_dim: int, sos_token_num: int = 100, downsample_method: str = "max",
                 cross_attn: bool = True, dtype=torch.float32, remat: RematSpec = False):
        super().__init__()
        self.heads, self.first_layer_idx = heads, first_layer_idx
        self.total_layers, self.sos_token_num = total_layers, sos_token_num
        self.downsample_method, self.cross_attn, self.remat = downsample_method, cross_attn, remat
        self.num_blocks = total_layers - first_layer_idx
        self.resblocks = stack(self.num_blocks, block=lambda: CLIPBlock(width, heads, dtype=dtype))
        self.ln_post = LayerNorm(width)
        self.proj_kernel = nn.Parameter(torch.zeros(width, out_dim))

    def _tokens(self, feats):
        k = self.first_layer_idx
        pix = feats[str(k)]
        B, h, w, C = pix.shape
        return torch.cat([feats[f"{k}_cls"], pix.reshape(B, h * w, C)], 1), (B, h, w, C)

    def forward(self, feats: Dict[str, torch.Tensor], attn_bias, normalize: bool = True):
        x, (B, h, w, C) = self._tokens(feats)
        Q = self.sos_token_num
        sos = x[:, :1].expand(B, Q, C)
        bias = format_attn_biases(attn_bias, (h, w), self.heads, self.downsample_method)
        with tracing.span("clip.blocks"):
            tracing.count("clip_token_layers", B * (Q + x.shape[1]) * self.num_blocks)
            if self.cross_attn:
                def layer(blk, sos, x):
                    return blk(sos, attn_mask=bias, mode="cross", mem=x[:, 1:]), blk(x)

                for body in self.resblocks:
                    sos, x = remat_wrap(layer, self.remat)(body["block"], sos, x)
            else:
                mask = rec_self_attn_mask(bias)
                x = torch.cat([sos, x], 1)
                for body in self.resblocks:
                    x = remat_wrap(body["block"], self.remat)(x, attn_mask=mask)
                sos = x[:, :Q]
        sos = self.ln_post(sos)
        sos = sos @ self.proj_kernel.to(sos.dtype)
        if normalize:
            sos = sos / torch.linalg.vector_norm(sos, dim=-1, keepdim=True)
        return sos

    def update_remaining(self, feats: Dict[str, torch.Tensor],
                         attn_factors: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Re-run the deep trunk with the HSA attention bias in factorized
        form: attn_factors (A>=n, B, L, heads, dh), the dense bias being
        f @ f^T per layer and head, zero on the cls row/column. (The JAX scan
        also runs a discarded 1-token sos cross-attention; it is skipped.)"""
        x, (B, h, w, C) = self._tokens(feats)
        feats = dict(feats)
        with tracing.span("clip.blocks"):
            tracing.count("clip_token_layers", B * x.shape[1] * self.num_blocks)
            for i, body in enumerate(self.resblocks):
                f = None
                if attn_factors is not None:
                    f = torch.nn.functional.pad(attn_factors[i], (0, 0, 0, 0, 1, 0))
                x = remat_wrap(body["block"], self.remat)(x, extra_qk=f)
                idx = self.first_layer_idx + i + 1
                feats[str(idx)] = x[:, 1:].reshape(B, h, w, C)
                feats[f"{idx}_cls"] = x[:, :1]
        last = feats[str(self.total_layers)]
        feats["clip_feat_proj"] = last @ self.proj_kernel.to(last.dtype)
        return feats


class TimmBlock(nn.Module):
    """timm VisionTransformer block (norm eps 1e-6, exact GELU, fused qkv)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(width, eps=1e-6)
        self.attn = SimpleAttention(width, heads, dtype=dtype)
        self.norm2 = LayerNorm(width, eps=1e-6)
        self.mlp = TransformerMLP(width, int(width * mlp_ratio), dtype=dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class DinoBlock(nn.Module):
    """DINOv2 block with LayerScale and optional LoRA on every linear."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0, dtype=torch.float32,
                 lora_r: int = 0, lora_alpha: float = 1.0):
        super().__init__()
        lora = dict(lora_r=lora_r, lora_alpha=lora_alpha)
        self.norm1 = LayerNorm(width, eps=1e-6)
        self.attn = SimpleAttention(width, heads, dtype=dtype, **lora)
        self.ls1_gamma = nn.Parameter(torch.ones(width))
        self.norm2 = LayerNorm(width, eps=1e-6)
        self.mlp = TransformerMLP(width, int(width * mlp_ratio), dtype=dtype, **lora)
        self.ls2_gamma = nn.Parameter(torch.ones(width))

    def forward(self, x):
        y = self.attn(self.norm1(x))
        x = x + y * self.ls1_gamma.to(y.dtype)
        y = self.mlp(self.norm2(x))
        return x + y * self.ls2_gamma.to(y.dtype)


class DinoV2Trunk(nn.Module):
    """DINOv2 ViT trunk returning normed intermediate layers
    [(patch_tokens (B, L, C), cls (B, C)), ...]; lora_r > 0 puts adapters
    on every block's linears (the stage-1 trainable tower)."""

    def __init__(self, width: int, depth: int, heads: int, patch_size: int = 14,
                 pretrain_grid: int = 37, take_layers: Tuple[int, ...] = (4, 11, 17, 23),
                 interpolate_offset: float = 0.1, dtype=torch.float32, lora_r: int = 0,
                 lora_alpha: float = 1.0):
        super().__init__()
        self.width, self.patch_size, self.pretrain_grid = width, patch_size, pretrain_grid
        self.interpolate_offset = interpolate_offset
        self.patch_embed = Conv2d(3, width, patch_size, stride=patch_size, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(pretrain_grid * pretrain_grid + 1, width))
        self.norm = LayerNorm(width, eps=1e-6)
        bounds = [0] + [t + 1 for t in sorted(take_layers)]
        self.bounds = list(zip(bounds[:-1], bounds[1:]))
        for a, b in self.bounds:
            self.add_module(f"segment_{a}_{b}", ScanBlocks(
                b - a, lambda: DinoBlock(width, heads, dtype=dtype, lora_r=lora_r,
                                         lora_alpha=lora_alpha)))

    def forward(self, images) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        B, H, W, _ = images.shape
        h, w = H // self.patch_size, W // self.patch_size
        x = self.patch_embed(images).reshape(B, h * w, self.width)
        cls = self.cls_token.to(x.dtype).expand(B, 1, self.width)
        pos = dinov2_pos_embed(self.pos_embed, self.pretrain_grid, (h, w),
                               self.interpolate_offset)
        x = torch.cat([cls, x], 1) + pos.to(x.dtype)[None]
        outs = []
        for a, b in self.bounds:
            x = getattr(self, f"segment_{a}_{b}")(x)
            xn = self.norm(x)
            outs.append((xn[:, 1:], xn[:, 0]))
        return outs


class CLIPTextEncoder(nn.Module):
    """CLIP text tower: tokens (B, context_length) int -> L2-normalized
    (B, out_dim) embeddings. Token embedding plus positional embedding, the
    blocks under a causal -inf mask, ln_final, the row at the first
    maximum token id (EOT), then the plain `text_projection` matrix."""

    def __init__(self, width: int, heads: int, num_layers: int, out_dim: int,
                 vocab_size: int = 49408, context_length: int = 77, dtype=torch.float32):
        super().__init__()
        self.token_embedding = Embed(vocab_size, width, dtype=dtype)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.resblocks = stack(num_layers, block=lambda: CLIPBlock(width, heads, dtype=dtype))
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.zeros(width, out_dim))

    def forward(self, tokens, normalize: bool = True):
        x = self.token_embedding(tokens)
        x = x + self.positional_embedding.to(x.dtype)[None]
        L = x.shape[1]
        mask = torch.full((L, L), float("-inf"), device=x.device).triu(1)[None, None]
        for body in self.resblocks:
            x = body["block"](x, attn_mask=mask)
        x = self.ln_final(x)
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
        x = x @ self.text_projection.to(x.dtype)
        if normalize:
            x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x
