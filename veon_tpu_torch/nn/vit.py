"""ViT cores (counterpart of `veon_tpu/nn/vit.py`): the CLIP visual trunk
and recognition head, the CLIP text tower, timm-style blocks (side
adapter), and the DINOv2 trunk. Batch-first tokens (B, L, C); images channel-last (B, H, W, 3).

The JAX side runs identical blocks under `nn.scan` with stacked params;
here a stack is a `ModuleList` of per-layer bodies named as the scan body's
children, so `ckpt/from_jax.py` unstacks axis 0 into the list index.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..ops.resize import adaptive_max_pool2d, resize_bicubic, resize_bicubic_scaled
from .attention import FusedQKVAttention, SimpleAttention
from .layers import Conv2d, Embed, LayerNorm, TransformerMLP, quick_gelu


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
    """`length` identical blocks run in sequence (flax ScanBlocks)."""

    def __init__(self, length: int, make):
        super().__init__()
        self.blocks = stack(length, block=make)

    def forward(self, x):
        for body in self.blocks:
            x = body["block"](x)
        return x


class CLIPVisualExtractor(nn.Module):
    """CLIP ViT shallow trunk saving the layers named in `save_layers`.
    Returns {"0": (B,h,w,C), "0_cls": (B,1,C), ...} per saved layer."""

    def __init__(self, width: int, heads: int, num_layers: int, patch_size: int,
                 pretrain_grid: Tuple[int, int], save_layers: Tuple[int, ...] = (),
                 dtype=torch.float32):
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
                b - a, lambda: CLIPBlock(width, heads, dtype=dtype)))

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
        for a, b in zip(self.saves[:-1], self.saves[1:]):
            x = getattr(self, f"segment_{a}_{b}")(x)
            save(b, x)
        return feats


def format_attn_biases(attn_bias, target_hw, num_heads: int, method: str = "max"):
    """SAN attn-bias formatting: (B, Hb, Q, h, w) -> (B, num_heads, Q, Ht*Wt),
    adaptive-max downsampled, heads broadcast when Hb == 1."""
    if method != "max":
        raise NotImplementedError(f"rec downsample {method!r}: only 'max' is ported")
    B, hb, Q, h, w = attn_bias.shape
    x = attn_bias.reshape(B, hb * Q, h, w).permute(0, 2, 3, 1)
    x = adaptive_max_pool2d(x, target_hw)
    ht, wt = target_hw
    x = x.permute(0, 3, 1, 2).reshape(B, hb, Q, ht * wt)
    if hb == 1 and num_heads > 1:
        x = x.expand(B, num_heads, Q, ht * wt)
    return x


class CLIPRecHead(nn.Module):
    """CLIP deep trunk with attention bias, REC_CROSS_ATTN mode:
      * forward(feats, attn_bias) -> normalized mask embeddings (B, Q, out_dim);
      * update_remaining(feats, attn_factors) -> feats extended to the last
        layer plus "clip_feat_proj" (B, h, w, out_dim).
    """

    def __init__(self, width: int, heads: int, first_layer_idx: int, total_layers: int,
                 out_dim: int, sos_token_num: int = 100, downsample_method: str = "max",
                 cross_attn: bool = True, dtype=torch.float32):
        super().__init__()
        if not cross_attn:
            raise NotImplementedError("REC_CROSS_ATTN=False is not ported")
        self.heads, self.first_layer_idx = heads, first_layer_idx
        self.total_layers, self.sos_token_num = total_layers, sos_token_num
        self.downsample_method = downsample_method
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
        sos = x[:, :1].expand(B, self.sos_token_num, C)
        bias = format_attn_biases(attn_bias, (h, w), self.heads, self.downsample_method)
        for body in self.resblocks:
            blk = body["block"]
            sos = blk(sos, attn_mask=bias, mode="cross", mem=x[:, 1:])
            x = blk(x)
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
        for i, body in enumerate(self.resblocks):
            f = None
            if attn_factors is not None:
                f = torch.nn.functional.pad(attn_factors[i], (0, 0, 0, 0, 1, 0))
            x = body["block"](x, extra_qk=f)
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
