"""Shared building blocks, channel-last (counterpart of `veon_tpu/nn/layers.py`).

Parameters are stored fp32 under the flax module names (`ckpt/from_jax.py`
maps a flax tree onto them mechanically). `dtype` is the compute precision:
matmul and conv inputs are cast to it (bf16 on the serving path), while
LayerNorm and BatchNorm run in fp32 and return the input's dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear


def quick_gelu(x):
    """OpenAI CLIP activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x):
    """Erf-form GELU (torch nn.GELU default)."""
    return F.gelu(x)


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Dense(nn.Module):
    """flax nn.Dense: y = x @ W^T + b with W stored (out, in)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        _cast(self.bias, self.dtype))


class Embed(nn.Module):
    """flax nn.Embed: rows of `weight` (num_embeddings, features) looked up
    by integer ids, returned in `dtype`."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids):
        return F.embedding(ids.long(), self.weight).to(self.dtype)


class Conv2d(nn.Module):
    """flax nn.Conv on (B, H, W, C); weight stored (out, in, kh, kw)."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.dtype, self.stride, self.padding = dtype, stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype), self.weight.to(self.dtype),
                     _cast(self.bias, self.dtype), self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.Module):
    """flax nn.ConvTranspose with kernel == stride on (B, H, W, C). The
    weight is torch's (in, out, kh, kw), i.e. the flax kernel spatially
    flipped (`ckpt/from_jax.py`)."""

    def __init__(self, cin: int, cout: int, kernel: int, dtype=torch.float32):
        super().__init__()
        self.dtype, self.stride = dtype, kernel
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(self.dtype),
                               self.weight.to(self.dtype), self.bias.to(self.dtype),
                               stride=self.stride)
        return y.permute(0, 2, 3, 1)


class Conv3d(nn.Module):
    """flax nn.Conv on (B, Z, Y, X, C); weight stored (out, in, kd, kh, kw)."""

    def __init__(self, cin: int, cout: int, kernel: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.padding = dtype, kernel // 2
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        y = F.conv3d(x.permute(0, 4, 1, 2, 3).to(self.dtype), self.weight.to(self.dtype),
                     _cast(self.bias, self.dtype), padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed in fp32, returned in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis in fp32 with flax nn.BatchNorm's
    semantics (momentum 0.9, epsilon 1e-5). train=False normalises with the
    running stats; train=True with the batch's BIASED variance, computed as
    E[x^2] - E[x]^2 (flax's fast variance, clipped at 0), and moves the
    running stats toward the batch stats, in place:
    stat = 0.9 * stat + 0.1 * batch_stat (the biased variance, unlike
    torch.nn.BatchNorm's unbiased running variance)."""

    momentum = 0.9

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x, train: bool = False):
        xf = x.float()
        if train:
            dims = tuple(range(x.dim() - 1))
            mean, mean2 = xf.mean(dims), (xf * xf).mean(dims)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            self._move(mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (xf - mean) * scale + self.bias
        return y.to(x.dtype)

    @torch.no_grad()
    def _move(self, mean, var):
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)


class LoRADense(nn.Module):
    """Dense whose params sit under `base`, as in the flax tree, with
    optional LoRA adapters: y = base(x) + ((x @ A) @ B) * (alpha / r).
    lora_A (in, r) and lora_B (r, out) are fp32 params cast to the compute
    dtype in the product; `init_random_` gives A flax's
    variance_scaling(1/3, fan_in, uniform) and B zeros. With lora_r=0 (the
    serving towers, adapters folded at load) it is the Dense alone."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, lora_r: int = 0, lora_alpha: float = 1.0):
        super().__init__()
        self.dtype, self.lora_r = dtype, lora_r
        self.base = Dense(in_features, out_features, bias, dtype)
        if lora_r > 0:
            self.scaling = lora_alpha / lora_r
            self.lora_A = nn.Parameter(torch.empty(in_features, lora_r))
            self.lora_B = nn.Parameter(torch.zeros(lora_r, out_features))

    def forward(self, x):
        y = self.base(x)
        if self.lora_r > 0:
            x = x.to(self.dtype)
            y = y + ((x @ self.lora_A.to(self.dtype)) @ self.lora_B.to(self.dtype)) * self.scaling
        return y


class MLP(nn.Module):
    """ReLU MLP: relu between layers, linear last (layers named layers_i)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layers_{i}", Dense(dims[i], dims[i + 1], dtype=dtype))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class TransformerMLP(nn.Module):
    """ViT FFN: fc1 -> act -> fc2, with optional LoRA on both linears."""

    def __init__(self, dim: int, hidden_dim: int, act: Callable = gelu_exact,
                 dtype=torch.float32, lora_r: int = 0, lora_alpha: float = 1.0):
        super().__init__()
        self.act = act
        self.fc1 = LoRADense(dim, hidden_dim, dtype=dtype, lora_r=lora_r, lora_alpha=lora_alpha)
        self.fc2 = LoRADense(hidden_dim, dim, dtype=dtype, lora_r=lora_r, lora_alpha=lora_alpha)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class AddFusion(nn.Module):
    """SAN fusion: LN + 1x1 proj of the CLIP map, bilinear resize to the
    side-adapter grid, added to the patch tokens.
    x: (B, L, C_side) tokens; y: (B, h, w, C_clip)."""

    def __init__(self, clip_dim: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.ln = LayerNorm(clip_dim, eps=1e-6)
        self.proj = Dense(clip_dim, out_channels, dtype=dtype)

    def forward(self, x, y, spatial_shape: Tuple[int, int]):
        y = resize_bilinear(self.proj(self.ln(y)), spatial_shape, align_corners=False)
        return x + y.reshape(y.shape[0], -1, y.shape[-1])


class CatFusionLift(nn.Module):
    """Lift fusion: concat(supp, clip) -> LN + 1x1 to C/4, clip -> LN + 1x1
    to 3C/4, concat, relu. x1: (B, h1, w1, C1); x2: (B, h2, w2, C2)."""

    def __init__(self, c1: int, c2: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        out_p1 = out_channels // 4
        self.ln1 = LayerNorm(c1 + c2, eps=1e-6)
        self.proj1 = Dense(c1 + c2, out_p1, dtype=dtype)
        self.ln2 = LayerNorm(c2, eps=1e-6)
        self.proj2 = Dense(c2, out_channels - out_p1, dtype=dtype)

    def forward(self, x1, x2, spatial_shape: Tuple[int, int]):
        x2 = resize_bilinear(x2, spatial_shape, align_corners=False)
        x1 = resize_bilinear(x1, spatial_shape, align_corners=False)
        y1 = self.proj1(self.ln1(torch.cat([x1, x2], dim=-1)))
        y2 = self.proj2(self.ln2(x2))
        return F.relu(torch.cat([y1, y2], dim=-1))


class ConvFFNBlock(nn.Module):
    """HSA conv-FFN: 3x3 conv -> gelu -> LN -> 3x3 conv -> LN on the token
    grid. x: (B, L, C) tokens with L == H*W of `size`."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int = -1, dtype=torch.float32):
        super().__init__()
        out_dim = dim if out_dim == -1 else out_dim
        self.conv1 = Conv2d(dim, hidden_dim, 3, padding=1, dtype=dtype)
        self.ln1 = LayerNorm(hidden_dim)
        self.conv2 = Conv2d(hidden_dim, out_dim, 3, padding=1, dtype=dtype)
        self.ln2 = LayerNorm(out_dim)

    def forward(self, x, size: Tuple[int, int]):
        B, L, C = x.shape
        g = self.ln1(F.gelu(self.conv1(x.reshape(B, size[0], size[1], C))))
        g = self.ln2(self.conv2(g))
        return g.reshape(B, L, g.shape[-1])


class FeedForward(nn.Module):
    """HSA head FFN: LN -> fc -> gelu -> fc."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int = -1, dtype=torch.float32):
        super().__init__()
        out_dim = dim if out_dim == -1 else out_dim
        self.ln = LayerNorm(dim)
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, out_dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.ln(x))))


_NORMAL_002 = {"class_embedding", "positional_embedding", "proj_kernel",
               "pos_embed", "query_embed", "query_pos_embed", "text_projection",
               "relative_position_bias_table"}


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random initialisation standing in for real weights, with the
    flax initialisers' scales: fan-in-scaled normal kernels, zero biases,
    unit norm scales and LayerScales, N(0, 0.02) embeddings and BEiT
    relative-position tables (timm's init; flax's is zeros, which would
    leave the bias path idle), token embeddings N(0, 1/features) as
    flax's Embed; LoRA adapters as flax's (A uniform in +-1/sqrt(fan_in),
    B zeros)."""
    for m in module.modules():
        w = getattr(m, "weight", None)
        if isinstance(m, Embed):
            w.copy_(torch.randn(w.shape, generator=generator, device=w.device) / math.sqrt(w.shape[1]))
        if isinstance(m, (Dense, Conv2d, Conv3d, ConvTranspose2d)):
            fan_in = w[0].numel() if not isinstance(m, ConvTranspose2d) else w.shape[0]
            w.copy_(torch.randn(w.shape, generator=generator, device=w.device) / math.sqrt(fan_in))
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "lora_A":  # flax variance_scaling(1/3, fan_in, uniform)
            bound = 1.0 / math.sqrt(p.shape[0])
            p.copy_((torch.rand(p.shape, generator=generator, device=p.device) * 2 - 1) * bound)
        elif leaf == "lora_B":
            p.zero_()
        elif leaf in _NORMAL_002:
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * 0.02)
        elif leaf == "cls_token":
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * 1e-6)
    return module
