"""ZoeDepth-NK on a MiDaS DPT-BEiT-L-384 core, channel-last (counterpart of
`veon_tpu/nn/zoedepth.py`).

The BEiT trunk (relative-position-bias attention with the MiDaS table
resize, LayerScale, q/v-only biases), the MiDaS DPT decoder with the
"project" readout, and the ZoeDepth metric-bins head (seed bin regressor,
attractor refinement, conditional log-binomial). As in the JAX module:
the kitti-only bins head, `prev_b_embedding` frozen at the seed embedding
through the attractor loop (the adaptor comments its update out),
inv/mean attractors with alpha 1000, temperature in [0.0212, 50].

Submodules carry the flax module names, so `ckpt/from_jax.py` maps a JAX
tree onto them. The serving tower folds a LoRA checkpoint's adapters into
the base weights at load (`ckpt/convert.py` `merge_lora`), so its
`LoRADense`s carry none; the stage-1 tower (lora=True) has cfg.lora_r
adapters, alpha 1, on every block's qkv and every readout projection.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ZoeConfig
from ..ops.resize import resize_bilinear
from .attention import _merge_heads, _split_heads
from .dpt import FeatureFusionBlock
from .layers import Conv2d, ConvTranspose2d, Dense, LayerNorm, LoRADense, gelu_exact

# the window of BEiT-L-384's trained relative-position tables (384 / 16)
PRETRAIN_WINDOW = (24, 24)


@functools.lru_cache(maxsize=None)
def beit_relative_position_index(wh: int, ww: int) -> np.ndarray:
    """timm gen_relative_position_index for window (wh, ww) incl. cls:
    (L+1, L+1) int64 rows of the table extended by the three cls entries."""
    area = wh * ww
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # (2, area, area)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    num_rel = (2 * wh - 1) * (2 * ww - 1)
    idx = np.zeros((area + 1, area + 1), dtype=np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel  # cls -> all
    idx[0:, 0] = num_rel + 1  # all -> cls
    idx[0, 0] = num_rel + 2  # cls -> cls
    return idx


@functools.lru_cache(maxsize=8)
def _index_on(wh: int, ww: int, device: torch.device) -> torch.Tensor:
    """The flat relative-position index on `device`, copied once per window:
    a host copy in every block would make the host wait for the card."""
    return torch.from_numpy(beit_relative_position_index(wh, ww).reshape(-1)).to(device)


def beit_rel_pos_bias(table: torch.Tensor, pretrain_window: Tuple[int, int],
                      window: Tuple[int, int]) -> torch.Tensor:
    """table (M, H), M = (2*Wh0-1)*(2*Ww0-1) + 3 -> the (H, L+1, L+1) bias
    of the actual window (L = Wh*Ww), in the table's dtype: the trained
    sub-table resized bilinearly (align_corners=False) on its channel-last
    (2*Wh0-1, 2*Ww0-1, H) grid to the window's, the three cls entries kept,
    gathered by the index."""
    wh0, ww0 = pretrain_window
    wh, ww = window
    heads = table.shape[-1]
    sub = table[:-3]
    if (wh, ww) != (wh0, ww0):
        grid = sub.reshape(2 * wh0 - 1, 2 * ww0 - 1, heads)
        sub = resize_bilinear(grid, (2 * wh - 1, 2 * ww - 1), align_corners=False)
        sub = sub.reshape(-1, heads)
    full = torch.cat([sub, table[-3:]], 0)
    n = wh * ww + 1
    return full.t()[:, _index_on(wh, ww, table.device)].reshape(heads, n, n)


class BeitAttention(nn.Module):
    """BEiT attention: fused qkv without bias, then the q and v biases (k
    has none), one relative-position table per block. softmax(q * scale @ k
    + bias) @ v through SDPA on the pre-scaled q (scale=1.0), the fp32
    bias cast to the logits' dtype, as the JAX module adds it."""

    def __init__(self, dim: int, heads: int, pretrain_window=PRETRAIN_WINDOW,
                 dtype=torch.float32, lora_r: int = 0):
        super().__init__()
        self.heads, self.pretrain_window = heads, tuple(pretrain_window)
        self.qkv = LoRADense(dim, 3 * dim, bias=False, dtype=dtype, lora_r=lora_r)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        rows = (2 * pretrain_window[0] - 1) * (2 * pretrain_window[1] - 1) + 3
        self.relative_position_bias_table = nn.Parameter(torch.zeros(rows, heads))
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x, window: Tuple[int, int]):
        C = x.shape[-1]
        qkv = self.qkv(x)
        qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                               self.v_bias]).to(qkv.dtype)
        q, k, v = (_split_heads(t, self.heads) for t in qkv.split(C, -1))
        bias = beit_rel_pos_bias(self.relative_position_bias_table, self.pretrain_window, window)
        scale = (C // self.heads) ** -0.5
        out = F.scaled_dot_product_attention(q * scale, k, v, attn_mask=bias.to(q.dtype)[None],
                                             scale=1.0)
        return self.proj(_merge_heads(out))


class BeitBlock(nn.Module):
    """Pre-norm BEiT block (eps 1e-6) with LayerScale gamma_1 / gamma_2
    and an exact-GELU MLP."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, dtype=torch.float32,
                 lora_r: int = 0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = BeitAttention(dim, heads, dtype=dtype, lora_r=lora_r)
        self.gamma_1 = nn.Parameter(torch.ones(dim))
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp_fc1 = Dense(dim, hidden, dtype=dtype)
        self.mlp_fc2 = Dense(hidden, dim, dtype=dtype)
        self.gamma_2 = nn.Parameter(torch.ones(dim))

    def forward(self, x, window: Tuple[int, int]):
        y = self.attn(self.norm1(x), window)
        x = x + y * self.gamma_1.to(y.dtype)
        h = self.mlp_fc2(gelu_exact(self.mlp_fc1(self.norm2(x))))
        return x + h * self.gamma_2.to(h.dtype)


class BeitTrunk(nn.Module):
    """BEiT-L/16 trunk (no absolute position embedding): images (B, H, W, 3)
    -> ([hook layers' tokens (B, 1+L, C), cls first], (h, w))."""

    def __init__(self, width: int = 1024, depth: int = 24, heads: int = 16,
                 patch_size: int = 16, hooks: Tuple[int, ...] = (5, 11, 17, 23),
                 dtype=torch.float32, lora_r: int = 0):
        super().__init__()
        self.width, self.depth, self.patch_size, self.hooks = width, depth, patch_size, hooks
        self.patch_embed = Conv2d(3, width, patch_size, stride=patch_size, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        for i in range(depth):
            self.add_module(f"blocks_{i}", BeitBlock(width, heads, dtype=dtype, lora_r=lora_r))

    def forward(self, images):
        B, H, W, _ = images.shape
        h, w = H // self.patch_size, W // self.patch_size
        x = self.patch_embed(images).reshape(B, h * w, self.width)
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, self.width), x], 1)
        saved = {}
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x, (h, w))
            if i in self.hooks:
                saved[i] = x
        return [saved[i] for i in self.hooks], (h, w)


class ProjectReadout(nn.Module):
    """MiDaS "project" readout: cls concatenated onto every token, then
    Linear(2C -> C) + GELU."""

    def __init__(self, dim: int, dtype=torch.float32, lora_r: int = 0):
        super().__init__()
        self.project = LoRADense(2 * dim, dim, dtype=dtype, lora_r=lora_r)

    def forward(self, tokens):  # (B, 1+L, C)
        cls = tokens[:, :1].expand_as(tokens[:, 1:])
        return gelu_exact(self.project(torch.cat([tokens[:, 1:], cls], -1)))


class MidasDPT(nn.Module):
    """MiDaS DPT decoder over the BEiT hooks: readout, per-level 1x1
    projections and the resize pyramid, 3x3 RN convs, the refinenet
    cascade, the 32-channel head activation and the relative depth.
    Returns (rel_depth (B, H, W), feats = [out32, l4_rn, r4, r3, r2, r1])."""

    def __init__(self, cfg: ZoeConfig, dtype=torch.float32, lora: bool = False):
        super().__init__()
        c, pc = cfg, cfg.pyramid_channels
        r = c.lora_r if lora and c.use_lora else 0
        self.width = c.width
        self.pretrained = BeitTrunk(c.width, c.depth, c.heads, c.patch_size, c.hooks, dtype, r)
        for i in range(4):
            self.add_module(f"readout_{i}", ProjectReadout(c.width, dtype, r))
            self.add_module(f"project_{i}", Conv2d(c.width, pc[i], 1, dtype=dtype))
        self.resize_0 = ConvTranspose2d(pc[0], pc[0], 4, dtype=dtype)
        self.resize_1 = ConvTranspose2d(pc[1], pc[1], 2, dtype=dtype)
        self.resize_3 = Conv2d(pc[3], pc[3], 3, stride=2, padding=1, dtype=dtype)
        for i in range(4):
            self.add_module(f"layer{i + 1}_rn",
                            Conv2d(pc[i], c.features, 3, padding=1, bias=False, dtype=dtype))
        for i in (4, 3, 2, 1):  # refinenet4 has no skip input, so no rcu1
            self.add_module(f"refinenet{i}", FeatureFusionBlock(c.features, skip=i != 4,
                                                                dtype=dtype))
        self.out_conv1 = Conv2d(c.features, c.features // 2, 3, padding=1, dtype=dtype)
        self.out_conv2 = Conv2d(c.features // 2, 32, 3, padding=1, dtype=dtype)
        self.out_conv3 = Conv2d(32, 1, 1, dtype=dtype)

    def forward(self, images):
        hook_tokens, (h, w) = self.pretrained(images)
        B = images.shape[0]
        feats = []
        for i, t in enumerate(hook_tokens):
            x = getattr(self, f"readout_{i}")(t).reshape(B, h, w, self.width)
            x = getattr(self, f"project_{i}")(x)
            if i in (0, 1, 3):
                x = getattr(self, f"resize_{i}")(x)
            feats.append(x)
        rn = [getattr(self, f"layer{i + 1}_rn")(feats[i]) for i in range(4)]
        path4 = self.refinenet4(rn[3], size=rn[2].shape[-3:-1])
        path3 = self.refinenet3(path4, rn[2], size=rn[1].shape[-3:-1])
        path2 = self.refinenet2(path3, rn[1], size=rn[0].shape[-3:-1])
        path1 = self.refinenet1(path2, rn[0])
        # output_conv: conv3x3 -> 2x up -> conv3x3(32) -> relu [the hooked
        # 32-channel activation] -> conv1x1(1) -> relu
        x = self.out_conv1(path1)
        x = resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2), align_corners=True)
        out32 = F.relu(self.out_conv2(x))
        rel = F.relu(self.out_conv3(out32))[..., 0]
        return rel, [out32, rn[3], path4, path3, path2, path1]


def softplus(x):
    """log(1 + e^x) as `jax.nn.softplus`, logaddexp(x, 0), at every x
    (`F.softplus` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _inv_attractor(dx, alpha: float, gamma: int):
    return dx / (1.0 + alpha * dx.pow(gamma))


def _exp_attractor(dx, alpha: float, gamma: int):
    return torch.exp(-alpha * dx.abs().pow(gamma)) * dx


class _ConvMLP(nn.Module):
    """1x1 conv -> relu -> 1x1 conv (-> softplus), channel-last."""

    def __init__(self, cin: int, hidden: int, out: int, final_softplus: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.final_softplus = final_softplus
        self.fc1 = Conv2d(cin, hidden, 1, dtype=dtype)
        self.fc2 = Conv2d(hidden, out, 1, dtype=dtype)

    def forward(self, x):
        x = self.fc2(F.relu(self.fc1(x)))
        return softplus(x) if self.final_softplus else x


def log_binomial(n_bins: int) -> np.ndarray:
    """log C(K-1, k) by Stirling, k = 0..K-1, in float64 on the host and
    cast once to fp32 (an in-graph version gives 0 * log 0 = NaN at
    k = K-1 once (K-1-k) + eps folds to an exact zero)."""
    eps = 1e-7
    k = np.arange(n_bins, dtype=np.float64)
    km1 = float(n_bins - 1)
    return ((km1 + eps) * np.log(km1 + eps) - (k + eps) * np.log(k + eps)
            - (km1 - k + eps) * np.log(km1 - k + eps)).astype(np.float32)


class ZoeDepthNK(nn.Module):
    """The ZoeDepth-NK metric head on the MiDaS core: images (B, H, W, 3)
    midas-normalized -> (B, H, W) metric depth in the compute dtype.
    lora=True: the stage-1 tower, with adapters where cfg.use_lora is set."""

    def __init__(self, cfg: ZoeConfig, dtype=torch.float32, lora: bool = False):
        super().__init__()
        c, f, E = cfg, cfg.features, cfg.bin_embedding_dim
        self.cfg = c
        self.core = MidasDPT(c, dtype, lora)
        self.conv2 = Conv2d(f, f, 1, dtype=dtype)
        self.seed_bin_regressor = _ConvMLP(f, E // 2, c.n_bins, True, dtype)
        self.seed_projector = _ConvMLP(f, E // 2, E, dtype=dtype)
        for i in range(4):
            self.add_module(f"projector_{i}", _ConvMLP(f, E // 2, E, dtype=dtype))
            self.add_module(f"attractor_{i}", _ConvMLP(E, E, c.n_attractors[i], True, dtype))
        self.clb_fc1 = Conv2d(32 + E, (32 + E) // 4, 1, dtype=dtype)
        self.clb_fc2 = Conv2d((32 + E) // 4, 4, 1, dtype=dtype)
        self.register_buffer("log_binom", torch.as_tensor(
            log_binomial(c.n_bins), device=self.conv2.weight.device), persistent=False)

    def forward(self, images):
        c = self.cfg
        _rel, feats = self.core(images)
        out32, btlnck, *x_blocks = feats
        x = self.conv2(btlnck)
        b_prev = self.seed_bin_regressor(x)  # (B, h, w, n_bins) seed bin centres
        prev_b_embedding = self.seed_projector(x)
        attract = _inv_attractor if c.attractor_type == "inv" else _exp_attractor
        b_centers, b_embedding = b_prev, prev_b_embedding
        for i, xb in enumerate(x_blocks):
            b_embedding = getattr(self, f"projector_{i}")(xb)
            pe = resize_bilinear(prev_b_embedding, b_embedding.shape[1:3], align_corners=True)
            A = getattr(self, f"attractor_{i}")(b_embedding + pe)
            bp = resize_bilinear(b_prev, A.shape[1:3], align_corners=True)
            dx = (A[..., :, None] - bp[..., None, :]).float()  # (B, h, w, n_attr, n_bins)
            delta = attract(dx, c.attractor_alpha, c.attractor_gamma)
            delta = delta.mean(-2) if c.attractor_kind == "mean" else delta.sum(-2)
            b_centers = bp + delta.to(bp.dtype)
            b_prev = b_centers
            # prev_b_embedding stays the seed embedding: the adaptor
            # comments its update out
        last = out32
        b_centers = resize_bilinear(b_centers, last.shape[1:3], align_corners=True)
        b_embedding = resize_bilinear(b_embedding, last.shape[1:3], align_corners=True)

        # conditional log-binomial over the bins, in fp32
        pt = self.clb_fc2(gelu_exact(self.clb_fc1(torch.cat([last, b_embedding], -1))))
        pt = softplus(pt).float()
        p_eps = 1e-4
        p = pt[..., 0:2] + p_eps
        p = p[..., 0] / (p[..., 0] + p[..., 1])
        t = pt[..., 2:4] + p_eps
        t = t[..., 0] / (t[..., 0] + t[..., 1])
        t = (c.max_temp - c.min_temp) * t + c.min_temp
        k_idx = torch.arange(c.n_bins, dtype=torch.float32, device=pt.device)
        km1 = float(c.n_bins - 1)
        pc = torch.clamp(p, 1e-4, 1.0)
        omp = torch.clamp(1.0 - p, 1e-4, 1.0)
        y = (self.log_binom + k_idx * torch.log(pc)[..., None]
             + (km1 - k_idx) * torch.log(omp)[..., None])
        probs = torch.softmax(y / t[..., None], -1)
        metric = (probs.to(b_centers.dtype) * b_centers).sum(-1)
        if tuple(metric.shape[1:3]) != tuple(images.shape[1:3]):
            metric = resize_bilinear(metric[..., None], images.shape[1:3],
                                     align_corners=True)[..., 0]
        return metric
