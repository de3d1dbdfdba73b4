"""Attention (counterpart of `veon_tpu/nn/attention.py`): batch-first
tokens (B, L, C), fp32 softmax.

The JAX side computes attention in XLA (`_attention_xla`); here the plain
and biased self-attention go to `F.scaled_dot_product_attention`. The SAN
cross-attention with a per-query self term has no SDPA form and stays as
explicit products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LoRADense


def _split_heads(x, num_heads):
    B, L, C = x.shape
    return x.reshape(B, L, num_heads, C // num_heads).transpose(1, 2)


def _merge_heads(x):
    B, H, L, D = x.shape
    return x.transpose(1, 2).reshape(B, L, H * D)


class FusedQKVAttention(nn.Module):
    """nn.MultiheadAttention-layout MHA (fused in_proj) with the standard
    self-attention and the SAN biased cross-attention with self term,
    sharing the same in_proj/out_proj parameters."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj = Dense(dim, 3 * dim, dtype=dtype)
        self.out_proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x, bias=None, mode: str = "self", mem=None, extra_qk=None):
        if mode == "self":
            return self._self_attn(x, bias, extra_qk)
        return self._cross_with_self_bias(x, mem, bias)

    def _self_attn(self, x, bias, extra_qk=None):
        E = x.shape[-1]
        q, k, v = (_split_heads(t, self.num_heads) for t in self.in_proj(x).split(E, -1))
        if extra_qk is not None:
            # factorized additive bias f @ f^T fused as extra qk channels:
            # softmax(q*s @ k^T + f @ f^T) == softmax([q*s, f] @ [k, f]^T),
            # so SDPA must not apply its own 1/sqrt(d) to the widened q
            f = extra_qk.transpose(1, 2).to(q.dtype)  # (B, H, L, Df)
            scale = (E // self.num_heads) ** -0.5
            q_aug = torch.cat([q * scale, f], dim=-1)
            k_aug = torch.cat([k, f], dim=-1)
            out = F.scaled_dot_product_attention(q_aug, k_aug, v, scale=1.0)
        else:
            mask = None if bias is None else bias.to(q.dtype)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return self.out_proj(_merge_heads(out))

    def _cross_with_self_bias(self, query, mem, bias):
        """query: (B, K, C) sos tokens; mem: (B, L, C); bias: (B, H, K, L).
        Logits [q.k + bias || q.k(q)] under one softmax; the output adds
        the self weight times v(q)."""
        E = query.shape[-1]
        q, q_k, q_v = (_split_heads(t, self.num_heads) for t in self.in_proj(query).split(E, -1))
        _, k, v = (_split_heads(t, self.num_heads) for t in self.in_proj(mem).split(E, -1))
        qs = q * (E // self.num_heads) ** -0.5
        logits = torch.einsum("bhqd,bhkd->bhqk", qs, k) + bias.to(qs.dtype)
        self_logit = (qs * q_k).sum(-1, keepdim=True)
        w = torch.softmax(torch.cat([logits, self_logit], -1).float(), -1).to(q.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", w[..., :-1], v) + w[..., -1:] * q_v
        return self.out_proj(_merge_heads(out))


class SimpleAttention(nn.Module):
    """timm / DINOv2 MHA: fused qkv Dense, separate proj, optional LoRA on both."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, dtype=torch.float32,
                 lora_r: int = 0, lora_alpha: float = 1.0):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = LoRADense(dim, 3 * dim, bias=qkv_bias, dtype=dtype, lora_r=lora_r,
                             lora_alpha=lora_alpha)
        self.proj = LoRADense(dim, dim, dtype=dtype, lora_r=lora_r, lora_alpha=lora_alpha)

    def forward(self, x):
        E = x.shape[-1]
        q, k, v = (_split_heads(t, self.num_heads) for t in self.qkv(x).split(E, -1))
        return self.proj(_merge_heads(F.scaled_dot_product_attention(q, k, v)))
