"""Fused LayerNorm -> Dense (counterpart of `veon_tpu/ops/fused_ln.py`).

`ln_dense` launches the hand-written CUDA kernel `csrc/ln_dense.cu` (TPU
kernel `_ln_dense_kernel`, entry `ln_dense_pallas`; bf16 on `wgmma` fed by
a TMA ring, fp32 as a register-blocked SIMT product) on a CUDA tensor, runs
`ln_dense_plain` on a CPU tensor and raises on anything else; it counts
its launches in `ln_dense.launches`. As in the JAX package, the model does
not call it: it keeps the plain LayerNorm + Dense pair, and this is a
tested building block (production shapes: HSA qkv 67,584x384 @ 384x1,152,
HSA MLP @ 384x384, SAN qkv 17,536x256 @ 256x768).
"""

from __future__ import annotations

import ctypes

import torch

from . import native

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3 + (ctypes.c_float, ctypes.c_int,
                                                             ctypes.c_void_p)


def ln_dense_plain(x, ln_scale, ln_bias, w, b, eps: float = 1e-5):
    """Plain PyTorch version: per row of x (M, C), LayerNorm in fp32 (the
    centred mean square as variance), affine, cast to w's dtype, then the
    product with w (C, N) accumulated in fp32, plus b in fp32, cast to x's
    dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = (y * ln_scale.float() + ln_bias.float()).to(w.dtype)
    # operands of w's dtype are exact in fp32, so this is the fp32-accumulated product
    return (y.float() @ w.float() + b.float()).to(x.dtype)


def ln_dense(x, ln_scale, ln_bias, w, b, eps: float = 1e-5):
    """x (M, C) -> LayerNorm (fp32 internals, affine) -> @ w (C, N) + b, in
    x's dtype. C and N multiples of 128, C <= 1024; x and w of one dtype,
    float32 or bfloat16."""
    if x.device.type == "cpu":
        return ln_dense_plain(x, ln_scale, ln_bias, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_dense: x on {x.device}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"ln_dense: x {tuple(x.shape)} and w {tuple(w.shape)} do not chain")
    M, C = x.shape
    N = w.shape[1]
    if C % 128 or N % 128 or C > 1024:
        raise ValueError(f"ln_dense: C = {C} and N = {N} must be multiples of 128, C <= 1024")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"ln_dense takes float32/bfloat16 x and w of one dtype, got "
                        f"{x.dtype} and {w.dtype}")
    vecs = [v.to(torch.float32).contiguous() for v in (ln_scale, ln_bias, b)]
    if tuple(vecs[0].shape) != (C,) or tuple(vecs[1].shape) != (C,) or tuple(vecs[2].shape) != (N,):
        raise ValueError("ln_dense: ln_scale / ln_bias must be (C,) and b (N,)")
    for t in (x, w, *vecs):
        if t.device != x.device:
            raise ValueError(f"ln_dense: operands on {t.device} and {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("ln_dense needs contiguous x and w")
    if x.data_ptr() % 16 or w.data_ptr() % 32:
        raise ValueError("ln_dense needs 16-byte aligned x and 32-byte aligned w")
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    fn = native.function("ln_dense", "veon_ln_dense", _ARGTYPES)
    with torch.cuda.device(x.device):  # the tensors' card, whichever is current
        err = fn(x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w.data_ptr(),
                 vecs[2].data_ptr(), out.data_ptr(), M, C, N, eps, _DTYPE_CODE[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ln_dense launch failed: cudaError {err}")
    ln_dense.launches += 1
    return out


ln_dense.launches = 0
