"""The temporal fusion's deformable attention on its 3x3x3 stencil (the
`use_stencil=True` form of `nn/alignnet.py` `TemporalDeformable`).

Offsets bounded by tanh(.)/size keep every sample within +-0.5 cell of its
voxel, so trilinear sampling with border padding is a fixed 27-tap stencil
with per-sample hat weights. `deform_stencil_plain` is that stencil in
PyTorch ops: the oracle, the CPU route and the differentiable route.

`deform_stencil` (`torch.ops.veon.deform_stencil`, with a fake version
that gives the output's shape and dtype, so `torch.export` keeps it as one
node) runs the plain version on a CPU tensor, launches the hand-written
kernel `csrc/deform_stencil.cu` on a CUDA tensor and raises on any other
device. The kernel is the port's own: the JAX package computes the
stencil in XLA ops and has no Pallas kernel for it. Each launch counts in
`deform_stencil.launches`. Its backward re-runs the plain version under
grad and differentiates that, so training takes the kernel's forward and
the plain version's gradients.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import tracing
from . import native

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)
# what the kernel takes: every preset's head width (64 at VEON-B and -L,
# 4 at the tiny preset) and sample count
KERNEL_HEAD_DIMS = (4, 64)
KERNEL_SAMPLES = 8

_TAPS = tuple((tz, ty, tx) for tz in (-1, 0, 1) for ty in (-1, 0, 1) for tx in (-1, 0, 1))


def _edge_pad3d(x):
    """x (B, Z, Y, X, ...) with one edge-replicated cell added on both sides
    of Z, Y and X: the source of every `_shift3d` view."""
    for ax in (1, 2, 3):
        n = x.shape[ax]
        x = torch.cat([x.narrow(ax, 0, 1), x, x.narrow(ax, n - 1, 1)], ax)
    return x


def _shift3d(xp, t):
    """x shifted by t = (tz, ty, tx), |t| <= 1, with edge replication,
    out[i] = x[clamp(i + t, 0, n - 1)] on each axis (the border-padding
    counterpart of a stencil tap), as a view of xp = _edge_pad3d(x)."""
    (tz, ty, tx), (Z, Y, X) = t, (xp.shape[1] - 2, xp.shape[2] - 2, xp.shape[3] - 2)
    return xp[:, 1 + tz:1 + tz + Z, 1 + ty:1 + ty + Y, 1 + tx:1 + tx + X]


def _linspace_pm1(n: int, device) -> torch.Tensor:
    """jnp.linspace(-1, 1, n) as the jitted JAX graph computes it, bit for
    bit: step = iota * fp32(1 / (n - 1)) (XLA multiplies by the reciprocal
    of the constant divisor), -1 * (1 - step) + step, with 1 appended.
    torch.linspace rounds differently in up to half the entries."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    div = n - 1
    step = torch.arange(div, dtype=torch.float32, device=device) * float(
        np.float32(1.0) / np.float32(div))
    return torch.cat([-(1 - step) + step, torch.ones(1, device=device)])


def sample_grid(off):
    """off (B, D, H, W, heads, S, 3), tanh-bounded, in the compute dtype ->
    (base, grid): every voxel's own normalised position (z, y, x) and its
    samples' positions base + off / size clipped to [-1, 1], both fp32."""
    D, H, W, dev = off.shape[1], off.shape[2], off.shape[3], off.device
    zz, yy, xx = torch.meshgrid(_linspace_pm1(D, dev), _linspace_pm1(H, dev),
                                _linspace_pm1(W, dev), indexing="ij")
    base = torch.stack([zz, yy, xx], -1)[None, :, :, :, None, None, :]  # (z, y, x)
    norm = tracing.uploaded(torch.tensor([D, H, W], dtype=off.dtype, device=dev))
    return base, (base + off / norm).clamp(-1, 1)


def _check(off, query, kv, num_heads: int, num_samples: int):
    """(B, D, H, W, C) of a call whose shapes fit together; raises otherwise."""
    if query.dim() != 5 or off.dim() != 5 or kv.dim() != 5:
        raise ValueError(f"deform_stencil: off {tuple(off.shape)}, query {tuple(query.shape)} "
                         f"and kv {tuple(kv.shape)} must be (B, D, H, W, channels)")
    B, D, H, W, C = query.shape
    if (num_heads < 1 or num_samples < 1 or C % num_heads
            or tuple(off.shape) != (B, D, H, W, num_heads * num_samples * 3)
            or tuple(kv.shape) != (B, D, H, W, 2 * C)):
        raise ValueError(f"deform_stencil: off {tuple(off.shape)}, query {tuple(query.shape)} "
                         f"and kv {tuple(kv.shape)} do not fit {num_heads} heads of "
                         f"{num_samples} samples")
    return B, D, H, W, C


def deform_stencil_plain(off, query, kv, num_heads: int, num_samples: int):
    """The stencil in PyTorch ops: off (B, D, H, W, heads * S * 3) the tanh
    offsets (z, y, x) per head and sample, query (B, D, H, W, C), kv
    (B, D, H, W, 2C) with each head's key and value halves side by side ->
    (B, D, H, W, C) in query's dtype. Dtypes of every intermediate follow
    JAX's promotion: offsets in the compute dtype, the sampling grid, hat
    weights and weighted sums in fp32, the softmax in fp32 cast back to the
    compute dtype; the fp32 sum is rounded once at the end."""
    B, D, H, W, C = _check(off, query, kv, num_heads, num_samples)
    nh, ns, dev = num_heads, num_samples, query.device
    hd = C // nh
    base, grid_zyx = sample_grid(off.reshape(B, D, H, W, nh, ns, 3))
    q = query.reshape(B, D, H, W, nh, hd)
    kvh = kv.reshape(B, D, H, W, nh, 2 * hd)
    # per-sample offset in cells after the clip (align_corners:
    # cells = (g + 1) / 2 * (size - 1))
    sizes = tracing.uploaded(
        torch.tensor([D - 1, H - 1, W - 1], dtype=torch.float32, device=dev)) / 2.0
    delta = (grid_zyx - base) * sizes
    qs = q * hd ** -0.5
    # a tap's hat weight is a product of one factor per axis, each
    # max(0, 1 - |delta_axis - t_axis|) with t_axis in (-1, 0, 1):
    # the 9 factors are computed once (the same values, bit for bit)
    hats = [{s: torch.clamp_min(1.0 - (delta[..., a] - s).abs(), 0.0) for s in (-1, 0, 1)}
            for a in range(3)]
    kvp = _edge_pad3d(kvh)  # the taps below are views of it
    weights, logits = [], 0.0
    for tz, ty, tx in _TAPS:
        w = hats[0][tz] * hats[1][ty] * hats[2][tx]  # (B, D, H, W, heads, S)
        d_t = (qs * _shift3d(kvp, (tz, ty, tx))[..., :hd]).sum(-1)  # (B, D, H, W, heads)
        logits = logits + w * d_t[..., None]
        weights.append(w)
    attn = torch.softmax(logits.float(), -1).to(q.dtype)
    fused = 0.0
    for w, t in zip(weights, _TAPS):
        g = (attn * w).sum(-1)
        fused = fused + g[..., None] * _shift3d(kvp, t)[..., hd:]
    return fused.reshape(B, D, H, W, C).to(query.dtype)


def deform_stencil(off, query, kv, num_heads: int, num_samples: int):
    """The stencil as one registered op (`torch.ops.veon.deform_stencil`):
    the plain version on the CPU, the kernel on the card; differentiable."""
    return torch.ops.veon.deform_stencil(off, query, kv, num_heads, num_samples)


deform_stencil.launches = 0


def launch(off, query, kv, num_heads: int, num_samples: int, dt_out=None):
    """Launch the kernel on CUDA tensors of one dtype -> (B, D, H, W, C) in
    that dtype. `dt_out`, a float32 CUDA tensor (B, D, H, W, heads, 27) or
    None, receives every tap's q.k in the compute dtype (for the tests)."""
    B, D, H, W, C = _check(off, query, kv, num_heads, num_samples)
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"deform_stencil: query on {dev}")
    for name, t in (("off", off), ("kv", kv)):
        if t.device != dev:
            raise ValueError(f"deform_stencil: {name} on {t.device}, query on {dev}")
        if t.dtype != query.dtype:
            raise TypeError(f"deform_stencil takes off, query and kv of one dtype, got "
                            f"{off.dtype}, {query.dtype} and {kv.dtype}")
    if query.dtype not in _DTYPE_CODE:
        raise TypeError(f"deform_stencil takes float32/bfloat16, got {query.dtype}")
    hd = C // num_heads
    if hd not in KERNEL_HEAD_DIMS or num_samples != KERNEL_SAMPLES:
        raise ValueError(f"deform_stencil kernel takes heads of {KERNEL_HEAD_DIMS} channels and "
                         f"{KERNEL_SAMPLES} samples, got query {tuple(query.shape)} in "
                         f"{num_heads} heads of {hd} and {num_samples} samples")
    if dt_out is not None and (dt_out.dtype != torch.float32 or dt_out.device != dev
                               or tuple(dt_out.shape) != (B, D, H, W, num_heads, 27)
                               or not dt_out.is_contiguous()):
        raise ValueError("deform_stencil: dt_out must be a contiguous float32 "
                         f"(B, D, H, W, heads, 27) on {dev}")
    off, query, kv = off.contiguous(), query.contiguous(), kv.contiguous()
    if query.data_ptr() % 16 or kv.data_ptr() % 16:
        raise ValueError("deform_stencil needs 16-byte aligned query and kv")
    out = query.new_empty(query.shape)
    fn = native.function("deform_stencil", "veon_deform_stencil", _ARGTYPES)
    with torch.cuda.device(dev):  # the tensors' card, whichever is current
        err = fn(off.data_ptr(), query.data_ptr(), kv.data_ptr(), out.data_ptr(),
                 None if dt_out is None else dt_out.data_ptr(), B, D, H, W, num_heads, hd,
                 num_samples, _DTYPE_CODE[query.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"deform_stencil launch failed: cudaError {err}")
    deform_stencil.launches += 1
    return out


@torch.library.custom_op("veon::deform_stencil", mutates_args=(),
                         schema="(Tensor off, Tensor query, Tensor kv, int num_heads, "
                                "int num_samples) -> Tensor")
def _op(off, query, kv, num_heads, num_samples):
    dev = query.device
    if dev.type == "cpu":
        return deform_stencil_plain(off, query, kv, num_heads, num_samples)
    if dev.type != "cuda":
        raise ValueError(f"deform_stencil: query on {dev}")
    return launch(off, query, kv, num_heads, num_samples)


@_op.register_fake
def _(off, query, kv, num_heads, num_samples):
    _check(off, query, kv, num_heads, num_samples)
    return query.new_empty(query.shape)


def _setup_context(ctx, inputs, output):
    off, query, kv, num_heads, num_samples = inputs
    ctx.save_for_backward(off, query, kv)
    ctx.num_heads, ctx.num_samples = num_heads, num_samples


def _backward(ctx, grad):
    """The plain version re-run under grad on the saved inputs, and its
    gradients: the same arithmetic the plain version's own backward does."""
    need = ctx.needs_input_grad[:3]
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        out = deform_stencil_plain(*ins, ctx.num_heads, ctx.num_samples)
        grads = iter(torch.autograd.grad(out, [t for t in ins if t.requires_grad], grad))
    return (*(next(grads) if n else None for n in need), None, None)


_op.register_autograd(_backward, setup_context=_setup_context)
