"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: skips without a card. On the machine with the card
(which has no JAX) run it without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from veon_tpu_torch.ops import bev_pool as bp

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _stream(card, P, C, num_cells, dtype, seed=0):
    """Sorted ranks with empty fine cells, empty coarse cells and overflow rows."""
    rng = np.random.default_rng(seed)
    rk = np.sort(rng.integers(0, num_cells + num_cells // 8, P)).astype(np.int32)
    vals = torch.from_numpy(rng.standard_normal((P, C)).astype(np.float32))
    return vals.to(card, dtype), torch.from_numpy(rk).to(card)


# C=256: 16-byte vector loads (the flagship); C=12 fp32: 3 x float4;
# C=12 bf16: not a multiple of 8, the scalar-load instance
@pytest.mark.parametrize("C", [256, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernel_matches_plain(card, C, dtype):
    num_cells, pool_r = 8 * 1000, 8
    vals, rk = _stream(card, 20000, C, num_cells, dtype)
    before = bp.bev_pool_pooled.launches
    got = bp.bev_pool_pooled(vals, rk, num_cells, pool_r, dtype)
    torch.cuda.synchronize()
    assert bp.bev_pool_pooled.launches == before + 1
    want32 = bp.bev_pool_pooled_plain(vals, rk, num_cells, pool_r, torch.float32)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want32, rtol=1e-5, atol=1e-5)
    else:  # fp32 sums in another order, then one bf16 rounding
        torch.testing.assert_close(got.float(), want32, rtol=2 ** -7, atol=1e-5)


def test_pool_kernel_rejects_what_it_does_not_take(card):
    vals, rk = _stream(card, 100, 16, 64, torch.float32)
    with pytest.raises(TypeError):
        bp.bev_pool_pooled(vals, rk, 64, 8, torch.bfloat16)
    with pytest.raises(ValueError):
        bp.bev_pool_pooled(vals, rk.long(), 64, 8, torch.float32)
    with pytest.raises(ValueError):
        bp.bev_pool_pooled(vals, rk.cpu(), 64, 8, torch.float32)


# kernels #2 (one stream) and #3 (two streams): C=256 is the flagship's
# 16-byte vector path, C=12 bf16 the scalar instance
@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("C", [256, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_kernels_match_plain(card, streams, C, dtype):
    num_cells = 5000
    pairs = [_stream(card, n, C, num_cells, dtype, seed=s)
             for n, s in ((6000, 1), (9000, 2))[:streams]]
    kernel = bp.bev_pool_sorted if streams == 1 else bp.bev_pool_sorted2
    before = kernel.launches
    got = kernel(*[t for pair in pairs for t in pair], num_cells)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want32 = bp.bev_pool_sorted_plain(pairs, num_cells, torch.float32)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want32, rtol=1e-5, atol=1e-5)
    else:  # fp32 sums in another order, then one bf16 rounding
        torch.testing.assert_close(got.float(), want32, rtol=2 ** -7, atol=1e-5)


def test_sorted_kernel_rejects_what_it_does_not_take(card):
    vals, rk = _stream(card, 100, 16, 64, torch.float32)
    with pytest.raises(TypeError):
        bp.bev_pool_sorted2(vals, rk, vals.to(torch.bfloat16), rk, 64)
    with pytest.raises(ValueError):
        bp.bev_pool_sorted(vals, rk.long(), 64)
    with pytest.raises(ValueError):
        bp.bev_pool_sorted(vals.t().contiguous().t(), rk, 64)


def test_pooled_op_backward_on_card_matches_cpu(card):
    """bev_pool_presorted_pooled forward (kernel #1) and backward (kernel
    #2 recompute + group-max routing + gather adjoints) on the card vs the
    plain versions on the CPU, fp32, random ranks with empty fine cells."""
    rng = np.random.default_rng(5)
    grid_size, B, N, D, h, w, C = (8, 6, 4), 1, 2, 5, 3, 4, 16
    num_cells = B * 8 * 6 * 4
    ranks = rng.integers(0, num_cells + num_cells // 4, (B, N, D, h, w)).astype(np.int32)
    ranks = np.minimum(ranks, num_cells)
    ranks = bp.pooled_rank_remap(torch.from_numpy(ranks), grid_size, (2, 2, 2), num_cells)
    rk = ranks.permute(0, 1, 3, 4, 2).reshape(-1)
    order = torch.argsort(rk, stable=True).to(torch.int32)
    rk_sorted = rk[order.long()].contiguous()
    depth = torch.from_numpy(rng.random((B, N, D, h, w)).astype(np.float32))
    feat = torch.from_numpy(rng.standard_normal((B, N, h, w, C)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((B, 2, 3, 4, C)).astype(np.float32))
    res = {}
    for dev in ("cpu", card):
        d = depth.to(dev, copy=True).requires_grad_()
        f = feat.to(dev, copy=True).requires_grad_()
        out = bp.bev_pool_presorted_pooled(d, f, order.to(dev), rk_sorted.to(dev), ranks.to(dev),
                                           grid_size, (2, 2, 2))
        out.backward(cot.to(dev))
        res[str(dev)] = (out.detach().cpu(), d.grad.cpu(), f.grad.cpu())
    for got, want in zip(res[str(card)], res["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _ln_inputs(card, M, C, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = ((2.0 * rng.standard_normal((M, C)) + 0.5), 1.0 + 0.1 * rng.standard_normal(C),
              0.1 * rng.standard_normal(C), rng.standard_normal((C, N)) / np.sqrt(C),
              0.1 * rng.standard_normal(N))
    x, s, sh, w, b = (torch.from_numpy(a.astype(np.float32)).to(card) for a in arrays)
    return x.to(dtype), s, sh, w.to(dtype), b


# kernel #4 at the CPU tests' shapes (M = 1500 ends in a partial row tile)
# and at the HSA qkv production shape; fp32 at 1e-5 (sums in another
# order), bf16 at 2e-2 (the normalised row may round to the other bf16
# neighbour)
@pytest.mark.parametrize("M,C,N,dtype", [
    (700, 128, 256, torch.float32), (1500, 384, 1152, torch.bfloat16),
    (67584, 384, 1152, torch.float32), (67584, 384, 1152, torch.bfloat16)])
def test_ln_dense_kernel_matches_plain(card, M, C, N, dtype):
    from veon_tpu_torch.ops import fused_ln

    args = _ln_inputs(card, M, C, N, dtype)
    before = fused_ln.ln_dense.launches
    got = fused_ln.ln_dense(*args)
    torch.cuda.synchronize()
    assert fused_ln.ln_dense.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (M, N)
    want = fused_ln.ln_dense_plain(*args)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_ln_dense_rejects_what_it_does_not_take(card):
    from veon_tpu_torch.ops import fused_ln

    x, s, sh, w, b = _ln_inputs(card, 64, 128, 128, torch.float32)
    with pytest.raises(ValueError, match="multiples of 128"):
        fused_ln.ln_dense(x[:, :100], s[:100], sh[:100], w[:100], b)
    with pytest.raises(TypeError):
        fused_ln.ln_dense(x, s, sh, w.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ln.ln_dense(x.t().contiguous().t(), s, sh, w, b)
