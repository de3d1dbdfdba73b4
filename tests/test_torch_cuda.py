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
