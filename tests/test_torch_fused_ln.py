"""The fused LayerNorm -> Dense (kernel #4) on the CPU: the port's plain
version against the JAX Pallas kernel `ln_dense_pallas` (interpret mode on
the CPU, as `tests/test_ops_parity.py` runs it) and against the unfused
XLA pair `ln_dense_xla`. fp32 at 1e-5; bf16 at the JAX test's own 2e-2 (the
row statistics summed in another order can round the normalised row, and
so the output, to the other bf16 neighbour). The CUDA kernel itself is
held against this plain version on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import to_np

from veon_tpu.ops.fused_ln import ln_dense_pallas, ln_dense_xla

from veon_tpu_torch.ops import fused_ln

# (dtype, M, C, N, tol): M = 1500 is no multiple of the Pallas 1024-row tile
CASES = {"fp32": (np.float32, 700, 128, 256, 1e-5),
         "bf16": (jnp.bfloat16, 1500, 384, 1152, 2e-2)}


def _inputs(M, C, N, seed=0):
    rng = np.random.default_rng(seed)
    return ((2.0 * rng.standard_normal((M, C)) + 0.5).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32),
            (0.1 * rng.standard_normal(C)).astype(np.float32),
            (rng.standard_normal((C, N)) / np.sqrt(C)).astype(np.float32),
            (0.1 * rng.standard_normal(N)).astype(np.float32))


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ln_dense_plain_matches_reference(case, ref):
    dt, M, C, N, tol = CASES[case]
    x, s, sh, w, b = _inputs(M, C, N)
    jx, jw = jnp.asarray(x).astype(dt), jnp.asarray(w).astype(dt)
    fn = ln_dense_pallas if ref == "pallas" else jax.jit(ln_dense_xla)
    want = fn(jx, jnp.asarray(s), jnp.asarray(sh), jw, jnp.asarray(b))
    tdt = torch.float32 if dt == np.float32 else torch.bfloat16
    got = fused_ln.ln_dense_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(s),
                                  torch.from_numpy(sh), torch.from_numpy(w).to(tdt),
                                  torch.from_numpy(b))
    assert got.dtype == tdt and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(to_np(got.float()), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_ln_dense_runs_plain_on_the_cpu_and_raises_elsewhere():
    x, s, sh, w, b = (torch.from_numpy(a) for a in _inputs(300, 128, 128))
    before = fused_ln.ln_dense.launches
    torch.testing.assert_close(fused_ln.ln_dense(x, s, sh, w, b),
                               fused_ln.ln_dense_plain(x, s, sh, w, b), rtol=0, atol=0)
    assert fused_ln.ln_dense.launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="meta"):
        fused_ln.ln_dense(x.to("meta"), s, sh, w, b)
