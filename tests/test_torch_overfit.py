"""The port's overfit drills (`veon_tpu_torch/utils/overfit.py`) on the
CPU, the counterpart of `tests/test_overfit.py`: the training recipe
optimizes. Stage 2 at `veon_tiny_test` from the port's seeded weights
with the JAX test's margins; stage 1 on the JAX drill's tiny DA-V2 and
tiny zoe from JAX's own init, each against JAX's drill on the same init
(the first steps of the curve) and within the JAX test's margin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import np_tree

from veon_tpu.configs.base import DepthConfig as JDepth, ZoeConfig as JZoe
from veon_tpu.nn.dpt import DepthAnythingV2 as JDav2
from veon_tpu.nn.zoedepth import ZoeDepthNK as JZoeNK
from veon_tpu.utils import overfit as jof

from veon_tpu_torch.utils import overfit as tof


def test_stage2_overfit_learns():
    """40 steps at lr 1e-3: the total loss down by >= 28% and the binary
    occupancy term down, the eval-mode mIoU up by > 0.10, the EMA moved
    off the params (JAX's margins); then the bf16 battery on the overfit
    weights within the JAX test's bounds."""
    r = tof.stage2_overfit(steps=40, lr=1e-3, log_every=40, device="cpu")
    assert r["loss1"] < 0.72 * r["loss0"], r["curve"]
    assert r["final_losses"]["loss_binocc"] < r["first_losses"]["loss_binocc"]
    assert r["miou1"] > r["miou0"] + 0.10, (r["miou0"], r["miou1"])
    st = r["state"]
    params = dict(st.model.named_parameters())
    assert any(not torch.equal(e, params[n]) for n, e in st.ema_params.items())
    assert float(st.ema_updates) == 40.0
    d = tof.bf16_divergence(r["model"], r["cfg"], st, r["batch"], r["refl"])
    assert d["flip_rate"] < 0.03 and d["feat_cos"] > 0.995 and d["occ_prob_mad"] < 0.005, d


@pytest.mark.parametrize("mode, margin", [("dav2", 0.60), ("zoe", 0.75)])
def test_stage1_overfit_learns_as_reference(mode, margin):
    """30 steps at lr 1e-3 from JAX's init of the drill's tower: the first
    three losses of the curve within 1e-5 of JAX's (measured <= 1.2e-6;
    past them the trajectory at this learning rate is chaotic: two JAX runs
    end 0.53 and 0.87 apart), and the last under the JAX test's margin
    (DA-V2 -40%, zoe -25%)."""
    if mode == "zoe":
        jm, x = JZoeNK(cfg=JZoe(**tof.TINY_ZOE)), np.zeros((2, 64, 96, 3), np.float32)
    else:
        jm = JDav2(cfg=JDepth(encoder="vits", features=8, out_channels=(4, 8, 8, 8), lora_r=2))
        x = np.zeros((2, 28, 42, 3), np.float32)
    variables = np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    got = tof.stage1_overfit(steps=30, lr=1e-3, log_every=1, depth_mode=mode, device="cpu",
                             variables=variables)
    want = jof.stage1_overfit(steps=3, lr=1e-3, log_every=1, depth_mode=mode)
    np.testing.assert_allclose([v for _, v in got["curve"][:3]],
                               [v for _, v in want["curve"]], rtol=1e-5)
    assert got["loss1"] < margin * got["loss0"], got["curve"]
