"""The port's ZoeDepth-NK branch (`veon_tpu_torch/nn/zoedepth.py`) against
`veon_tpu/nn/zoedepth.py` on the CPU, fp32, at rtol/atol 1e-4: the
relative-position index and bias, the attractors, `BeitBlock`,
`MidasDPT` (relative depth and all six features) and `ZoeDepthNK` at
JAX's tiny `ZoeConfig` with LoRA r=2, every leaf perturbed (so the
tables, q/v biases, LayerScales and the adapters' B factors are nonzero),
the JAX side applying its adapters and the port the folded tree
(`merge_lora`, scale 1 / r); then `VeonModel.estimate_depth` and the
whole F=1 slice (`full_forward` on `veon_tiny_test` with the tiny zoe
tower and the presorted lift) on the same weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import perturbed, to_np, to_torch
from test_torch_mirror import TINY_ZOE, with_tiny_zoe

from veon_tpu.ckpt.convert import merge_lora
from veon_tpu.configs import presets as jpresets
from veon_tpu.configs.base import ZoeConfig as JZoeConfig
from veon_tpu.nn import zoedepth as jz
from veon_tpu_torch.ckpt.from_jax import load_from_jax
from veon_tpu_torch.configs import presets
from veon_tpu_torch.configs.base import ZoeConfig
from veon_tpu_torch.nn import zoedepth as tz

TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(0)


def tiny_zoe(cls=ZoeConfig):
    """JAX's tiny ZoeConfig (`tests/test_zoedepth.py` `_tiny_zoe`)."""
    return cls(**TINY_ZOE)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _lora_b(params):
    """Every LoRA B factor of a params tree."""
    if not isinstance(params, dict):
        return []
    return ([params["lora_B"]] if "lora_B" in params else []) + [
        b for v in params.values() for b in _lora_b(v)]


def _carry(jmod, tmod, *inputs, **kw):
    """Init `jmod`, perturb every leaf, load the LoRA-folded tree into
    `tmod`: (variables, JAX output, port output)."""
    # jitted unless a window kwarg must stay static: eager ops compile one
    # by one under the suite's XLA flags
    init, apply = (jax.jit(jmod.init), jax.jit(jmod.apply)) if not kw else (jmod.init, jmod.apply)
    variables = perturbed(init(KEY, *map(jnp.asarray, inputs), **kw))
    bs = _lora_b(variables["params"])
    assert bs and all(np.abs(b).min() > 0 for b in bs)  # the adapters do something
    load_from_jax(tmod, {"params": merge_lora(variables["params"])})
    want = apply(variables, *map(jnp.asarray, inputs), **kw)
    with torch.no_grad():
        got = tmod(*map(to_torch, inputs), **kw)
    return variables, want, got


@pytest.mark.parametrize("window", [(3, 3), (2, 5), (16, 44)])
def test_relative_position_index_equals_reference(window):
    np.testing.assert_array_equal(tz.beit_relative_position_index(*window),
                                  jz.beit_relative_position_index(*window))


@pytest.mark.parametrize("pretrain,window", [((3, 3), (3, 3)), ((3, 3), (2, 5)),
                                             ((24, 24), (16, 44))])
def test_rel_pos_bias_equals_reference(pretrain, window):
    """The identity window gathers the table as it is; a resized one goes
    through the (2h-1, 2w-1) bilinear table first (VEON-B's 16x44 window:
    the 47x47 table to 31x87)."""
    heads = 3
    rows = (2 * pretrain[0] - 1) * (2 * pretrain[1] - 1) + 3
    table = _rand(1, rows, heads)
    want = np.asarray(jz.beit_rel_pos_bias(jnp.asarray(table), pretrain, window))
    got = to_np(tz.beit_rel_pos_bias(to_torch(table), pretrain, window))
    n = window[0] * window[1] + 1
    assert got.shape == want.shape == (heads, n, n)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[:, 0, 0], table[-1])  # cls -> cls
    if pretrain == window:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["inv", "exp"])
def test_attractors_equal_reference(kind):
    dx = _rand(2, 4, 6, 8) * 0.1
    jf, tf = (jz._inv_attractor, tz._inv_attractor) if kind == "inv" else \
        (jz._exp_attractor, tz._exp_attractor)
    np.testing.assert_allclose(to_np(tf(to_torch(dx), 1000.0, 2)),
                               np.asarray(jf(jnp.asarray(dx), 1000.0, 2)), rtol=1e-6, atol=1e-7)


def test_softplus_equals_jax_over_its_threshold():
    x = np.linspace(-40.0, 40.0, 801, dtype=np.float32)
    np.testing.assert_allclose(to_np(tz.softplus(to_torch(x))), np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=1e-7)


def test_beit_block_equals_reference():
    """A resized window: the default 24x24 table to the 3x3 window's 5x5."""
    x = _rand(3, 2, 10, 32)
    _v, want, got = _carry(jz.BeitBlock(heads=2, lora_r=2), tz.BeitBlock(32, 2), x, window=(3, 3))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_midas_dpt_equals_reference():
    img = _rand(4, 1, 64, 96, 3)
    _v, (jrel, jfeats), (rel, feats) = _carry(jz.MidasDPT(cfg=tiny_zoe(JZoeConfig)),
                                              tz.MidasDPT(tiny_zoe()), img)
    np.testing.assert_allclose(to_np(rel), np.asarray(jrel), **TOL)
    assert len(feats) == len(jfeats) == 6
    for i, (g, w) in enumerate(zip(feats, jfeats)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), err_msg=str(i), **TOL)


@pytest.fixture(scope="module")
def zoe_tower():
    """(JAX ZoeDepthNK, its perturbed variables, the port's tower loaded
    from them), initialised once: the weights do not depend on the input
    size."""
    jm = jz.ZoeDepthNK(cfg=tiny_zoe(JZoeConfig))
    variables, _want, _got = _carry(jm, tz.ZoeDepthNK(tiny_zoe()), _rand(5, 2, 64, 96, 3))
    tm = tz.ZoeDepthNK(tiny_zoe())
    load_from_jax(tm, {"params": merge_lora(variables["params"])})
    return jm, variables, tm


@pytest.mark.parametrize("hw", [(64, 96), (32, 88)])
def test_zoedepth_nk_equals_reference(zoe_tower, hw):
    """(32, 88) is not a multiple of the patch: the trunk crops to 2x5
    patches and the metric depth is resized back to the input."""
    jm, variables, tm = zoe_tower
    img = _rand(5, 2, *hw, 3)
    want = jax.jit(jm.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = tm(to_torch(img))
    assert got.shape == (2,) + hw and (to_np(got) > 0).all()
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_estimate_depth_routes_to_zoe():
    from veon_tpu.model.veon import VeonModel as JaxModel
    from veon_tpu_torch.model.veon import VeonModel

    jcfg = with_tiny_zoe(jpresets.veon_tiny_test())
    pcfg = with_tiny_zoe(presets.veon_tiny_test())
    dimgs = _rand(6, 1, 1, 2, 32, 88, 3)
    jm = JaxModel(cfg=jcfg)
    variables = perturbed(jax.jit(jm.init, static_argnames=("method",))(
        KEY, jnp.asarray(dimgs), method=JaxModel.estimate_depth))
    want = jax.jit(jm.apply, static_argnames=("method",))(
        variables, jnp.asarray(dimgs), method=JaxModel.estimate_depth)
    model = VeonModel(pcfg, device="cpu")
    assert isinstance(model.depth, tz.ZoeDepthNK)
    load_from_jax(model.depth, {"params": merge_lora(variables["params"]["depth"])})
    with torch.no_grad():
        got = model.estimate_depth(to_torch(dimgs))
    assert got.shape == (1, 1, 2, 32, 88)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def zoe_slice():
    """The JAX F=1 presorted full forward of `veon_tiny_test` with the tiny
    zoe tower, every leaf perturbed, and the port's `entry` on the same
    weights (LoRA folded): (reference outputs, port outputs, membership)."""
    from veon_tpu.cli.shapes import example_batch_full
    from veon_tpu.geometry.frustum import sensor2keyego_chain
    from veon_tpu.lift.lss import LSSLift
    from veon_tpu.model.veon import VeonModel as JaxModel
    from veon_tpu.nn import text as text_mod
    from veon_tpu_torch.entry import entry

    jcfg = with_tiny_zoe(jpresets.veon_tiny_test())
    jcfg = dataclasses.replace(jcfg, depth=dataclasses.replace(jcfg.depth, use_lora=False))
    imgs, depth_imgs, metas = example_batch_full(jcfg)
    assert depth_imgs.shape[3:5] == jcfg.data.depth_input_size  # midas: no resize
    prompts, refl = text_mod.build_vocabulary(jcfg.vocabulary)
    ovw = jnp.asarray(np.random.default_rng(1).standard_normal(
        (len(prompts) + 1, jcfg.san.clip_embed_dim)).astype(np.float32))
    N = metas["sensor2egos"].shape[2]
    s2k = sensor2keyego_chain(metas["sensor2egos"].reshape(1, -1, 4, 4),
                              metas["ego2globals"].reshape(1, -1, 4, 4), 1, N)
    metas = dict(metas)
    metas["lift_sorted"] = LSSLift.from_config(jcfg).precompute_sorted(
        s2k[:, 0], metas["intrins"][:, 0], metas["post_rots"][:, 0],
        metas["post_trans"][:, 0], metas["bda"])
    jm = JaxModel(cfg=jcfg)
    init = jax.jit(jm.init, static_argnames=("train", "method"))
    variables = perturbed(init(jax.random.PRNGKey(1), imgs, depth_imgs, metas, ovw,
                               train=False, method=JaxModel.full_forward))
    want = jax.jit(jm.apply, static_argnames=("train", "method"))(
        variables, imgs, depth_imgs, metas, ovw, train=False, method=JaxModel.full_forward)
    pcfg = with_tiny_zoe(presets.veon_tiny_test())
    server, (pimgs, pdepth) = entry(pcfg, device="cpu",
                                    variables=dict(variables, params=merge_lora(
                                        variables["params"])))
    np.testing.assert_array_equal(to_np(pdepth), np.asarray(depth_imgs))
    np.testing.assert_array_equal(to_np(server.ov_weight), np.asarray(ovw))
    got = server.outputs(pimgs, pdepth)
    return ({k: np.asarray(v) for k, v in want.items()}, got, server.membership)


@pytest.mark.parametrize("key", ["bin_occ", "feat_occ", "sem_occ_raw", "sem_seg_ds",
                                 "sem_embed_ds", "clip_feat"])
def test_zoe_full_forward_matches_reference(zoe_slice, key):
    want, got, _m = zoe_slice
    g = to_np(got[key])
    assert g.dtype == np.float32 and np.isfinite(g).all()
    np.testing.assert_allclose(g, want[key], **TOL)


def test_zoe_class_grid_matches_reference(zoe_slice):
    """Equal wherever the decision is not a near-tie (top-2 merged-logit
    margin and |softmax(bin)[0] - 0.5| both above 1e-3)."""
    from veon_tpu.model.veon import fusion_rule
    from veon_tpu_torch.model.veon import fused_classes
    from veon_tpu_torch.nn import text as ptext

    want, got, membership = zoe_slice
    merged = to_np(ptext.merge_classes_max(torch.from_numpy(want["sem_occ_raw"]), membership,
                                           axis=-1))
    ref = np.asarray(fusion_rule(jnp.asarray(merged), jnp.asarray(want["bin_occ"])))
    grid = to_np(fused_classes(got, membership))
    top2 = np.sort(merged, -1)[..., -2:]
    b = want["bin_occ"]
    p0 = 1.0 / (1.0 + np.exp(b[..., 1] - b[..., 0]))
    clear = (((top2[..., 1] - top2[..., 0]) > 1e-3) & (np.abs(p0 - 0.5) > 1e-3)).transpose(0, 3, 2, 1)
    assert clear.mean() >= 0.99, clear.mean()
    np.testing.assert_array_equal(grid[clear], ref[clear])
    assert (ref != 17).any() and (ref == 17).any()
