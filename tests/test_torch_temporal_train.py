"""The port's temporal training (F>1) against the JAX package on the CPU,
fp32, at `veon_tiny_test` size with shared perturbed weights:

- `TemporalFusion` in train mode against flax's with
  mutable=["batch_stats"], on both deformable routes (the 3x3x3 stencil
  and the `grid_sample` gather): the output, every param's gradient and
  the moved running stats, `before_fusion`'s moved once per frame and
  `t_deform.final_norm`'s twice;
- one whole stage-2 step, JAX's `make_train_step(mesh=None)` and the
  port's, at F=2 and F=3 on both routes, with the banded lift and its far
  spray (kernel #3's two streams, F launches per step on the card): the
  losses, every trainable leaf's gradient (the temporal leaves named),
  the running stats, the params and the EMA after the step;
- `train --num-temporal 2 --temporal-start-epoch 1 --epochs 2` through
  both CLIs on the synthetic nuScenes fixture with the same
  reference-layout checkpoint files: the losses of every step (epoch 0 on
  the current frame, epoch 1 on two frames) and the final params and
  running stats.
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_data_pipeline import _make_fixture
from test_torch_common import (close_per_leaf, np_tree, perturbed, to_np, to_torch,
                               zero_grad_biases)
from test_torch_mirror import write_weights_dir
from test_torch_train import _adam_moments, _cfgs

import veon_tpu.nn.alignnet as jalign
import veon_tpu.train.step as jstep_mod
from veon_tpu.cli import main as jcli
from veon_tpu.cli.shapes import example_batch as j_example_batch
from veon_tpu.ckpt import io as jio
from veon_tpu.configs import presets as jpresets
from veon_tpu.model.veon import VeonModel as JModel
from veon_tpu.nn import text as jtext
from veon_tpu.train import step as jstep

from veon_tpu_torch.ckpt import io as tio
from veon_tpu_torch.ckpt.from_jax import state_dict_from_jax
from veon_tpu_torch.cli import main as pcli
from veon_tpu_torch.cli.shapes import example_depth_imgs
from veon_tpu_torch.configs import presets
from veon_tpu_torch.entry import build_model, train_batch, train_entry
from veon_tpu_torch.nn.alignnet import TemporalFusion
from veon_tpu_torch.train import step as tstep

ROUTES = ("stencil", "gather")
# the BatchNorms that one train-mode forward moves more than once
MULTI_MOVED = ("before_fusion.bn", "t_deform.final_norm")


class _GatherDeformable(jalign.TemporalDeformable):
    """JAX's deformable attention on its general gather path."""

    use_stencil: bool = False


@contextlib.contextmanager
def jax_route(route):
    """JAX's TemporalFusion building the deformable attention of `route`."""
    with pytest.MonkeyPatch.context() as mp:
        if route == "gather":
            mp.setattr(jalign, "TemporalDeformable", _GatherDeformable)
        yield


def set_route(module, route):
    for m in module.modules():
        if hasattr(m, "use_stencil"):
            m.use_stencil = route == "stencil"


@pytest.mark.parametrize("route", ROUTES)
def test_temporal_fusion_train_mode_matches_flax(route):
    """Two previous frames (F=3): the fused output at 1e-5, every param's
    gradient under a random cotangent within 1e-4 of its own largest
    entry, the running stats after the call at rtol 1e-4 / atol 1e-5,
    `before_fusion`'s moved three times (current frame first) and
    `t_deform.final_norm`'s twice, as flax's calls move them."""
    rng = np.random.default_rng(21)
    dim, shape = 8, (1, 3, 5, 6)
    cur = rng.standard_normal(shape + (dim,)).astype(np.float32)
    prevs = [rng.standard_normal(shape + (dim,)).astype(np.float32) for _ in range(2)]
    cot = rng.standard_normal(shape + (dim,)).astype(np.float32)
    with jax_route(route):
        jmod = jalign.TemporalFusion(features=dim, seqs=2)
        variables = perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(cur),
                                        [jnp.asarray(p) for p in prevs]), seed=4)

        def f(params):
            y, upd = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(cur), [jnp.asarray(p) for p in prevs], train=True,
                                mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, upd["batch_stats"])

        (_, (want_y, want_stats)), want_g = jax.value_and_grad(f, has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    mod = TemporalFusion(dim, 2)
    mod.load_state_dict(state_dict_from_jax(mod, variables))
    set_route(mod, route)
    calls = {p: 0 for p in MULTI_MOVED}
    for p in MULTI_MOVED:
        mod.get_submodule(p).register_forward_hook(
            lambda *_a, p=p: calls.__setitem__(p, calls[p] + 1))
    y = mod(to_torch(cur), [to_torch(p) for p in prevs], train=True)
    (y * to_torch(cot)).sum().backward()
    np.testing.assert_allclose(to_np(y), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    want_grads = {n: to_np(t) for n, t in state_dict_from_jax(
        mod, {"params": np_tree(want_g)}, strict=False).items()}
    got_grads = {n: to_np(p.grad) for n, p in mod.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    close_per_leaf(got_grads, want_grads, route, zero_grad_biases(mod))
    want_b = state_dict_from_jax(mod, {"batch_stats": np_tree(want_stats)}, strict=False)
    bufs = dict(mod.named_buffers())
    assert sorted(want_b) == sorted(bufs)
    for n, w in want_b.items():
        np.testing.assert_allclose(to_np(bufs[n]), to_np(w), rtol=1e-4, atol=1e-5, err_msg=n)
    assert calls == {"before_fusion.bn": 3, "t_deform.final_norm": 2}


def _far_depth_frames(cfg):
    """Metric depth U(1.5, 59.5) m for each of the F frames, constant over
    each 8x8 block (the lift's min-pool keeps it), a quarter of the pixels
    past the spray threshold (`test_torch_train.py` `_far_depth`, per
    frame)."""
    N, (h, w) = cfg.data.num_cams, cfg.feat_hw
    d = np.random.default_rng(17).uniform(1.5, 59.5, (1, cfg.num_temporal, N, h, w))
    return np.repeat(np.repeat(d.astype(np.float32), 8, axis=3), 8, axis=4)


@pytest.fixture(scope="module", params=[(2, "stencil"), (2, "gather"), (3, "stencil"),
                                        (3, "gather")], ids=lambda p: f"F{p[0]}_{p[1]}")
def tstepped(request):
    """One JAX make_train_step(mesh=None) step and one port step at F
    frames on one deformable route, from the same perturbed weights and
    batch (banded lift, far depths: the spray runs on every frame)."""
    F, route = request.param
    jcfg, tcfg = (dataclasses.replace(c, num_temporal=F) for c in _cfgs(True))
    imgs, _depth, metas = j_example_batch(jcfg)
    batch = train_batch(tcfg, device="cpu")
    np.testing.assert_array_equal(to_np(batch["imgs"]), np.asarray(imgs))
    del batch["depth_imgs"]
    batch["depth"] = to_torch(_far_depth_frames(tcfg))
    jbatch = {"imgs": imgs, "metas": metas, "ov_weight": jnp.asarray(to_np(batch["ov_weight"])),
              "voxel_semantics": jnp.asarray(to_np(batch["voxel_semantics"])),
              "mask_camera": jnp.asarray(to_np(batch["mask_camera"])),
              "epoch": jnp.asarray(0, jnp.int32), "depth": jnp.asarray(to_np(batch["depth"]))}
    for k, v in metas.items():
        np.testing.assert_array_equal(to_np(batch["metas"][k]), np.asarray(v), err_msg=k)
    with jax_route(route):
        model = JModel(cfg=jcfg)
        depth_imgs = jnp.asarray(to_np(example_depth_imgs(tcfg, device="cpu")))
        variables = perturbed(jax.jit(model.init, static_argnames=("train", "method"))(
            jax.random.PRNGKey(2), imgs, depth_imgs, metas, jbatch["ov_weight"], train=True,
            method=JModel.full_forward), seed=3)
        _, refl = jtext.build_vocabulary(jcfg.vocabulary)
        jtx = jstep.make_optimizer(labels=jstep.trainable_mask(variables["params"],
                                                               jstep.stage2_trainable))
        jstate = jstep.create_train_state(model, jax.tree_util.tree_map(jnp.asarray, variables),
                                          jtx)
        jstate, jlosses = jstep.make_train_step(model, jtx, jcfg, jtext.merge_matrix(refl),
                                                mesh=None)(jstate, jbatch)
    trainer, _ = train_entry(tcfg, device="cpu", variables=variables)
    set_route(trainer.model, route)
    tlosses = trainer(batch)
    return dict(model=trainer.model, state=trainer.state, losses=tlosses, jstate=jstate,
                jlosses={k: float(v) for k, v in jlosses.items()}, variables=variables, F=F)


def test_temporal_step_losses_match_reference(tstepped):
    got, want = tstepped["losses"], tstepped["jlosses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=2e-4, atol=2e-4, err_msg=k)


def test_temporal_step_gradients_match_reference(tstepped):
    """Every trainable leaf's gradient as the optimizer took it (Adam's
    first moment after one step) within 1e-4 of its own largest entry (the
    biases in front of a train-mode BatchNorm, 0 up to rounding, within
    1e-4 of the step's largest entry), the temporal leaves by name: every
    conv of before_fusion, t_fuse_*, t_deform (the offset convs included)
    and t_final carries a gradient."""
    model = tstepped["model"]
    mu = {n: to_np(t) for n, t in state_dict_from_jax(
        model, {"params": _adam_moments(tstepped["jstate"].opt_state)}, strict=False).items()}
    got = {n: to_np(t) for n, t in tstepped["state"].opt_state.mu.items()}
    assert sorted(got) == sorted(mu)
    pre = "alignnet.temporal_fusion."
    temporal = {n for n in mu if n.startswith(pre)}
    want_names = {f"{pre}{m}.conv.weight" for m in
                  ["before_fusion", "t_final"] + [f"t_fuse_{i}" for i in range(tstepped["F"] - 1)]}
    want_names |= {f"{pre}t_deform.{c}.weight" for c in
                   ("key_value_proj", "query_proj", "offset_conv1", "offset_conv2", "out_proj")}
    assert want_names <= temporal
    for n in want_names:
        assert np.abs(mu[n]).max() > 0, n
    close_per_leaf(got, mu, "gradient", zero_grad_biases(model))


def test_temporal_step_batch_stats_match_reference(tstepped):
    """Every running stat after the step at rtol 1e-4 / atol 1e-5, the
    multiply-moved ones (before_fusion F times, t_deform.final_norm twice)
    among them."""
    model = tstepped["model"]
    want = state_dict_from_jax(model, {"batch_stats": np_tree(tstepped["jstate"].batch_stats)},
                               strict=False)
    bufs = dict(model.named_buffers())
    assert sorted(want) == sorted(bufs)
    for prefix in MULTI_MOVED:
        assert f"alignnet.temporal_fusion.{prefix}.running_var" in want
    for n, w in want.items():
        np.testing.assert_allclose(to_np(bufs[n]), to_np(w), rtol=1e-4, atol=1e-5, err_msg=n)


def test_temporal_step_params_and_ema_match_reference(tstepped):
    """The params after the step and the EMA of every param and running
    stat at 1e-5, and the EMA's update count."""
    state, jstate, model = tstepped["state"], tstepped["jstate"], tstepped["model"]
    assert float(state.ema_updates) == float(jstate.ema_updates) == 10561.0
    params = state_dict_from_jax(model, {"params": np_tree(jstate.params)}, strict=False)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(to_np(p), to_np(params[n]), rtol=1e-5, atol=1e-5, err_msg=n)
    want = state_dict_from_jax(model, {"params": np_tree(jstate.ema_params),
                                       "batch_stats": np_tree(jstate.ema_batch_stats)})
    ema = {**state.ema_params, **state.ema_batch_stats}
    assert sorted(ema) == sorted(want)
    for n, w in want.items():
        np.testing.assert_allclose(to_np(ema[n]), to_np(w), rtol=1e-5, atol=1e-5, err_msg=n)


def _fixture_preset(mod):
    def veon_tiny_fixture(num_temporal=1):
        cfg = mod.veon_tiny_test(num_temporal=num_temporal)
        return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, src_size=(90, 160)))
    return veon_tiny_fixture


def test_temporal_train_cli_matches_reference(monkeypatch, tmp_path):
    """`train --num-temporal 2 --temporal-start-epoch 1 --epochs 2` through
    both CLIs on the 3-frame fixture with the same reference-layout
    checkpoint files: epoch 0 takes current-frame batches and epoch 1
    two-frame ones; the losses of all six steps at 2e-4, the final
    trained params (hsa, lift_fusion, alignnet) at 1e-5 and their running
    stats at 1e-4, both at step 6."""
    root = str(tmp_path / "nusc")
    os.makedirs(root)
    pkl = _make_fixture(root)
    paths = write_weights_dir(presets.veon_tiny_test(num_temporal=2), str(tmp_path / "ckpts"))
    for mod in (jpresets, presets):
        monkeypatch.setattr(mod, "veon_tiny_fixture", _fixture_preset(mod), raising=False)
    seen = {"port": [], "jax": []}

    def recording(orig, side):
        def factory(*a, **kw):
            if side == "jax" and kw.get("mesh") is None:
                # the JAX CLI builds its model with bn_axis_name="batch" and
                # meshes only more than one device: its step over a
                # one-device batch mesh (each pmean the identity)
                kw["mesh"] = Mesh(np.asarray(jax.devices()[:1]), ("batch",))
            step = orig(*a, **kw)

            def recorded(state, batch):
                state, losses = step(state, batch)
                seen[side].append(({k: float(v) for k, v in losses.items()},
                                   int(np.asarray(batch["imgs"]).shape[1])))
                return state, losses
            return recorded
        return factory

    monkeypatch.setattr(pcli, "make_train_step", recording(tstep.make_train_step, "port"))
    monkeypatch.setattr(jstep_mod, "make_train_step", recording(jstep.make_train_step, "jax"))
    # one device: the JAX CLI meshes every device it sees, and the 8
    # virtual CPU devices cannot split one sample
    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    argv = ["train", "--preset", "veon_tiny_fixture", "--data-root", root, "--ann", pkl,
            "--workers", "1", "--load-from", paths["san"], "--depth-load-from", paths["depth"],
            "--bpe-path", paths["bpe"], "--num-temporal", "2", "--temporal-start-epoch", "1",
            "--epochs", "2"]
    assert pcli.main(argv + ["--device", "cpu", "--work-dir", str(tmp_path / "port")]) == \
        {"start_epoch": 0, "step": 6}
    jcli.main(argv + ["--work-dir", str(tmp_path / "jax")])
    frames = [f for _, f in seen["port"]]
    assert frames == [f for _, f in seen["jax"]] == [1, 1, 1, 2, 2, 2]
    for (g, _), (w, _) in zip(seen["port"], seen["jax"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=2e-4, err_msg=k)
    got = tio.load_checkpoint(str(tmp_path / "port" / "step_6"))
    want = jio.load_checkpoint(str(tmp_path / "jax" / "step_6"))
    assert int(got["step"]) == int(np.asarray(want["step"])) == 6
    model = build_model(presets.veon_tiny_test(num_temporal=2), torch.device("cpu"), 0, None)
    trained = ("hsa", "lift_fusion", "alignnet")  # JAX's tree also keeps the depth adapters
    for col, tol in (("params", 1e-5), ("batch_stats", 1e-4)):
        g, w = ({k: np_tree(v) for k, v in tree[col].items() if k in trained}
                for tree in (got, want))
        g = state_dict_from_jax(model, {col: g}, strict=False)
        w = state_dict_from_jax(model, {col: w}, strict=False)
        assert sorted(g) == sorted(w) and len(g) > 10
        for n in w:
            np.testing.assert_allclose(to_np(g[n]), to_np(w[n]), rtol=tol, atol=tol, err_msg=n)
    assert os.path.isfile(str(tmp_path / "port" / "train.log.jsonl"))
