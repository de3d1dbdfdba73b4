"""The port's stage-2 train step against the JAX reference on the CPU, fp32:
train-mode BatchNorm, the occupancy loss with its gradients, AdamW with
clipping and warmup plus the EMA against optax, the trainable set, and one
whole `make_train_step(mesh=None)` step at `veon_tiny_test` size with the
banded lift (its two-stream spray path) and with the full-frustum lift."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from test_torch_common import np_tree, perturbed, to_np, to_torch

from veon_tpu.cli.shapes import example_batch as j_example_batch
from veon_tpu.configs import presets as jpresets
from veon_tpu.configs.base import GridConfig as JGrid, LossConfig as JLoss
from veon_tpu.model.veon import VeonModel as JModel
from veon_tpu.nn import text as jtext
from veon_tpu.train import losses as jlosses
from veon_tpu.train import step as jstep

from veon_tpu_torch.cli.shapes import example_batch, example_depth_imgs
from veon_tpu_torch.ckpt.from_jax import state_dict_from_jax
from veon_tpu_torch.configs import presets
from veon_tpu_torch.configs.base import GridConfig, LossConfig
from veon_tpu_torch.entry import train_batch, train_entry
from veon_tpu_torch.model.veon import VeonModel
from veon_tpu_torch.nn.layers import BatchNorm
from veon_tpu_torch.train import losses as tlosses
from veon_tpu_torch.train import step as tstep


def test_batchnorm_train_mode_matches_flax():
    """Outputs, the moved running stats and the input / scale / bias
    gradients of train-mode BatchNorm vs flax nn.BatchNorm: batch stats
    with the biased variance (E[x^2] - E[x]^2), momentum 0.9. fp32, 1e-5
    (1e-4 for the gradients: sums in another order)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 3, 4, 5, 6)) * 2 + 1.5).astype(np.float32)
    stats = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    cot = rng.standard_normal(x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)

    def f(p, xx):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (y, new)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tbn = BatchNorm(6)
    with torch.no_grad():
        tbn.weight.copy_(to_torch(params["scale"]))
        tbn.bias.copy_(to_torch(params["bias"]))
        tbn.running_mean.copy_(to_torch(stats["mean"]))
        tbn.running_var.copy_(to_torch(stats["var"]))
    tx = to_torch(x).requires_grad_()
    ty = tbn(tx, train=True)
    (ty * to_torch(cot)).sum().backward()
    np.testing.assert_allclose(to_np(ty), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(tbn.running_mean), np.asarray(new["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(tbn.running_var), np.asarray(new["var"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(tx.grad), np.asarray(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(tbn.weight.grad), np.asarray(gp["scale"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(tbn.bias.grad), np.asarray(gp["bias"]), rtol=1e-4, atol=1e-4)
    # eval mode leaves the stats alone
    before = tbn.running_mean.clone()
    tbn(to_torch(x))
    assert torch.equal(before, tbn.running_mean)


@pytest.mark.parametrize("loss", ["bce_bin_occ_loss", "ce_sem_occ_loss"])
def test_cross_entropy_losses_match_reference(loss):
    """The class-weighted CE losses (binary occupancy with (1, 0.5) weights;
    semantic with the balanced 1/log-frequency weights) with ignored voxels,
    values and logit gradients at 1e-5."""
    rng = np.random.default_rng(12)
    C = 2 if loss == "bce_bin_occ_loss" else 18
    logits = rng.standard_normal((2, 4, 4, 2, C)).astype(np.float32)
    vs = rng.integers(0, 18, size=(2, 4, 4, 2)).astype(np.int32)
    vs[0, 0, 0] = 255
    want, want_g = jax.value_and_grad(lambda x: getattr(jlosses, loss)(x, jnp.asarray(vs)))(
        jnp.asarray(logits))
    t = to_torch(logits).requires_grad_()
    got = getattr(tlosses, loss)(t, to_torch(vs))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(to_np(t.grad), np.asarray(want_g), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tlosses.balanced_class_weights(), jlosses.balanced_class_weights())


def test_grid_sample_2d_matches_reference():
    """Channel-last F.grid_sample (bilinear, zeros, align_corners=False) vs
    the JAX gather form, in and outside the image, at 1e-5."""
    from veon_tpu.ops.grid_sample import grid_sample_2d as j_gs

    from veon_tpu_torch.ops.grid_sample import grid_sample_2d as t_gs

    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 6, 2)).astype(np.float32)
    np.testing.assert_allclose(to_np(t_gs(to_torch(x), to_torch(grid))),
                               np.asarray(j_gs(jnp.asarray(x), jnp.asarray(grid))),
                               rtol=1e-5, atol=1e-5)


def _loss_inputs(det: bool):
    """A tiny grid and two-camera rig. det=True: the small LossConfig of
    tests/test_losses.py (3 classes, 2 open-vocabulary ones, so the det
    term is on); det=False: the default config (det term off). A tenth of
    the voxels carry a prompt embedding exactly, so the priority-concerned
    ignorance (cosine >= high_conf_thr) has voxels to act on."""
    rng = np.random.default_rng(31)
    grid_kw = dict(x=(-4, 4, 2), y=(-4, 4, 2), z=(-1, 3, 2), depth=(1.0, 9.0, 1.0))
    B, N, C = 1, 2, 8
    nx, ny, nz = JGrid(**grid_kw).size
    if det:
        refl = [0, 0, 1, 2, 2]
        kw = dict(out_channel=4, empty_idx=3, ov_class_number=2, priority=(2, 1, 3),
                  stage2_start=2, high_conf_thr=0.9)
        jcfg, tcfg = JLoss(**kw), LossConfig(**kw)
        membership = jtext.merge_matrix(refl, extra_rows=1)
    else:
        _, refl = jtext.build_vocabulary("nuscenes_brief")
        jcfg, tcfg = JLoss(), LossConfig()
        membership = jtext.merge_matrix(refl)
    P = len(refl)
    ovw = rng.standard_normal((P + 1, C)).astype(np.float32)
    feat = rng.standard_normal((B, nx, ny, nz, C)).astype(np.float32)
    hit = rng.random((B, nx, ny, nz)) < 0.1
    feat[hit] = ovw[rng.integers(0, P, int(hit.sum()))]
    metas = {"intrins": np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1)),
             "post_rots": np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1)),
             "post_trans": np.zeros((B, N, 3), np.float32),
             "cam2camego": np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1)),
             "camego2global": np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1)),
             "lidarego2global": np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))}
    for n in range(N):
        th = n * 2.0
        metas["cam2camego"][:, n, :3, :3] = np.array(
            [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]], np.float32)
    metas["intrins"][..., 0, 0] = metas["intrins"][..., 1, 1] = 8.0
    metas["intrins"][..., 0, 2], metas["intrins"][..., 1, 2] = 12.0, 8.0
    outputs = {"bin_occ": rng.standard_normal((B, nz, ny, nx, 2)).astype(np.float32),
               "feat_occ": feat.transpose(0, 3, 2, 1, 4).copy(),
               "sem_seg_ds": rng.standard_normal((B, N, 6, 10, P)).astype(np.float32)}
    vs = rng.integers(0, jcfg.out_channel, size=(B, nx, ny, nz)).astype(np.int32)
    mask = np.ones_like(vs)
    mask[0, 0] = 0
    return (grid_kw, outputs, vs, mask, metas, ovw, membership, jcfg, tcfg, (24, 20))


@pytest.mark.parametrize("det", [True, False], ids=["det_on", "det_off"])
@pytest.mark.parametrize("epoch", [0, 3])
def test_occupancy_loss_matches_reference(epoch, det):
    """occupancy_loss values at 1e-5 and its gradients w.r.t. bin_occ and
    feat_occ at 1e-5, at epoch 0 and at epoch 3 (priority ignorance on)."""
    grid_kw, outputs, vs, mask, metas, ovw, membership, jcfg, tcfg, hw = _loss_inputs(det)
    wrt = ("bin_occ", "feat_occ")

    def jfn(*diff):
        out = dict(outputs, **dict(zip(wrt, diff)))
        d = jlosses.occupancy_loss(out, jnp.asarray(vs), jnp.asarray(mask),
                                   {k: jnp.asarray(v) for k, v in metas.items()},
                                   jnp.asarray(ovw), membership, JGrid(**grid_kw), hw,
                                   jnp.asarray(epoch), jcfg)
        return sum(d.values()), d

    (_, want), want_g = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        *(jnp.asarray(outputs[k]) for k in wrt))
    t_out = {k: to_torch(v).requires_grad_(k in wrt) for k, v in outputs.items()}
    got = tlosses.occupancy_loss(t_out, to_torch(vs), to_torch(mask),
                                 {k: to_torch(v) for k, v in metas.items()}, to_torch(ovw),
                                 membership, GridConfig(**grid_kw), hw, epoch, tcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, atol=1e-6)
    sum(got.values()).backward()
    for k, g in zip(wrt, want_g):
        assert np.abs(np.asarray(g)).max() > 0
        np.testing.assert_allclose(to_np(t_out[k].grad), np.asarray(g), rtol=1e-5, atol=1e-6)


def test_optimizer_and_ema_match_optax():
    """Three steps of the hand-written AdamW + clip + warmup and the EMA vs
    optax (make_optimizer with the stage-2 labels) on a small tree with a
    frozen leaf; the second step's gradients exceed the clip norm. Post-step
    params, moments and EMA at 1e-6; the learning rate at 1e-7 relative."""
    rng = np.random.default_rng(9)
    params = {"hsa": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
              "alignnet": {"b": rng.standard_normal(5).astype(np.float32)},
              "depth": {"w": rng.standard_normal(3).astype(np.float32)}}
    grads = [{k: {n: (rng.standard_normal(a.shape) * s).astype(np.float32)
                  for n, a in sub.items()} for k, sub in params.items()} for s in (0.5, 40.0, 1.0)]
    labels = jstep.trainable_mask(params, jstep.stage2_trainable)
    jtx = jstep.make_optimizer(labels=labels)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt, jema, jupd = jtx.init(jp), jp, jnp.asarray(10560.0)
    ttx = tstep.AdamW()
    tp = {f"{k}.{n}": to_torch(a) for k, sub in params.items() for n, a in sub.items()}
    train = {n: p for n, p in tp.items() if tstep.stage2_trainable(tuple(n.split(".")))}
    assert sorted(train) == ["alignnet.b", "hsa.w"]
    topt = ttx.init(train)
    tema = {n: p.clone() for n, p in tp.items()}
    tupd = torch.tensor(10560.0)
    for g in grads:
        updates, jopt = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jopt, jp)
        jp = optax.apply_updates(jp, updates)
        jupd = jupd + 1.0
        jema = jstep.ema_update(jema, jp, jstep.ema_decay(jupd))
        topt = ttx.update({n: to_torch(g[n.split(".")[0]][n.split(".")[1]]) for n in train},
                          topt, train)
        tupd = tupd + 1.0
        tstep.ema_update(tema, tp, tstep.ema_decay(tupd))
        for n, p in tp.items():
            k, leaf = n.split(".")
            np.testing.assert_allclose(to_np(p), np.asarray(jp[k][leaf]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(to_np(tema[n]), np.asarray(jema[k][leaf]),
                                       rtol=1e-6, atol=1e-7)
    assert np.array_equal(to_np(tp["depth.w"]), params["depth"]["w"])  # frozen: no update
    assert topt.count == 3
    mu = _adam_moments(jopt)
    for n in train:
        k, leaf = n.split(".")
        np.testing.assert_allclose(to_np(topt.mu[n]), mu[k][leaf], rtol=1e-6, atol=1e-9)
    sched = optax.join_schedules([optax.linear_schedule(1e-7, 1e-4, 200),
                                  optax.constant_schedule(1e-4)], [200])
    for c in (0, 1, 2, 100, 199, 200, 500):
        np.testing.assert_allclose(float(ttx.learning_rate(c)), float(sched(c)), rtol=1e-7)


def _adam_moments(opt_state):
    """The first moments of the trainable partition of an optax
    multi_transform state, as nested dicts (frozen leaves dropped)."""
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1

    def strip(t):
        if isinstance(t, dict):
            out = {k: strip(v) for k, v in t.items()}
            return {k: v for k, v in out.items() if v is not None and not _empty(v)}
        return None if isinstance(t, optax.MaskedNode) else np.asarray(t)

    return strip(dict(adam[0].mu))


def _cfgs(banded: bool):
    """veon_tiny_test without LoRA, with the production 0.5 m depth bins (so
    the banded lift's K=17 band is narrower than the D+1=89 bins and the far
    spray, kernel #3's second stream, runs), JAX and port."""
    grid = dict(x=(-40.0, 40.0, 4.0), y=(-40.0, 40.0, 4.0), z=(-1.0, 5.4, 1.6),
                depth=(1.0, 45.0, 0.5))
    j = jpresets.veon_tiny_test()
    j = dataclasses.replace(j, grid=JGrid(**grid), lss_banded=banded,
                            depth=dataclasses.replace(j.depth, use_lora=False))
    t = dataclasses.replace(presets.veon_tiny_test(), grid=GridConfig(**grid), lss_banded=banded)
    return j, t


def _far_depth(cfg):
    """Metric depth U(1.5, 59.5) m, constant over each 8x8 block so the
    lift's min-pool keeps it and a quarter of the pixels lie past the
    ~45.8 m spray threshold."""
    B, N = 1, cfg.data.num_cams
    h, w = cfg.feat_hw
    d = np.random.default_rng(17).uniform(1.5, 59.5, (B, 1, N, h, w)).astype(np.float32)
    return np.repeat(np.repeat(d, 8, axis=3), 8, axis=4)


@pytest.fixture(scope="module", params=["banded", "full"])
def stepped(request):
    """One JAX make_train_step(mesh=None) step and one port step from the
    same perturbed weights and batch. banded: lss_banded=True with the far
    depths in the batch; full: lss_banded=False with depth_imgs, so the
    frozen depth tower runs inside both steps."""
    banded = request.param == "banded"
    jcfg, tcfg = _cfgs(banded)
    imgs, depth, metas = j_example_batch(jcfg)
    batch = train_batch(tcfg, device="cpu")
    np.testing.assert_array_equal(to_np(batch["imgs"]), np.asarray(imgs))
    if banded:
        del batch["depth_imgs"]
        batch["depth"] = to_torch(_far_depth(tcfg))
    jbatch = {"imgs": imgs, "metas": metas, "ov_weight": jnp.asarray(to_np(batch["ov_weight"])),
              "voxel_semantics": jnp.asarray(to_np(batch["voxel_semantics"])),
              "mask_camera": jnp.asarray(to_np(batch["mask_camera"])),
              "epoch": jnp.asarray(0, jnp.int32)}
    for k in ("depth", "depth_imgs"):
        if k in batch:
            jbatch[k] = jnp.asarray(to_np(batch[k]))
    model = JModel(cfg=jcfg)
    init = jax.jit(model.init, static_argnames=("train", "method"))
    depth_imgs = jnp.asarray(to_np(example_depth_imgs(tcfg, device="cpu")))
    variables = perturbed(init(jax.random.PRNGKey(2), imgs, depth_imgs, metas,
                               jbatch["ov_weight"], train=True, method=JModel.full_forward),
                          seed=3)
    _, refl = jtext.build_vocabulary(jcfg.vocabulary)
    membership = jtext.merge_matrix(refl)
    jtx = jstep.make_optimizer(labels=jstep.trainable_mask(variables["params"],
                                                           jstep.stage2_trainable))
    jstate = jstep.create_train_state(model, jax.tree_util.tree_map(jnp.asarray, variables), jtx)
    jstate, jlosses_ = jstep.make_train_step(model, jtx, jcfg, membership, mesh=None)(
        jstate, jbatch)

    trainer, _ = train_entry(tcfg, device="cpu", variables=variables)
    tlosses_ = trainer(batch)
    return dict(model=trainer.model, state=trainer.state, losses=tlosses_, jstate=jstate,
                jlosses={k: float(v) for k, v in jlosses_.items()}, variables=variables)


def test_train_step_losses_match_reference(stepped):
    """The loss dict at 2e-4 (the tolerance of the whole serving forward)."""
    got, want = stepped["losses"], stepped["jlosses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=2e-4, atol=2e-4)


def test_train_step_gradients_match_reference(stepped):
    """Every trainable param's gradient as the optimizer took it (Adam's
    first moment after one step = (1 - b1) * the clipped gradient), within
    1e-4 of the largest gradient entry of the step (fp32 through the whole
    backward, sums in another order; the biases in front of a train-mode
    BatchNorm have a gradient of 0 up to rounding, so no per-tensor
    relative bound)."""
    mu = state_dict_from_jax(stepped["model"], {"params": _adam_moments(stepped["jstate"].opt_state)},
                             strict=False)
    got = stepped["state"].opt_state.mu
    assert sorted(got) == sorted(mu) and len(got) > 10
    scale = max(np.abs(to_np(w)).max() for w in mu.values())
    for n, want in mu.items():
        np.testing.assert_allclose(to_np(got[n]), to_np(want), rtol=0, atol=1e-4 * scale,
                                   err_msg=n)


def test_train_step_batch_stats_match_reference(stepped):
    """The moved BatchNorm running stats at 1e-4."""
    want = state_dict_from_jax(stepped["model"],
                               {"batch_stats": np_tree(stepped["jstate"].batch_stats)}, strict=False)
    bufs = dict(stepped["model"].named_buffers())
    assert sorted(want) == sorted(bufs)
    for n, w in want.items():
        np.testing.assert_allclose(to_np(bufs[n]), to_np(w), rtol=1e-4, atol=1e-5, err_msg=n)


def test_train_step_ema_matches_reference(stepped):
    """The EMA of every param and running stat at 1e-5, and its update count."""
    state, jstate = stepped["state"], stepped["jstate"]
    assert float(state.ema_updates) == float(jstate.ema_updates) == 10561.0
    want = state_dict_from_jax(stepped["model"], {"params": np_tree(jstate.ema_params),
                                                  "batch_stats": np_tree(jstate.ema_batch_stats)})
    ema = {**state.ema_params, **state.ema_batch_stats}
    assert sorted(ema) == sorted(want)
    for n, w in want.items():
        np.testing.assert_allclose(to_np(ema[n]), to_np(w), rtol=1e-5, atol=1e-6, err_msg=n)


def test_trainable_set_matches_reference(stepped):
    """requires_grad is set exactly on the params JAX labels "train"
    (hsa, lift_fusion, alignnet), and the frozen towers are untouched."""
    labels = jstep.trainable_mask(stepped["variables"]["params"], jstep.stage2_trainable)
    train_tree = jax.tree_util.tree_map(lambda a, lab: a if lab == "train" else None,
                                        stepped["variables"]["params"], labels)
    want = state_dict_from_jax(stepped["model"], {"params": _drop_none(train_tree)}, strict=False)
    model = stepped["model"]
    got = {n for n, p in model.named_parameters() if p.requires_grad}
    assert got == set(want)
    assert {n.split(".")[0] for n in got} == {"hsa", "lift_fusion", "alignnet"}
    frozen = state_dict_from_jax(model, stepped["variables"])
    for n, p in model.named_parameters():
        if n not in got:
            assert torch.equal(p.detach(), frozen[n]), n


def _empty(v):
    return isinstance(v, dict) and not v


def _drop_none(t):
    if isinstance(t, dict):
        out = {k: _drop_none(v) for k, v in t.items()}
        return {k: v for k, v in out.items() if v is not None and not _empty(v)}
    return t


def test_train_batch_matches_build_train_setup():
    """The synthetic batch: the JAX example batch's arrays and loss metas,
    ov_weight and voxel labels from default_rng(7), the depth images of
    the full example batch."""
    jcfg, tcfg = _cfgs(True)
    imgs, depth, metas = j_example_batch(jcfg)
    batch = train_batch(tcfg, device="cpu")
    t_imgs, t_depth, t_metas = example_batch(tcfg, device="cpu")
    np.testing.assert_array_equal(to_np(t_depth), np.asarray(depth))
    assert set(t_metas) == set(metas)
    for k, v in metas.items():
        np.testing.assert_array_equal(to_np(batch["metas"][k]), np.asarray(v), err_msg=k)
    rng = np.random.default_rng(7)
    ovw = rng.standard_normal(tuple(batch["ov_weight"].shape)).astype(np.float32)
    np.testing.assert_array_equal(to_np(batch["ov_weight"]), ovw)
    nx, ny, nz = tcfg.grid.size
    np.testing.assert_array_equal(to_np(batch["voxel_semantics"]),
                                  rng.integers(0, 18, size=(1, nx, ny, nz)).astype(np.int32))
    assert to_np(batch["depth_imgs"]).shape == tuple(example_depth_imgs(tcfg, device="cpu").shape)


def test_train_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_entry(presets.veon_tiny_test())


def test_train_step_keeps_f1_only():
    _, tcfg = _cfgs(True)
    model = VeonModel(dataclasses.replace(tcfg, num_temporal=2), device="cpu")
    imgs, depth, metas = example_batch(dataclasses.replace(tcfg, num_temporal=2), device="cpu")
    with pytest.raises(NotImplementedError, match="F>1"):
        model(imgs, depth, metas, torch.zeros(67, 16), train=True)

