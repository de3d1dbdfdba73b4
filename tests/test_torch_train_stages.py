"""The port's training recipe pieces against the JAX reference on the CPU,
fp32: `LoRADense` with adapters, the stage-1 depth losses and the rest of
`train/losses.py`, the optimizer with gradient accumulation against
`optax.MultiSteps`, the EMA gating, the stage-1 step on the JAX tests'
tiny DA-V2 and tiny ZoeDepth-NK, and the three trainable sets.

Inputs come from numpy seeds; every JAX function runs jitted, as the
training graph does. Tolerance 1e-5 unless a case states another."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_common import np_tree, perturbed, to_np, to_torch
from test_torch_mirror import TINY_ZOE

from veon_tpu.configs import presets as jpresets
from veon_tpu.configs.base import (DepthConfig as JDepth, GridConfig as JGrid,
                                   LossConfig as JLoss, ZoeConfig as JZoe)
from veon_tpu.nn.dpt import DepthAnythingV2 as JDav2
from veon_tpu.nn.layers import LoRADense as JLoRADense
from veon_tpu.nn.zoedepth import ZoeDepthNK as JZoeNK
from veon_tpu.train import depth_pretrain as jdp
from veon_tpu.train import losses as jl
from veon_tpu.train import step as jstep

from veon_tpu_torch.ckpt.from_jax import load_from_jax, state_dict_from_jax
from veon_tpu_torch.configs.base import DepthConfig, GridConfig, LossConfig, ZoeConfig
from veon_tpu_torch.model.veon import VeonModel
from veon_tpu_torch.nn.dpt import DepthAnythingV2
from veon_tpu_torch.nn.layers import LoRADense, init_random_
from veon_tpu_torch.nn.zoedepth import ZoeDepthNK
from veon_tpu_torch.train import depth_pretrain as tdp
from veon_tpu_torch.train import losses as tl
from veon_tpu_torch.train import step as tstep

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def test_lora_dense_matches_flax():
    """LoRADense r=2, alpha 4 with a nonzero lora_B: output and the
    gradients of x, the base kernel and both adapters."""
    rng = _rng(0)
    x = rng.standard_normal((3, 5, 6)).astype(np.float32)
    cot = rng.standard_normal((3, 5, 4)).astype(np.float32)
    mod = JLoRADense(4, lora_r=2, lora_alpha=4.0)
    params = perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    assert np.abs(params["lora_B"]).min() > 0

    def f(p, xx):
        y = mod.apply({"params": p}, xx)
        return jnp.sum(y * cot), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    t = LoRADense(6, 4, lora_r=2, lora_alpha=4.0)
    load_from_jax(t, {"params": params})
    tx = to_torch(x).requires_grad_()
    ty = t(tx)
    (ty * to_torch(cot)).sum().backward()
    np.testing.assert_allclose(to_np(ty), np.asarray(y), **TOL)
    np.testing.assert_allclose(to_np(tx.grad), np.asarray(gx), **TOL)
    np.testing.assert_allclose(to_np(t.lora_A.grad), np.asarray(gp["lora_A"]), **TOL)
    np.testing.assert_allclose(to_np(t.lora_B.grad), np.asarray(gp["lora_B"]), **TOL)
    np.testing.assert_allclose(to_np(t.base.weight.grad).T, np.asarray(gp["base"]["kernel"]),
                               **TOL)
    # r=0 stays the plain Dense under `base`
    assert [n for n, _ in LoRADense(6, 4).named_parameters()] == ["base.weight", "base.bias"]


def test_lora_init_matches_flax_scales():
    """init_random_ gives lora_A flax's variance_scaling(1/3, fan_in,
    uniform) range and lora_B zeros."""
    t = LoRADense(300, 8, lora_r=16)
    init_random_(t, torch.Generator().manual_seed(0))
    bound = 1 / np.sqrt(300)
    a = to_np(t.lora_A)
    assert np.abs(a).max() <= bound and np.abs(a).max() > 0.95 * bound
    assert abs(a.std() - bound / np.sqrt(3)) < 0.05 * bound
    assert not to_np(t.lora_B).any()


GRID = dict(x=(-40.0, 40.0, 0.4), y=(-40.0, 40.0, 0.4), z=(-1.0, 5.4, 0.4),
            depth=(1.0, 45.0, 0.5))


def _depth_pair(seed, empty=False):
    """Predicted depth (1, 2, 16, 24) in (0.5, 60) m and sparse GT with a
    third of the pixels missing (0), some past the bins; `empty`: no valid GT."""
    rng = _rng(seed)
    pred = rng.uniform(0.5, 60.0, (1, 2, 16, 24)).astype(np.float32)
    gt = rng.uniform(0.5, 60.0, (1, 2, 16, 24)).astype(np.float32)
    gt[rng.random(gt.shape) < 0.33] = 0.0
    if empty:
        gt[:] = 1e5
    return pred, gt


def _loss_case(name, empty):
    """(jax fn, port fn, inputs, index of the differentiated input)."""
    jg, tg = JGrid(**GRID), GridConfig(**GRID)
    rng = _rng(5)
    if name in ("silog_loss", "depth_bin_ce_loss", "depth_pretrain_loss"):
        pred, gt = _depth_pair(3, empty)
        args = (pred, gt)
        extra = {"silog_loss": ((), ()), "depth_bin_ce_loss": ((jg,), (tg,)),
                 "depth_pretrain_loss": ((jg, JLoss()), (tg, LossConfig()))}[name]
        jf = lambda p, g: getattr(jl, name)(p, g, *extra[0])  # noqa: E731
        tf = lambda p, g: getattr(tl, name)(p, g, *extra[1])  # noqa: E731
        return jf, tf, args, 0
    if name == "depth_bce_loss":
        _pred, gt = _depth_pair(4, empty)
        gt = np.repeat(np.repeat(gt, 4, -2), 4, -1)  # (1, 2, 64, 96) at downsample 16 -> 4x6
        D = jg.num_depth_bins
        bins = rng.uniform(size=(1, 2, D, 4, 6)).astype(np.float32)
        bins /= bins.sum(2, keepdims=True)
        return (lambda b, g: jl.depth_bce_loss(b, g, jg, 16),
                lambda b, g: tl.depth_bce_loss(b, g, tg, 16), (bins, gt), 0)
    if name in ("geo_scal_loss", "sem_scal_loss"):
        logits = rng.standard_normal((1, 6, 5, 4, 18)).astype(np.float32)
        tgt = rng.integers(0, 18, (1, 6, 5, 4)).astype(np.int32)
        tgt[0, 0] = 255
        if empty:
            tgt[:] = 255
        return (getattr(jl, name), getattr(tl, name), (logits, tgt), 0)
    if name == "pixel_align_2d_loss":
        seg = rng.standard_normal((1, 2, 8, 12, 5)).astype(np.float32)
        feat = rng.standard_normal((1, 2, 4, 6, 7)).astype(np.float32)
        ovw = rng.standard_normal((6, 7)).astype(np.float32)
        return jl.pixel_align_2d_loss, tl.pixel_align_2d_loss, (seg, feat, ovw), 1
    assert name == "vel_loss"
    a, b = rng.standard_normal((2, 3, 4, 2)).astype(np.float32)
    return jl.vel_loss, tl.vel_loss, (a, b), 0


LOSSES = ["silog_loss", "depth_bin_ce_loss", "depth_bce_loss", "depth_pretrain_loss",
          "geo_scal_loss", "sem_scal_loss", "pixel_align_2d_loss", "vel_loss"]


@pytest.mark.parametrize("name, empty", [(n, False) for n in LOSSES] + [
    (n, True) for n in ("silog_loss", "depth_bin_ce_loss", "depth_bce_loss",
                        "depth_pretrain_loss", "geo_scal_loss", "sem_scal_loss")])
def test_losses_match_reference(name, empty):
    """Each loss and its gradient w.r.t. the prediction (scores or logits),
    JAX jitted; `empty`: no valid pixel or voxel."""
    jf, tf, args, wrt = _loss_case(name, empty)

    def total(*a):
        out = jf(*a)
        return sum(out.values()) if isinstance(out, dict) else out

    want, want_g = jax.jit(jax.value_and_grad(total, argnums=wrt))(*map(jnp.asarray, args))
    targs = [to_torch(a) for a in args]
    targs[wrt].requires_grad_()
    got = tf(*targs)
    if isinstance(got, dict):
        jd = jax.jit(jf)(*map(jnp.asarray, args))
        assert set(got) == set(jd)
        for k in jd:
            np.testing.assert_allclose(float(got[k].detach()), float(jd[k]), **TOL, err_msg=k)
        got = sum(got.values())
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    assert np.isfinite(float(want))
    got.backward()
    np.testing.assert_allclose(to_np(targs[wrt].grad), np.asarray(want_g), **TOL)


def test_depth_bin_targets_match_reference():
    """one_hot_depth and depth_bins_one_hot_gt equal JAX's."""
    from veon_tpu.lift import lss as jlss

    from veon_tpu_torch.lift import lss as tlss

    pred, gt = _depth_pair(6)
    jg, tg = JGrid(**GRID), GridConfig(**GRID)
    np.testing.assert_array_equal(to_np(tlss.one_hot_depth(to_torch(pred), tg)),
                                  np.asarray(jax.jit(jlss.one_hot_depth, static_argnums=1)(
                                      jnp.asarray(pred), jg)))
    np.testing.assert_array_equal(
        to_np(tlss.depth_bins_one_hot_gt(to_torch(gt), tg, 8)),
        np.asarray(jax.jit(jlss.depth_bins_one_hot_gt, static_argnums=(1, 2))(
            jnp.asarray(gt), jg, 8)))


def _opt_tree(seed):
    rng = _rng(seed)
    params = {"hsa": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
              "alignnet": {"b": rng.standard_normal(5).astype(np.float32)},
              "depth": {"w": rng.standard_normal(3).astype(np.float32)}}
    grads = [{k: {n: (rng.standard_normal(a.shape) * s).astype(np.float32)
                  for n, a in sub.items()} for k, sub in params.items()}
             for s in (0.5, 40.0, 1.0, 3.0)]
    return params, grads


@pytest.mark.parametrize("accum", [1, 2, 3])
def test_optimizer_matches_optax_multisteps(accum):
    """The optimizer with a frozen label over 4 micro-steps against optax
    (MultiSteps for accum > 1; the second micro-step's gradient exceeds
    the clip norm): params after every micro-step at 1e-6, bit-equal to
    the last ones on the micro-steps that apply nothing; the running mean
    and the moments; the frozen leaf never moves; the EMA gate (decay,
    count) against ema_step_fields."""
    params, grads = _opt_tree(9)
    labels = jstep.trainable_mask(params, jstep.stage2_trainable)
    jtx = jstep.make_optimizer(lr=1e-2, warmup_iters=3, labels=labels, accum_steps=accum)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = jtx.init(jp)
    ttx = tstep.AdamW(lr=1e-2, warmup_iters=3, accum_steps=accum)
    tp = {f"{k}.{n}": to_torch(a) for k, sub in params.items() for n, a in sub.items()}
    train = {n: p for n, p in tp.items() if tstep.stage2_trainable(tuple(n.split(".")))}
    assert sorted(train) == ["alignnet.b", "hsa.w"]
    topt = ttx.init(train)

    class S:
        ema_updates = jnp.asarray(7.0)

    tupd = torch.tensor(7.0)
    for i, g in enumerate(grads):
        before = {n: p.clone() for n, p in tp.items()}
        updates, jopt = jax.jit(jtx.update)(jax.tree_util.tree_map(jnp.asarray, g), jopt, jp)
        jp = optax.apply_updates(jp, updates)
        topt = ttx.update({n: to_torch(g[n.split(".")[0]][n.split(".")[1]]) for n in train},
                          topt, train)
        applied = (i + 1) % accum == 0
        assert (topt.mini_step == 0) == applied
        for n, p in tp.items():
            k, leaf = n.split(".")
            np.testing.assert_allclose(to_np(p), np.asarray(jp[k][leaf]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"micro-step {i} {n}")
            if not applied:
                assert torch.equal(p, before[n])
        jd, ju = jstep.ema_step_fields(S, jopt)
        td, tupd = tstep.ema_step_fields(tupd, topt)
        S.ema_updates = ju
        assert float(tupd) == float(ju) == 7.0 + (i + 1) // accum
        np.testing.assert_array_equal(np.float32(td), np.asarray(jd))
        if accum > 1 and not applied:
            acc = jopt.acc_grads
            for n in train:
                k, leaf = n.split(".")
                np.testing.assert_allclose(to_np(topt.acc_grads[n]), np.asarray(acc[k][leaf]),
                                           rtol=1e-6, atol=1e-7)
    assert np.array_equal(to_np(tp["depth.w"]), params["depth"]["w"])
    assert topt.count == 4 // accum


def test_stage_trainable_sets_match_reference_labels():
    """depth_trainable, zoe_trainable and stage2_trainable mark exactly the
    params JAX labels "train", name for name (through from_jax's mapping),
    on the tiny DA-V2 with adapters, the tiny zoe with adapters and the
    tiny stage-2 model."""
    for jmod, tmod, pred_j, pred_t, x in (
            (JDav2(cfg=JDepth(encoder="vits", features=8, out_channels=(4, 8, 8, 8), lora_r=2)),
             DepthAnythingV2(DepthConfig(encoder="vits", features=8, out_channels=(4, 8, 8, 8),
                                         lora_r=2), lora=True),
             jdp.depth_trainable, tdp.depth_trainable, np.zeros((1, 28, 42, 3), np.float32)),
            (JZoeNK(cfg=JZoe(**TINY_ZOE)), ZoeDepthNK(ZoeConfig(**TINY_ZOE), lora=True),
             jdp.zoe_trainable, tdp.zoe_trainable, np.zeros((1, 64, 96, 3), np.float32))):
        params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        _check_trainable(params, tmod, pred_j, pred_t)
    from veon_tpu.cli.shapes import example_batch_full
    from veon_tpu.model.veon import VeonModel as JModel

    jcfg = jpresets.veon_tiny_test()
    jcfg = dataclasses.replace(jcfg, depth=dataclasses.replace(jcfg.depth, use_lora=False))
    imgs, depth_imgs, metas = example_batch_full(jcfg)
    ovw = jnp.zeros((68, jcfg.san.clip_embed_dim))
    params = jax.jit(JModel(cfg=jcfg).init, static_argnames=("train", "method"))(
        jax.random.PRNGKey(0), imgs, depth_imgs, metas, ovw, train=True,
        method=JModel.full_forward)["params"]
    from veon_tpu_torch.configs import presets

    _check_trainable(params, VeonModel(presets.veon_tiny_test(), device="cpu"),
                     jstep.stage2_trainable, tstep.stage2_trainable)


def _check_trainable(params, tmod, pred_j, pred_t):
    labels = jstep.trainable_mask(params, pred_j)
    train = jax.tree_util.tree_map(lambda a, lab: a if lab == "train" else None, params, labels)
    want = set(state_dict_from_jax(tmod, {"params": _drop_none(train)}, strict=False))
    mask = tstep.trainable_mask(tmod, pred_t)
    assert {n for n, t in mask.items() if t} == want
    assert 0 < len(want) < len(mask)


def _drop_none(t):
    """A tree without its None leaves and the subtrees left empty."""
    if isinstance(t, dict):
        out = {k: _drop_none(v) for k, v in t.items()}
        return {k: v for k, v in out.items() if v is not None and not (isinstance(v, dict) and not v)}
    return t


def _stage1(kind, norm):
    """(JAX model, port model, images): the JAX tests' tiny DA-V2 (r=2) on
    (1, 1, 2, 28, 42, 3) frames or tiny zoe on 64x96; raw uint8 frames
    with `norm`."""
    rng = _rng(11)
    if kind == "dav2":
        jm = JDav2(cfg=JDepth(encoder="vits", features=8, out_channels=(4, 8, 8, 8), lora_r=2))
        tm = DepthAnythingV2(DepthConfig(encoder="vits", features=8, out_channels=(4, 8, 8, 8),
                                         lora_r=2), lora=True)
        hw = (28, 42)
    else:
        jm, tm = JZoeNK(cfg=JZoe(**TINY_ZOE)), ZoeDepthNK(ZoeConfig(**TINY_ZOE), lora=True)
        hw = (64, 96)
    if norm:
        return jm, tm, rng.integers(0, 256, (1, 1, 2) + hw + (3,)).astype(np.uint8)
    return jm, tm, rng.standard_normal((1, 1, 2) + hw + (3,)).astype(np.float32)


def _gt_near(tm, imgs, norm, ghw):
    """Sparse GT (1, 2) + ghw near the tower's own first prediction (x
    U(0.7, 1.4), 30% of the pixels missing), so SILog stays below its clip
    at 2 and both loss terms carry gradient."""
    from veon_tpu_torch.data.transforms import normalize_in_graph
    from veon_tpu_torch.ops.resize import resize_bilinear

    x = to_torch(imgs)[:, 0]
    if norm:
        x = normalize_in_graph(x, norm)
    with torch.no_grad():
        p = tm(x.reshape((-1,) + x.shape[2:]))
        p = resize_bilinear(p[..., None], (ghw[0] // 2, ghw[1] // 2), align_corners=True)[..., 0]
    gt = np.repeat(np.repeat(to_np(p)[None], 2, -2), 2, -1)
    rng = _rng(12)
    gt = (gt * rng.uniform(0.7, 1.4, gt.shape)).astype(np.float32)
    gt[rng.random(gt.shape) < 0.3] = 0.0
    return gt


@pytest.mark.parametrize("kind, norm, accum", [("dav2", False, 1), ("dav2", True, 1),
                                               ("dav2", False, 2), ("zoe", False, 1)],
                         ids=["dav2", "dav2_norm_in_graph", "dav2_accum2", "zoe"])
def test_depth_pretrain_step_matches_reference(kind, norm, accum):
    """Two stage-1 steps (lr 2e-4 warmed up from 1e-4 over 2 updates, so the
    params move well past rounding) from the same perturbed weights
    (nonzero lora_B), GT near the tower's own prediction: the loss dicts at
    1e-5 after the first step, 1e-3 after the second (taken where the first
    update left the params, see below); the first gradient (Adam's
    moments, or the accumulated mean) and the moments after both steps
    within 1e-3 of the largest entry of all leaves and within 1e-2 of each
    leaf's own (measured <= 4.4e-3; fp32 through a 12-block trunk, the
    min-pools and the two-hot bins, sums in another order); the moves (see
    `_check_moves`), the EMA's likewise (its frozen entries equal);
    ema_updates equal, and the frozen params bit-equal to the start."""
    jm, tm, imgs = _stage1(kind, norm)
    name = "depthanythingv2" if kind == "dav2" else "midas"
    x0 = np.zeros(imgs.shape[2:], np.float32)
    variables = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x0)), seed=4)
    load_from_jax(tm, variables)
    gt = _gt_near(tm, imgs, name if norm else None, (32, 48) if kind == "dav2" else (64, 96))
    pred_j, pred_t = ((jdp.depth_trainable, tdp.depth_trainable) if kind == "dav2"
                      else (jdp.zoe_trainable, tdp.zoe_trainable))
    jtx = jstep.make_optimizer(lr=2e-4, warmup_iters=2, warmup_ratio=0.5, accum_steps=accum,
                               labels=jstep.trainable_mask(variables["params"], pred_j))
    jstate = jstep.create_train_state(jm, jax.tree_util.tree_map(jnp.asarray, variables), jtx,
                                      init_updates=0)
    jfn = jdp.make_depth_pretrain_step(jm, jtx, JGrid(), JLoss(),
                                       norm_in_graph=name if norm else None)
    ttx = tstep.AdamW(lr=2e-4, warmup_iters=2, warmup_ratio=0.5, accum_steps=accum)
    tstate = tstep.create_train_state(tm, ttx, init_updates=0, predicate=pred_t)
    tfn = tdp.make_depth_pretrain_step(tm, ttx, GridConfig(), LossConfig(),
                                       norm_in_graph=name if norm else None)
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    batch = {"depth_imgs": imgs, "gt_depth": gt}
    trained = {n for n, p in tm.named_parameters() if p.requires_grad}
    for i in range(2):
        jstate, jlo = jfn(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        tstate, tlo = tfn(tstate, {k: to_torch(v) for k, v in batch.items()})
        assert set(tlo) == set(jlo) and float(jlo["loss_depth_zoe"]) < 1.5
        for k in jlo:
            np.testing.assert_allclose(float(tlo[k]), float(jlo[k]), err_msg=k,
                                       **(TOL if i == 0 else dict(rtol=1e-3, atol=1e-5)))
        if i == 0:  # the first gradient, as Adam's moments or the accumulated mean
            fields = (("acc_grads",) if accum > 1 else ("mu", "nu"))
            _check_moments(tm, jstate.opt_state, tstate.opt_state, fields, trained)
            first_grad = _first_grad(tm, jstate.opt_state, trained)
    _check_moments(tm, jstate.opt_state, tstate.opt_state, ("mu", "nu"), trained)
    assert float(tstate.ema_updates) == float(jstate.ema_updates) == 2 // accum
    assert tstate.step == int(jstate.step) == 2
    want = state_dict_from_jax(tm, {"params": np_tree(jstate.params)})
    _check_moves(want, dict(tm.named_parameters()), start, trained, first_grad)
    for n, p in tm.named_parameters():
        if n not in trained:
            assert torch.equal(p.detach(), start[n]), n
    assert any(n.endswith("lora_B") for n in trained)
    ema = state_dict_from_jax(tm, {"params": np_tree(jstate.ema_params)})
    assert set(ema) == set(tstate.ema_params)
    _check_moves(ema, tstate.ema_params, start, trained, first_grad)
    for n in set(ema) - trained:
        assert torch.equal(tstate.ema_params[n], ema[n]), n


def _first_grad(tm, jopt, trained):
    """JAX's first gradient per trainable param: the accumulated mean while
    MultiSteps holds one, else Adam's first moment after one update (the
    gradient scaled by 1 - b1)."""
    tree = np_tree(jopt.acc_grads) if hasattr(jopt, "acc_grads") else _moments(jopt, "mu")
    return {n: to_np(w) for n, w in state_dict_from_jax(tm, {"params": tree}, strict=False).items()
            if n in trained}


def _check_moves(want, got, start, names, grad):
    """The move from `start` of the `names` entries. As one vector: JAX's
    past rounding, the port's at cosine > 0.999 and norm within 1%. Per
    leaf whose JAX move is past rounding (> 5e-5): norm within 2%
    (measured <= 0.77%). Per entry: the sign of JAX's move wherever that
    move is not a cancellation (> 1e-6) and the first gradient `grad` is
    past rounding (> 1e-3 of its leaf's largest). Adam's first steps move
    each entry by about lr * sign(g), so an entry whose gradient is at
    rounding level may go either way, and one whose two steps cancel sits
    at rounding: the entries that flip measure <= 1.6e-4 of their leaf's
    gradient, or moves <= 6e-8."""
    moves = {n: [to_np(src[n]) - to_np(start[n]) for src in (want, got)] for n in sorted(names)}
    w, g = (np.concatenate([m[i].ravel() for m in moves.values()]) for i in (0, 1))
    assert np.abs(w).max() > 5e-5
    assert w @ g / (np.linalg.norm(w) * np.linalg.norm(g)) > 0.999
    np.testing.assert_allclose(np.linalg.norm(g), np.linalg.norm(w), rtol=1e-2)
    for n, (w, g) in moves.items():
        if np.abs(w).max() > 5e-5:
            np.testing.assert_allclose(np.linalg.norm(g), np.linalg.norm(w), rtol=2e-2,
                                       err_msg=n)
        sure = (np.abs(w) > 1e-6) & (np.abs(grad[n]) > 1e-3 * np.abs(grad[n]).max())
        assert np.array_equal(np.sign(w[sure]), np.sign(g[sure])), n


def _check_moments(tm, jopt, topt, fields, trained, rel=1e-3):
    """Each optimizer tree in `fields` of the port within `rel` of the
    largest entry of JAX's over the trainable params, and each leaf within
    10 * `rel` of its own largest entry."""
    for field in fields:
        if field == "acc_grads":
            tree = np_tree(jopt.acc_grads)
        else:
            tree = _moments(jopt, field)
        want = {n: w for n, w in state_dict_from_jax(tm, {"params": tree}, strict=False).items()
                if n in trained}
        got = getattr(topt, field)
        assert set(want) == set(got) == trained
        scale = max(np.abs(to_np(w)).max() for w in want.values())
        assert scale > 0
        for n, w in want.items():
            np.testing.assert_allclose(to_np(got[n]), to_np(w), rtol=0, atol=rel * scale,
                                       err_msg=f"{field} {n}")
            np.testing.assert_allclose(to_np(got[n]), to_np(w), rtol=0,
                                       atol=10 * rel * np.abs(to_np(w)).max(),
                                       err_msg=f"{field} {n} against its own largest")


def _moments(opt_state, field):
    """The Adam `field` (mu / nu) of the trainable partition of an optax
    state (a multi_transform, inside MultiSteps or not), as nested dicts."""
    adam = [t for t in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(t, optax.ScaleByAdamState)]
    assert len(adam) == 1

    def strip(t):
        if isinstance(t, dict):
            out = {k: strip(v) for k, v in t.items()}
            return {k: v for k, v in out.items() if v is not None and not (isinstance(v, dict)
                                                                          and not v)}
        return None if isinstance(t, optax.MaskedNode) else np.asarray(t)

    return strip(dict(getattr(adam[0], field)))
