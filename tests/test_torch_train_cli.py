"""The port's training loop, checkpoints and training CLI against the JAX
package, on the CPU at the tiny preset, fp32, on the synthetic nuScenes
fixture of `test_data_pipeline.py`:

- `train_epochs` against JAX's over one epoch of the fixture from the same
  perturbed variables: the loss lines, the trainable params, the EMA and
  the BatchNorm running stats after it, the step and update counters;
- `_truncate_temporal` and the loader's shuffled order per `set_epoch`
  equal to JAX's;
- a resumed run bit-equal to a straight one (with and without gradient
  accumulation), `NEXT_EPOCH`, `find_latest`, `list_checkpoints` with a
  range;
- `publish` with and without the EMA, refused on a stripped tree, with
  the same -<sha8> suffix as `veon_tpu.ckpt.io.publish_checkpoint` on the
  same weights; the `--ema` guard of `test`;
- `MetricWriter` lines and `param_table` as JAX's;
- the CLI end to end with --device cpu: `pretrain-depth` (a tiny DA-V2 and
  a tiny zoe preset) writes a checkpoint, `train --epochs 1`, then
  `--epochs 2 --auto-resume` runs epoch 2 alone, `publish`, `test --ckpt`
  and `test --all-ckpts --sweep-from/--sweep-to`; the refusals (--cam-shards
  naming its ROADMAP item, a remat policy factory), and JAX's error for
  --dist-num-processes 2 without a coordinator.

The tiny presets are registered on both sides with monkeypatch, for the
test only."""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_data_pipeline import _make_fixture
from test_torch_common import np_tree, perturbed, to_np, to_torch
from test_torch_mirror import with_tiny_zoe

from veon_tpu.ckpt import io as jio
from veon_tpu.configs import presets as jpresets
from veon_tpu.data.loader import DataLoader as JLoader
from veon_tpu.data.nuscenes import NuScenesOccDataset as JDataset, load_infos as jload_infos
from veon_tpu.nn import text as jtext
from veon_tpu.train import loop as jloop
from veon_tpu.train import step as jstep
from veon_tpu.utils import logging as jlogging
from veon_tpu.utils import params as jparams

from veon_tpu_torch.ckpt import io as tio
from veon_tpu_torch.ckpt.from_jax import state_dict_from_jax
from veon_tpu_torch.cli import main as pcli
from veon_tpu_torch.configs import presets
from veon_tpu_torch.data.loader import DataLoader
from veon_tpu_torch.data.nuscenes import NuScenesOccDataset, load_infos
from veon_tpu_torch.entry import build_model, train_batch
from veon_tpu_torch.nn import text as text_mod
from veon_tpu_torch.train import loop as tloop
from veon_tpu_torch.train import step as tstep
from veon_tpu_torch.utils import logging as tlogging
from veon_tpu_torch.utils import params as tparams


def _fixture_cfg(mod, num_temporal=1):
    """veon_tiny_test on the fixture's 90x160 frames (JAX: depth LoRA off,
    the port's serving tower)."""
    cfg = mod.veon_tiny_test(num_temporal=num_temporal)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, src_size=(90, 160)))
    if mod is jpresets:
        cfg = dataclasses.replace(cfg, depth=dataclasses.replace(cfg.depth, use_lora=False))
    return cfg


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    return root, _make_fixture(root)


@pytest.fixture
def tiny_presets(monkeypatch):
    """veon_tiny_fixture (DA-V2) and veon_tiny_fixture_zoe on both sides."""
    for mod in (jpresets, presets):
        monkeypatch.setattr(mod, "veon_tiny_fixture",
                            lambda num_temporal=1, m=mod: _fixture_cfg(m, num_temporal),
                            raising=False)
    monkeypatch.setattr(presets, "veon_tiny_fixture_zoe",
                        lambda num_temporal=1: with_tiny_zoe(_fixture_cfg(presets, num_temporal)),
                        raising=False)


def _losses_of(lines):
    """[(epoch, iter, {loss: value})] parsed from the loops' log lines."""
    out = []
    for ln in lines:
        m = re.match(r"epoch (\d+) iter (\d+)/\d+ \([\d.]+s/iter\) (.*)", ln)
        if m:
            vals = dict(kv.split(": ") for kv in m.group(3).split(", "))
            out.append((int(m.group(1)), int(m.group(2)), {k: float(v) for k, v in vals.items()}))
    return out


def test_train_epochs_matches_reference(shard, tmp_path):
    """One epoch of the fixture (3 shuffled samples, batch 1) through both
    loops from the same perturbed variables, log_interval 1: the loss lines
    at 2e-4 (the stage-2 step's tolerance, `test_torch_train.py`; the lines
    print 4 decimals), then the trainable params and the EMA at 1e-5, the
    running stats at 1e-4, step 3 and 10,563 EMA updates on both sides, and
    each side's checkpoint holding NEXT_EPOCH 1 (the second epoch)."""
    from veon_tpu.cli.shapes import example_batch_full
    from veon_tpu.model.veon import VeonModel as JModel

    root, pkl = shard
    jcfg, tcfg = _fixture_cfg(jpresets), _fixture_cfg(presets)
    _, refl = jtext.build_vocabulary(jcfg.vocabulary)
    ovw = np.random.default_rng(1).standard_normal(
        (len(refl) + 1, jcfg.san.clip_embed_dim)).astype(np.float32)
    model = JModel(cfg=jcfg)
    imgs, depth_imgs, metas = example_batch_full(jcfg)
    variables = perturbed(jax.jit(model.init, static_argnames=("train", "method"))(
        jax.random.PRNGKey(5), imgs, depth_imgs, metas, jnp.asarray(ovw), train=True,
        method=JModel.full_forward), seed=6)
    membership = jtext.merge_matrix(refl)
    jtx = jstep.make_optimizer(labels=jstep.trainable_mask(variables["params"],
                                                           jstep.stage2_trainable))
    jstate = jstep.create_train_state(model, jax.tree_util.tree_map(jnp.asarray, variables), jtx)
    jds = JDataset(infos=jload_infos(pkl), data_cfg=jcfg.data, grid=jcfg.grid, num_temporal=1,
                   is_train=True, data_root=root)
    jlines = []
    jstate = jloop.train_epochs(jstate, jstep.make_train_step(model, jtx, jcfg, membership),
                                JLoader(jds, shuffle=True, num_workers=1), jnp.asarray(ovw),
                                max_epochs=1, work_dir=str(tmp_path / "jax"), log_interval=1,
                                log_fn=jlines.append)

    tmodel = build_model(tcfg, torch.device("cpu"), 0, variables)
    ttx = tstep.AdamW()
    tds = NuScenesOccDataset(infos=load_infos(pkl), data_cfg=tcfg.data, grid=tcfg.grid,
                             num_temporal=1, is_train=True, data_root=root)
    tlines = []
    tstate = tloop.train_epochs(tstep.create_train_state(tmodel, ttx),
                                tstep.make_train_step(tmodel, ttx, tcfg,
                                                      text_mod.merge_matrix(refl)),
                                DataLoader(tds, shuffle=True, num_workers=1), to_torch(ovw),
                                max_epochs=1, work_dir=str(tmp_path / "port"), log_interval=1,
                                log_fn=tlines.append)
    got, want = _losses_of(tlines), _losses_of(jlines)
    assert len(got) == len(want) == 3 and tlines[-1] == jlines[-1] == "saved checkpoint for epoch 1"
    for (e, i, g), (we, wi, w) in zip(got, want):
        assert (e, i) == (we, wi) and set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=2e-4, err_msg=k)
    assert tstate.step == int(jstate.step) == 3
    assert float(tstate.ema_updates) == float(jstate.ema_updates) == 10563.0
    params = state_dict_from_jax(tmodel, {"params": np_tree(jstate.params),
                                          "batch_stats": np_tree(jstate.batch_stats)})
    for n, p in tmodel.named_parameters():
        np.testing.assert_allclose(to_np(p), to_np(params[n]), rtol=1e-5, atol=1e-5, err_msg=n)
    for n, b in tstep.batch_stats(tmodel).items():
        np.testing.assert_allclose(to_np(b), to_np(params[n]), rtol=1e-4, atol=1e-5, err_msg=n)
    ema = state_dict_from_jax(tmodel, {"params": np_tree(jstate.ema_params),
                                       "batch_stats": np_tree(jstate.ema_batch_stats)})
    for n, e in {**tstate.ema_params, **tstate.ema_batch_stats}.items():
        np.testing.assert_allclose(to_np(e), to_np(ema[n]), rtol=1e-5, atol=1e-5, err_msg=n)
    assert tio.checkpoint_next_epoch(str(tmp_path / "port" / "step_3")) == 1 == \
        jio.checkpoint_next_epoch(str(tmp_path / "jax" / "step_3"))


def test_truncate_temporal_matches_reference(shard):
    """A collated F=2 fixture batch cut to the current frame: every array
    equal to JAX's cut, prev_lidarego2global the identity."""
    root, pkl = shard
    cfg = _fixture_cfg(presets, num_temporal=2)
    ds = NuScenesOccDataset(infos=load_infos(pkl), data_cfg=cfg.data, grid=cfg.grid,
                            num_temporal=2, is_train=True, data_root=root)
    batch = next(iter(DataLoader(ds, num_workers=1)))
    got, want = tloop._truncate_temporal(batch), jloop._truncate_temporal(batch)
    assert got["imgs"].shape[1] == 1 and set(got) == set(want)
    for k in ("imgs", "depth_imgs"):
        np.testing.assert_array_equal(got[k], want[k])
    assert set(got["metas"]) == set(want["metas"])
    for k, v in want["metas"].items():
        np.testing.assert_array_equal(got["metas"][k], v, err_msg=k)
    np.testing.assert_array_equal(got["metas"]["prev_lidarego2global"][:, 0], np.eye(4)[None])


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


@pytest.mark.parametrize("batch_size", [1, 3])
def test_shuffled_order_per_epoch_matches_reference(batch_size):
    """The batches of a shuffled loader, epochs 0-2 after set_epoch, equal
    to JAX's; each epoch a new order."""
    orders = []
    for epoch in range(3):
        seen = []
        for cls in (DataLoader, JLoader):
            loader = cls(_Indexed(10), batch_size=batch_size, shuffle=True, num_workers=2)
            loader.set_epoch(epoch)
            seen.append([b["i"].tolist() for b in loader])
        assert seen[0] == seen[1]
        orders.append(seen[0])
    assert orders[0] != orders[1] != orders[2]


def _run(cfg, accum, steps, seed=0):
    """(state, step) of a fresh tiny stage-2 run on the CPU and its losses
    over `steps` steps of the synthetic batch."""
    model = build_model(cfg, torch.device("cpu"), seed, None)
    tx = tstep.AdamW(accum_steps=accum)
    _, refl = text_mod.build_vocabulary(cfg.vocabulary)
    step = tstep.make_train_step(model, tx, cfg, text_mod.merge_matrix(refl))
    return tstep.create_train_state(model, tx), step


@pytest.mark.parametrize("accum, k", [(1, 2), (2, 1)], ids=["plain", "accum2_mid"])
def test_resume_is_bit_equal_to_a_straight_run(tmp_path, accum, k):
    """k steps, save, a model of another seed loaded from the checkpoint,
    one more step: bit-equal to k+1 straight steps in every param and
    running stat, the EMA, Adam's moments and count, the accumulated mean
    and micro-step (accum2_mid saves between two micro-steps), the step and
    EMA counters, and the losses of the last step."""
    cfg = presets.veon_tiny_test()
    batch = train_batch(cfg, device="cpu")
    straight, step = _run(cfg, accum, k + 1)
    for _ in range(k + 1):
        straight, want = step(straight, batch)
    part, step = _run(cfg, accum, k)
    for _ in range(k):
        part, _ = step(part, batch)
    path = tio.save_checkpoint(str(tmp_path), part.step, part, next_epoch=1)
    resumed, step = _run(cfg, accum, 0, seed=7)
    resumed = tio.load_checkpoint(path, target=resumed)
    assert resumed.opt_state.mini_step == part.opt_state.mini_step == (k % accum)
    resumed, got = step(resumed, batch)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert sorted(a) == sorted(b) and all(torch.equal(a[n], b[n]) for n in a)
    for field in ("ema_params", "ema_batch_stats"):
        x, y = getattr(straight, field), getattr(resumed, field)
        assert sorted(x) == sorted(y) and all(torch.equal(x[n], y[n]) for n in x), field
    so, ro = straight.opt_state, resumed.opt_state
    assert (so.count, so.mini_step) == (ro.count, ro.mini_step)
    for field in ("mu", "nu") + (("acc_grads",) if accum > 1 else ()):
        x, y = getattr(so, field), getattr(ro, field)
        assert sorted(x) == sorted(y) and all(torch.equal(x[n], y[n]) for n in x), field
    assert straight.step == resumed.step == k + 1
    assert torch.equal(straight.ema_updates, resumed.ema_updates)


def test_next_epoch_marker_and_find_latest(tmp_path):
    """A checkpoint without the marker reads None; the marker is exact and
    find_latest takes the highest step; a tree round-trips."""
    tree = {"params": {"a": np.arange(6.0, dtype=np.float32).reshape(2, 3)},
            "step": np.int32(7)}
    old = tio.save_checkpoint(str(tmp_path), 10, tree)
    assert tio.checkpoint_next_epoch(old) is None
    new = tio.save_checkpoint(str(tmp_path), 42, tree, next_epoch=3)
    assert tio.checkpoint_next_epoch(new) == 3
    assert tio.find_latest(str(tmp_path)) == new
    back = tio.load_checkpoint(new)
    np.testing.assert_array_equal(back["params"]["a"].numpy(), tree["params"]["a"])
    assert int(back["step"]) == 7
    assert tio.find_latest(str(tmp_path / "none")) is None


def test_list_checkpoints_range(tmp_path):
    for n in (5, 10, 15, 20):
        os.makedirs(tmp_path / f"step_{n}")
    (tmp_path / "step_bogus").mkdir()
    for lo, hi in ((None, None), (10, None), (None, 15), (10, 15)):
        got = tio.list_checkpoints(str(tmp_path), lo, hi)
        assert got == jio.list_checkpoints(str(tmp_path), lo, hi)
    assert [s for s, _ in tio.list_checkpoints(str(tmp_path), 10, 15)] == [10, 15]


def _state_tree():
    """A training-state tree as JAX's test has it, with a nested batch_stats."""
    rng = np.random.default_rng(3)
    return {"params": {"w": rng.standard_normal((2, 3)).astype(np.float32),
                       "blk": {"b": rng.standard_normal(4).astype(np.float32)}},
            "batch_stats": {"bn": {"mean": np.zeros(3, np.float32),
                                   "var": np.ones(3, np.float32)}},
            "ema_params": {"w": np.ones((2, 3), np.float32),
                           "blk": {"b": np.full(4, 0.5, np.float32)}},
            "ema_batch_stats": {"bn": {"mean": np.ones(3, np.float32),
                                       "var": np.ones(3, np.float32)}},
            "opt_state": {"mu": {"w": np.full((2, 3), 7.0, np.float32)}},
            "step": np.int32(5), "ema_updates": np.float32(3.0)}


@pytest.mark.parametrize("ema", [False, True])
def test_publish_matches_reference_suffix(tmp_path, ema):
    """The same weights published by both packages: the same -<sha8>, the
    tree stripped to {params, batch_stats} (the EMA shadow with ema), the
    suffix stable across runs and different between the two flavours; a
    stripped tree refused with ema; the CLI wrapper."""
    state = _state_tree()
    jpath = jio.save_checkpoint(str(tmp_path / "j"), 5, state)
    tpath = tio.save_checkpoint(str(tmp_path / "t"), 5, state)
    want = jio.publish_checkpoint(jpath, str(tmp_path / "jpub"), ema=ema)
    got = tio.publish_checkpoint(tpath, str(tmp_path / "tpub"), ema=ema)
    assert got.rsplit("-", 1)[1] == want.rsplit("-", 1)[1]
    pub = tio.load_checkpoint(got)
    assert set(pub) == {"params", "batch_stats"}
    src = state["ema_params" if ema else "params"]
    np.testing.assert_array_equal(pub["params"]["w"].numpy(), src["w"])
    other = tio.publish_checkpoint(tpath, str(tmp_path / "other"), ema=not ema)
    assert other.rsplit("-", 1)[1] != got.rsplit("-", 1)[1]
    again = tio.publish_checkpoint(tpath, str(tmp_path / "again" / "pub"), ema=ema)
    assert again.rsplit("-", 1)[1] == got.rsplit("-", 1)[1]
    with pytest.raises(ValueError, match="no EMA shadow"):
        tio.publish_checkpoint(got, str(tmp_path / "twice"), ema=True)
    argv = ["publish", "--ckpt", tpath, "--out-prefix", str(tmp_path / "cli")]
    assert pcli.main(argv + (["--ema"] if ema else [])).endswith(got.rsplit("-", 1)[1])


def test_publish_suffix_of_model_weights_matches_reference(tmp_path):
    """The tiny model's whole variables tree (its flax paths, from the
    port's model) published by both packages: the same suffix."""
    from veon_tpu_torch.ckpt.from_jax import variables_from_model

    model = build_model(presets.veon_tiny_test(), torch.device("cpu"), 3, None)
    v = variables_from_model(model)
    tree = {"params": v["params"], "batch_stats": v["batch_stats"]}
    want = jio.publish_checkpoint(jio.save_checkpoint(str(tmp_path / "j"), 1, tree),
                                  str(tmp_path / "jpub"))
    got = tio.publish_checkpoint(tio.save_checkpoint(str(tmp_path / "t"), 1, tree),
                                 str(tmp_path / "tpub"))
    assert got.rsplit("-", 1)[1] == want.rsplit("-", 1)[1]


def test_ckpt_eval_variables_guard():
    full = {"params": {"w": 1}, "batch_stats": {"b": 2},
            "ema_params": {"w": 3}, "ema_batch_stats": {"b": 4}}
    from veon_tpu.cli.main import _ckpt_eval_variables

    for ema in (False, True):
        assert pcli.ckpt_eval_variables(full, ema) == _ckpt_eval_variables(full, ema)
    published = {"params": {"w": 1}, "batch_stats": {"b": 2}}
    assert pcli.ckpt_eval_variables(published, False)["params"] == {"w": 1}
    with pytest.raises(SystemExit, match="published"):
        pcli.ckpt_eval_variables(published, True, path="work/step_5")


def test_metric_writer_lines_match_reference(tmp_path):
    """The same writes through both writers: the same JSONL records but the
    time, the second writer appending to the first's file, and the same summary."""
    recs = {}
    for name, mod in (("port", tlogging), ("jax", jlogging)):
        d = str(tmp_path / name)
        with mod.MetricWriter(d) as w:
            w.write({"loss": 1.5, "lr": 1e-4}, step=10, epoch=0)
            w.write({"loss": 1.25, "sec_per_iter": 0.5}, step=20, epoch=0)
        with mod.MetricWriter(d) as w:
            w.write({"loss": 1.0, "sec_per_iter": 0.25}, step=30)
        with open(w.path) as f:
            recs[name] = [json.loads(ln) for ln in f]
        for r in recs[name]:
            assert r.pop("time") > 0
    assert recs["port"] == recs["jax"] and len(recs["port"]) == 3
    assert tlogging.summarize_log(str(tmp_path / "port" / "train.log.jsonl")) == \
        jlogging.summarize_log(str(tmp_path / "jax" / "train.log.jsonl"))


def test_param_table_matches_reference():
    """param_table of the port's model (and of its variables tree) equals
    JAX's of the same config's params, with the stage-2 trainable column;
    count_parameters likewise."""
    from veon_tpu.cli.shapes import example_batch_full
    from veon_tpu.model.veon import VeonModel as JModel

    from veon_tpu_torch.ckpt.from_jax import variables_from_model

    jcfg = jpresets.veon_tiny_test()
    jcfg = dataclasses.replace(jcfg, depth=dataclasses.replace(jcfg.depth, use_lora=False))
    imgs, depth_imgs, metas = example_batch_full(jcfg)
    params = jax.jit(JModel(cfg=jcfg).init, static_argnames=("train", "method"))(
        jax.random.PRNGKey(0), imgs, depth_imgs, metas, jnp.zeros((68, 16)), train=True,
        method=JModel.full_forward)["params"]
    model = build_model(presets.veon_tiny_test(), torch.device("cpu"), 0, None)
    want = jparams.param_table(params, jstep.stage2_trainable)
    assert tparams.param_table(model, tstep.stage2_trainable) == want
    assert tparams.param_table(variables_from_model(model)["params"],
                               tstep.stage2_trainable) == want
    assert tparams.count_parameters(model) == jparams.count_parameters(params)
    assert "alignnet" in want and "TOTAL" in want


def _base(root, pkl, preset="veon_tiny_fixture"):
    return ["--preset", preset, "--data-root", root, "--ann", pkl, "--workers", "1",
            "--device", "cpu"]


@pytest.mark.parametrize("preset", ["veon_tiny_fixture", "veon_tiny_fixture_zoe"],
                         ids=["dav2", "zoe"])
def test_pretrain_depth_cli_writes_a_checkpoint(shard, tiny_presets, tmp_path, preset):
    """Stage 1 through the CLI: one epoch (3 steps) of the fixture writes
    step_3 holding the tower's params with its adapters (zoe: under
    core.pretrained), its EMA and the optimizer over the trainable set
    only; the losses finite."""
    root, pkl = shard
    work = str(tmp_path / "w")
    res = pcli.main(["pretrain-depth", *_base(root, pkl, preset), "--epochs", "1",
                     "--work-dir", work])
    assert res["checkpoint"] == tio.find_latest(work) == os.path.join(work, "step_3")
    assert all(np.isfinite(float(v)) for v in res["losses"].values())
    tree = tio.load_checkpoint(res["checkpoint"])
    flat = " ".join(str(k) for k in _paths(tree["params"]))
    assert "lora_A" in flat and "lora_B" in flat
    mu = {".".join(p) for p in _paths(tree["opt_state"]["mu"])}
    assert mu and all(("lora_" in p) or ("depth_head" in p if preset.endswith("fixture")
                                         else "pretrained" not in p) for p in mu)
    assert int(tree["step"]) == 3 and float(tree["ema_updates"]) == 3.0


def _paths(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, path + (k,))
        else:
            yield path + (k,)


def test_train_resume_publish_and_test_cli(shard, tiny_presets, tmp_path, capsys):
    """Stage 2 through the CLI: `train --epochs 1` writes step_3 (NEXT_EPOCH
    1) and its log; `--epochs 2 --auto-resume` starts at epoch 2 from it and
    writes step_6 alone; `publish --ema`; `test --ckpt` on the published
    weights (and `--ema` on them refused); `test --all-ckpts` over
    --sweep-from 4 takes step_6 only, and over both gives the same mIoU for
    step_6 as `test --ckpt step_6`."""
    root, pkl = shard
    work = str(tmp_path / "w")
    base = _base(root, pkl)
    assert pcli.main(["train", *base, "--epochs", "1", "--work-dir", work]) == \
        {"start_epoch": 0, "step": 3}
    assert tio.checkpoint_next_epoch(os.path.join(work, "step_3")) == 1
    out = capsys.readouterr().out
    assert "saved checkpoint for epoch 1" in out and "TOTAL" in out
    res = pcli.main(["train", *base, "--epochs", "2", "--auto-resume", "--work-dir", work])
    assert res == {"start_epoch": 1, "step": 6}
    out = capsys.readouterr().out
    assert "auto-resumed from" in out and "(epoch 1)" in out
    after = out.split("auto-resumed")[1]
    assert "saved checkpoint for epoch 2" in after and "for epoch 1" not in after
    assert [s for s, _ in tio.list_checkpoints(work)] == [3, 6]
    pub = pcli.main(["publish", "--ckpt", os.path.join(work, "step_6"), "--out-prefix",
                     str(tmp_path / "pub"), "--ema"])
    r = pcli.main(["test", *base, "--ckpt", pub])
    assert np.isfinite(r["mIoU"])
    with pytest.raises(SystemExit, match="published"):
        pcli.main(["test", *base, "--ckpt", pub, "--ema"])
    one = pcli.main(["test", *base, "--ckpt", os.path.join(work, "step_6")])
    sweep = pcli.main(["test", *base, "--all-ckpts", "--work-dir", work, "--sweep-from", "4"])
    assert list(sweep["sweep"]) == [6] and sweep["sweep"][6] == one
    both = pcli.main(["test", *base, "--all-ckpts", "--work-dir", work, "--sweep-to", "6"])
    assert list(both["sweep"]) == [3, 6] and both["sweep"][6] == one


def test_train_cli_accumulates_and_truncates_frames(shard, tiny_presets, tmp_path):
    """--accum-steps 2: one update per two steps (the EMA counts one);
    --num-temporal 2 with --temporal-start-epoch past the run's epochs runs
    on the current frame."""
    root, pkl = shard
    work = str(tmp_path / "a")
    assert pcli.main(["train", *_base(root, pkl), "--epochs", "1", "--accum-steps", "2",
                      "--work-dir", work])["step"] == 3
    tree = tio.load_checkpoint(os.path.join(work, "step_3"))
    o = tree["opt_state"]
    assert int(o["count"]) == 1 and int(o["mini_step"]) == 1 and "acc_grads" in o
    assert float(tree["ema_updates"]) == 10561.0
    res = pcli.main(["train", *_base(root, pkl), "--num-temporal", "2", "--epochs", "1",
                     "--temporal-start-epoch", "1", "--work-dir", str(tmp_path / "t")])
    assert res["step"] == 3


@pytest.mark.parametrize("argv, exc, match", [
    pytest.param(["train", "--cam-shards", "2"], NotImplementedError, "item 16",
                 id="argv0-item 16"),
    # remat policies are ported (item 11a, `test_torch_remat.py`); JAX's
    # policy factories stay refused before anything is built
    pytest.param(["train", "--remat", "save_only_these_names"], ValueError, "factory",
                 id="argv3-item 11a"),
    # multi-process and temporal training run (test_torch_distributed.py,
    # test_torch_temporal_train.py); a world size without a coordinator
    # raises JAX's error before anything is built
    pytest.param(["train", "--dist-num-processes", "2"], ValueError, "no coordinator address",
                 id="dist_without_coordinator"),
])
def test_train_refusals_name_their_roadmap_item(monkeypatch, argv, exc, match):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "NNODES"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(exc, match=match):
        pcli.main(argv + ["--device", "cpu"])
