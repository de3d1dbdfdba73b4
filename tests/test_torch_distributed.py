"""The port's data-parallel training (`veon_tpu_torch/train/distributed.py`)
on the CPU over gloo, against the JAX package:

- `initialize` from its arguments, from JAX's dist_train.sh variables and
  from torchrun's, its card choice, and JAX's error for a world size above
  1 without a coordinator (the counterpart of `tests/test_distributed.py`);
- one stage-2 step at `veon_tiny_test` size with the banded lift, two
  gloo processes each taking one row of a B=2 batch, against JAX's
  `make_train_step` over a 2-device ("batch",) mesh with
  bn_axis_name="batch" on the whole batch, at F=1 and F=2: the averaged
  losses, every gradient, the synced running stats, the params and the
  EMA, and the two ranks bit-equal to each other;
- world size 1: the step under a one-rank process group bit-equal to the
  plain step;
- `train --dist-num-processes 2` through the CLI on the synthetic
  nuScenes fixture: rank 0 alone prints the param table and writes the
  checkpoints and the log, both ranks resume from the same checkpoint
  with --auto-resume and end with equal params.

The ranks are processes of this file (`python test_torch_distributed.py
MODE RANK ...`), started with a free port and killed on a timeout.
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# veon_tiny_test with the production 0.5 m depth bins: the banded lift's
# far spray (kernel #3's second stream) runs (`test_torch_train.py` `_cfgs`)
GRID = dict(x=(-40.0, 40.0, 4.0), y=(-40.0, 40.0, 4.0), z=(-1.0, 5.4, 1.6),
            depth=(1.0, 45.0, 0.5))
TIMEOUT_S = 300


def port_cfg(F):
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.configs.base import GridConfig

    return dataclasses.replace(presets.veon_tiny_test(num_temporal=F), grid=GridConfig(**GRID),
                               lss_banded=True)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(mode, world, *args):
    """Run `world` ranks of this file in `mode`; their outputs, each rank
    exiting 0, all killed if one outlives the timeout."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r),
                               *map(str, args)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{mode} ranks timed out")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{mode} rank {r} failed:\n{out[-4000:]}"
    return outs


# ---------------------------------------------------------------------------
# initialize


@pytest.fixture
def group_calls(monkeypatch):
    """init_process_group and torch.cuda.set_device recorded instead of run."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(dict(backend=backend, **kw)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append({"set_device": i}))
    for k in ("MASTER_ADDR", "MASTER_PORT", "NNODES", "NODE_RANK", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    return calls


def _group(backend, addr, world, rank):
    return dict(backend=backend, init_method=f"tcp://{addr}", world_size=world, rank=rank)


@pytest.mark.parametrize("args, env, want", [
    (("h0:1234", 2, 1), {}, _group("gloo", "h0:1234", 2, 1)),
    ((None, None, None), dict(MASTER_ADDR="h1", MASTER_PORT="29600", NNODES="3", NODE_RANK="2"),
     _group("gloo", "h1:29600", 3, 2)),
    ((None, None, None), dict(MASTER_ADDR="h2", NNODES="2", NODE_RANK="1"),
     _group("gloo", "h2:29500", 2, 1)),
    # torchrun's WORLD_SIZE / RANK win over NNODES / NODE_RANK
    ((None, None, None), dict(MASTER_ADDR="h3", MASTER_PORT="7", WORLD_SIZE="4", RANK="3",
                              LOCAL_RANK="1", NNODES="2", NODE_RANK="0"),
     _group("gloo", "h3:7", 4, 3)),
    # the arguments win over the variables
    (("h4:9", 2, 0), dict(MASTER_ADDR="h5", WORLD_SIZE="4", RANK="3"),
     _group("gloo", "h4:9", 2, 0)),
], ids=["arguments", "dist_train_vars", "default_port", "torchrun_vars", "args_over_vars"])
def test_initialize_reads_arguments_then_variables(group_calls, monkeypatch, args, env, want):
    from veon_tpu_torch.train.distributed import initialize

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert initialize(*args, device="cpu") is True
    assert group_calls == [want]


@pytest.mark.parametrize("env, card", [({"LOCAL_RANK": "1", "RANK": "3"}, 1), ({}, 3)],
                         ids=["local_rank", "process_id_modulo_cards"])
def test_initialize_picks_the_rank_card_before_the_group(group_calls, monkeypatch, env, card):
    """On the card: torchrun's LOCAL_RANK, else the process id modulo the
    visible cards, is made current first; the backend is NCCL unless
    given."""
    from veon_tpu_torch.train.distributed import initialize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert initialize("h:1", 8, 7) is True
    assert group_calls == [{"set_device": card}, _group("nccl", "h:1", 8, 7)]
    group_calls.clear()
    assert initialize("h:1", 8, 7, backend="gloo") is True
    assert group_calls[1]["backend"] == "gloo"


def test_initialize_takes_nnodes_as_processes_only_on_one_card_hosts(group_calls, monkeypatch):
    """JAX's NNODES counts hosts, each process driving all of its host's
    cards. The port runs one process per card, so NNODES=2 on a host that
    sees 8 cards raises and names torchrun instead of training on 2 of 16
    cards; torchrun's WORLD_SIZE is taken as it is there, and on a host
    with one card NNODES is the world size."""
    from veon_tpu_torch.train.distributed import initialize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for k, v in dict(MASTER_ADDR="h", NNODES="2", NODE_RANK="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 8 --nnodes 2"):
        initialize()
    assert group_calls == []
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("RANK", "9")
    assert initialize() is True
    assert group_calls == [{"set_device": 1}, _group("nccl", "h:29500", 16, 9)]
    group_calls.clear()
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert initialize() is True
    assert group_calls == [{"set_device": 0}, _group("nccl", "h:29500", 2, 1)]


def test_initialize_single_process_does_nothing(group_calls, monkeypatch):
    from veon_tpu.train.distributed import initialize as jinit

    from veon_tpu_torch.train.distributed import initialize, process_shard

    assert initialize(device="cpu") is False and jinit() is False
    assert initialize(None, 1, 0, device="cpu") is False
    assert initialize("h:1", 1, 0, device="cpu") is False
    monkeypatch.setenv("MASTER_ADDR", "h")
    assert initialize(device="cpu") is False and jinit() is False
    assert group_calls == [] and process_shard() == (0, 1)


@pytest.mark.parametrize("args, env", [((None, 2, 0), {}), ((None, None, None), {"NNODES": "2"}),
                                       ((None, None, None), {"WORLD_SIZE": "2"})],
                         ids=["argument", "nnodes", "world_size"])
def test_initialize_without_coordinator_raises_jax_error(group_calls, monkeypatch, args, env):
    from veon_tpu.train.distributed import initialize as jinit

    from veon_tpu_torch.train.distributed import initialize

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as want:
        jinit(None, 2, 0)
    with pytest.raises(ValueError) as got:
        initialize(*args, device="cpu")
    assert str(got.value) == str(want.value) and "no coordinator address" in str(got.value)
    assert group_calls == []


# ---------------------------------------------------------------------------
# the data-parallel step against JAX's mesh step


def _jax_mesh_step(F):
    """(inputs for the ranks, JAX's state and losses after one step over a
    2-device batch mesh on a B=2 batch)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from test_torch_common import perturbed, to_np
    from test_torch_train import _cfgs

    from veon_tpu.cli.shapes import example_batch as j_example_batch
    from veon_tpu.model.veon import VeonModel as JModel
    from veon_tpu.nn import text as jtext
    from veon_tpu.train import step as jstep

    from veon_tpu_torch.cli.shapes import example_batch, example_depth_imgs

    jcfg, tcfg = (dataclasses.replace(c, num_temporal=F) for c in _cfgs(True))
    assert tcfg == port_cfg(F)
    imgs, _depth, metas = j_example_batch(jcfg, B=2)
    t_imgs, _d, t_metas = example_batch(tcfg, B=2, device="cpu")
    np.testing.assert_array_equal(to_np(t_imgs), np.asarray(imgs))
    rng = np.random.default_rng(23)
    N, (h, w) = tcfg.data.num_cams, tcfg.feat_hw
    depth = np.repeat(np.repeat(rng.uniform(1.5, 59.5, (2, F, N, h, w)).astype(np.float32),
                                8, axis=3), 8, axis=4)
    nx, ny, nz = tcfg.grid.size
    _, refl = jtext.build_vocabulary(jcfg.vocabulary)
    ovw = rng.standard_normal((len(refl) + 1, jcfg.san.clip_embed_dim)).astype(np.float32)
    batch = {"imgs": np.asarray(imgs), "depth": depth,
             "metas": {k: np.asarray(v) for k, v in metas.items()},
             "voxel_semantics": rng.integers(0, 18, (2, nx, ny, nz)).astype(np.int32),
             "mask_camera": (rng.random((2, nx, ny, nz)) < 0.9).astype(np.int32)}
    depth_imgs = jnp.asarray(to_np(example_depth_imgs(tcfg, device="cpu")))
    plain = JModel(cfg=jcfg)
    variables = perturbed(jax.jit(plain.init, static_argnames=("train", "method"))(
        jax.random.PRNGKey(2), imgs[:1], depth_imgs, {k: v[:1] for k, v in metas.items()},
        jnp.asarray(ovw), train=True, method=JModel.full_forward), seed=3)
    model = JModel(cfg=jcfg, bn_axis_name="batch")
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("batch",))
    jtx = jstep.make_optimizer(labels=jstep.trainable_mask(variables["params"],
                                                           jstep.stage2_trainable))
    jstate = jax.device_put(
        jstep.create_train_state(model, jax.tree_util.tree_map(jnp.asarray, variables), jtx),
        NamedSharding(mesh, PartitionSpec()))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jbatch.update(ov_weight=jnp.asarray(ovw), epoch=jnp.asarray(0, jnp.int32))
    jstate, jlosses = jstep.make_train_step(model, jtx, jcfg, jtext.merge_matrix(refl),
                                            mesh=mesh)(jstate, jbatch)
    inputs = dict(F=F, variables=variables, batch=batch, ovw=ovw)
    return inputs, jstate, {k: float(v) for k, v in jlosses.items()}


def _step_inputs(F, rank, world):
    """(cfg, variables, this rank's rows of the batch as tensors)."""
    with open(os.environ["VEON_DIST_INPUTS"], "rb") as f:
        inputs = pickle.load(f)
    rows = slice(rank, rank + 1) if world == 2 else slice(0, 1)

    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) else torch.from_numpy(
            np.ascontiguousarray(t[rows] if t.ndim and t.shape[0] == 2 else t))

    batch = cut(inputs["batch"])
    batch.update(ov_weight=torch.from_numpy(inputs["ovw"]), epoch=0)
    return port_cfg(F), inputs["variables"], batch


def _snapshot(trainer, losses):
    s = trainer.state
    return dict(losses={k: float(v) for k, v in losses.items()},
                mu={n: t.numpy().copy() for n, t in s.opt_state.mu.items()},
                params={n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()},
                buffers={n: b.numpy().copy() for n, b in trainer.model.named_buffers()},
                ema={n: t.numpy().copy() for n, t in {**s.ema_params, **s.ema_batch_stats}.items()},
                ema_updates=float(s.ema_updates))


def _step_rank(rank, port, F, out):
    """One data-parallel step (two ranks, one row each) or, with port 0,
    the plain step and the step under a one-rank group."""
    from veon_tpu_torch.entry import train_entry
    from veon_tpu_torch.train import distributed as D

    F = int(F)
    world = 1 if int(port) == 0 else 2
    cfg, variables, batch = _step_inputs(F, rank, world)
    res = {}
    if world == 1:
        trainer, _ = train_entry(cfg, device="cpu", variables=variables)
        res["plain"] = _snapshot(trainer, trainer(batch))
        D.init_group(f"localhost:{_free_port()}", 1, 0, device="cpu")
    else:
        assert D.initialize(f"localhost:{port}", 2, rank, device="cpu")
    trainer, _ = train_entry(cfg, device="cpu", variables=variables)
    D.broadcast_state(trainer.model)
    assert D.data_parallel() and D.process_shard() == (rank, world)
    res["synced"] = _snapshot(trainer, trainer(batch))
    D.shutdown()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module", params=[1, 2], ids=["F1", "F2"])
def dp_stepped(request, tmp_path_factory):
    """JAX's 2-device mesh step and the two gloo ranks' step at F frames,
    from the same perturbed weights and B=2 batch."""
    inputs, jstate, jlosses = _jax_mesh_step(request.param)
    d = tmp_path_factory.mktemp(f"dp{request.param}")
    path = str(d / "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    os.environ["VEON_DIST_INPUTS"] = path
    try:
        _spawn("step", 2, _free_port(), request.param, d / "out")
    finally:
        del os.environ["VEON_DIST_INPUTS"]
    ranks = []
    for r in range(2):
        with open(d / f"out.{r}", "rb") as f:
            ranks.append(pickle.load(f)["synced"])
    return dict(ranks=ranks, jstate=jstate, jlosses=jlosses, F=request.param)


def _tiny_model(F):
    from veon_tpu_torch.entry import build_model

    return build_model(port_cfg(F), torch.device("cpu"), 0, None)


def test_data_parallel_ranks_are_bit_equal(dp_stepped):
    a, b = dp_stepped["ranks"]
    assert a["losses"] == b["losses"]
    for field in ("mu", "params", "buffers", "ema"):
        assert sorted(a[field]) == sorted(b[field])
        for n in a[field]:
            assert np.array_equal(a[field][n], b[field][n]), (field, n)


def test_data_parallel_losses_match_mesh_step(dp_stepped):
    """The losses averaged over the ranks at 2e-4, as JAX's pmean'd ones."""
    got, want = dp_stepped["ranks"][0]["losses"], dp_stepped["jlosses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4, err_msg=k)


def test_data_parallel_gradients_match_mesh_step(dp_stepped):
    """The averaged gradient (Adam's first moment after one step) of every
    trainable leaf within 1e-4 of its own largest entry (the biases that
    are 0 up to rounding within 1e-4 of the step's largest entry): one
    world-size factor too many or too few would show here."""
    from test_torch_common import close_per_leaf, to_np, zero_grad_biases
    from test_torch_train import _adam_moments

    from veon_tpu_torch.ckpt.from_jax import state_dict_from_jax

    model = _tiny_model(dp_stepped["F"])
    want = {n: to_np(t) for n, t in state_dict_from_jax(
        model, {"params": _adam_moments(dp_stepped["jstate"].opt_state)}, strict=False).items()}
    got = dp_stepped["ranks"][0]["mu"]
    assert sorted(got) == sorted(want) and len(got) > 10
    close_per_leaf(got, want, "gradient", zero_grad_biases(model))


def test_data_parallel_synced_stats_params_and_ema_match_mesh_step(dp_stepped):
    """The running stats moved by the synced batch stats at rtol 1e-4 /
    atol 1e-5; the params after the step and the EMA at 1e-5."""
    from test_torch_common import np_tree, to_np

    from veon_tpu_torch.ckpt.from_jax import state_dict_from_jax

    model, js, got = _tiny_model(dp_stepped["F"]), dp_stepped["jstate"], dp_stepped["ranks"][0]
    stats = state_dict_from_jax(model, {"batch_stats": np_tree(js.batch_stats)}, strict=False)
    assert sorted(stats) == sorted(got["buffers"])
    for n, w in stats.items():
        np.testing.assert_allclose(got["buffers"][n], to_np(w), rtol=1e-4, atol=1e-5, err_msg=n)
    params = state_dict_from_jax(model, {"params": np_tree(js.params)}, strict=False)
    for n, w in params.items():
        np.testing.assert_allclose(got["params"][n], to_np(w), rtol=1e-5, atol=1e-5, err_msg=n)
    ema = state_dict_from_jax(model, {"params": np_tree(js.ema_params),
                                      "batch_stats": np_tree(js.ema_batch_stats)})
    assert sorted(ema) == sorted(got["ema"]) and got["ema_updates"] == 10561.0
    for n, w in ema.items():
        np.testing.assert_allclose(got["ema"][n], to_np(w), rtol=1e-5, atol=1e-5, err_msg=n)


def test_world_size_one_is_bit_equal_to_the_plain_step(tmp_path):
    """The step under a one-rank gloo group (synced BatchNorm, averaged
    gradients and losses) against the plain step, same weights and batch:
    every loss, gradient, param, running stat and EMA entry bit-equal."""
    from test_torch_common import perturbed

    from veon_tpu_torch.ckpt.from_jax import variables_from_model
    from veon_tpu_torch.entry import train_batch

    rng = np.random.default_rng(5)
    cfg = port_cfg(1)
    b = train_batch(cfg, device="cpu")
    batch = {"imgs": b["imgs"].numpy(), "metas": {k: v.numpy() for k, v in b["metas"].items()},
             "voxel_semantics": b["voxel_semantics"].numpy(),
             "mask_camera": b["mask_camera"].numpy(),
             "depth": rng.uniform(1.5, 59.5, (1, 1, cfg.data.num_cams) + cfg.data.input_size)
             .astype(np.float32)[..., ::2, ::2].copy()}
    variables = perturbed(variables_from_model(_tiny_model(1)), seed=8)
    path = str(tmp_path / "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(F=1, variables=variables, batch=batch,
                         ovw=b["ov_weight"].numpy()), f)
    os.environ["VEON_DIST_INPUTS"] = path
    try:
        _spawn("step", 1, 0, 1, tmp_path / "out")
    finally:
        del os.environ["VEON_DIST_INPUTS"]
    with open(tmp_path / "out.0", "rb") as f:
        res = pickle.load(f)
    plain, synced = res["plain"], res["synced"]
    assert plain["losses"] == synced["losses"] and plain["ema_updates"] == synced["ema_updates"]
    for field in ("mu", "params", "buffers", "ema"):
        assert sorted(plain[field]) == sorted(synced[field])
        for n in plain[field]:
            assert np.array_equal(plain[field][n], synced[field][n]), (field, n)
    moved = [n for n in plain["buffers"] if not np.array_equal(
        plain["buffers"][n], np.asarray(_flat_stats(variables)[n]))]
    assert moved  # the train-mode BatchNorms ran


def _flat_stats(variables):
    from veon_tpu_torch.ckpt.from_jax import state_dict_from_jax

    return {n: t.numpy() for n, t in state_dict_from_jax(
        _tiny_model(1), {"batch_stats": variables["batch_stats"]}, strict=False).items()}


# ---------------------------------------------------------------------------
# the CLI


def _fixture_preset(num_temporal=1):
    from veon_tpu_torch.configs import presets

    cfg = presets.veon_tiny_test(num_temporal=num_temporal)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, src_size=(90, 160)))


def _cli_rank(rank, ports, root, pkl, work, out):
    """`train --epochs 1`, then `--epochs 2 --auto-resume`, as rank `rank`
    of two, recording each step's losses, each checkpoint save and each
    metric log this process opened, and the final params."""
    from veon_tpu_torch.cli import main as pcli
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.train import loop

    presets.veon_tiny_fixture = _fixture_preset
    rec = dict(losses=[], saves=[], logs=0, results=[])
    orig_step, orig_save, orig_writer = pcli.make_train_step, loop.save_checkpoint, pcli.MetricWriter
    models = []

    def make_train_step(model, *a, **kw):
        models.append(model)
        step = orig_step(model, *a, **kw)

        def recorded(state, batch):
            state, losses = step(state, batch)
            rec["losses"].append({k: float(v) for k, v in losses.items()})
            return state, losses
        return recorded

    def save_checkpoint(directory, step, *a, **kw):
        rec["saves"].append(step)
        return orig_save(directory, step, *a, **kw)

    def metric_writer(*a, **kw):
        rec["logs"] += 1
        return orig_writer(*a, **kw)

    pcli.make_train_step, loop.save_checkpoint, pcli.MetricWriter = (
        make_train_step, save_checkpoint, metric_writer)
    base = ["train", "--preset", "veon_tiny_fixture", "--data-root", root, "--ann", pkl,
            "--workers", "1", "--device", "cpu", "--work-dir", work,
            "--dist-num-processes", "2", "--dist-process-id", str(rank)]
    for port, extra in zip(ports.split(","), (["--epochs", "1"],
                                              ["--epochs", "2", "--auto-resume"])):
        rec["results"].append(pcli.main(base + ["--dist-coordinator", f"localhost:{port}",
                                                *extra]))
    rec["params"] = {n: t.numpy().copy() for n, t in models[-1].state_dict().items()}
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(rec, f)


def test_two_process_train_cli_rank0_writes_and_both_resume(tmp_path):
    """Three fixture samples over two ranks: the loader pads to two each,
    so 2 steps per epoch on both ranks with the same averaged losses.
    Rank 0 alone prints the param table, opens train.log.jsonl and saves
    step_2 and step_4; both ranks resume from step_2 with --auto-resume
    (epoch 1) and end bit-equal to each other and to step_4's params."""
    from test_data_pipeline import _make_fixture

    from veon_tpu_torch.ckpt import io as tio
    from veon_tpu_torch.ckpt.from_jax import state_dict_from_jax

    root = str(tmp_path / "nusc")
    os.makedirs(root)
    pkl = _make_fixture(root)
    work = str(tmp_path / "work")
    outs = _spawn("cli", 2, f"{_free_port()},{_free_port()}", root, pkl, work, tmp_path / "rec")
    recs = []
    for r in range(2):
        with open(tmp_path / f"rec.{r}", "rb") as f:
            recs.append(pickle.load(f))
    for r, (rec, out) in enumerate(zip(recs, outs)):
        assert rec["results"] == [{"start_epoch": 0, "step": 2}, {"start_epoch": 1, "step": 4}]
        assert "auto-resumed from" in out and "(epoch 1)" in out, out[-2000:]
        assert ("TOTAL" in out) == (r == 0)
        assert rec["saves"] == ([2, 4] if r == 0 else []) and rec["logs"] == (2 if r == 0 else 0)
    assert len(recs[0]["losses"]) == 4 and recs[0]["losses"] == recs[1]["losses"]
    assert sorted(recs[0]["params"]) == sorted(recs[1]["params"])
    for n, a in recs[0]["params"].items():
        assert np.array_equal(a, recs[1]["params"][n]), n
    # (and rank 0's TensorBoard events where the package imports)
    assert set(os.listdir(work)) - {"tb"} == {"step_2", "step_4", "train.log.jsonl"}
    assert tio.checkpoint_next_epoch(os.path.join(work, "step_4")) == 2
    tree = tio.load_checkpoint(os.path.join(work, "step_4"))
    saved = state_dict_from_jax(_tiny_model(1), {"params": tree["params"],
                                                 "batch_stats": tree["batch_stats"]})
    for n, t in saved.items():
        assert np.array_equal(t.numpy(), recs[0]["params"][n]), n


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    mode, rank = sys.argv[1], int(sys.argv[2])
    {"step": _step_rank, "cli": _cli_rank}[mode](rank, *sys.argv[3:])
