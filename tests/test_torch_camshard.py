"""The port's camera sharding (`veon_tpu_torch/model/camshard.py` and
`serve/camshard.py`, the lift's cam group, `collectives.cam_sum` /
`cam_gather`) on the CPU over gloo, against the JAX package's (`tests/test_camshard.py`, on its virtual 8-device
CPU mesh) at rtol = atol = 2e-4 in fp32, with the kernels' plain versions:

- in one process: the unfused presorted layout ("rk_sorted") of
  `precompute_sorted` and `lift_presorted`, at ds_feat (2,2,2) and
  (1,1,1), integer-equal to JAX's `precompute_sorted(fuse_ds_pool=False)`;
  `bev_pool_presorted`'s backward against JAX's VJP;
  `resolve_sensor2keyegos`; `prepare_camshard_metas(presort=True)`'s
  stacked streams integer-equal to JAX's at S = 2, 3; the pooled layout
  refused under a cam group, and a rig whose cameras share coarse cells,
  whose grid differs if the max-pool is taken before the cross-camera sum;
- in four gloo processes of this file (`python test_torch_camshard.py
  worker RANK ...`, killed on a timeout), each rank holding the whole
  input: `train --cam-shards 2` through the CLI on a 2 x 2 (batch x cam)
  world; one SGD step on a 2 x 2 grid, its parameter deltas against JAX's
  `make_train_step(mesh=(2, 2), cam_axis="cam")` and the port's unsharded
  step; then, on groups of the first 2 and 3 ranks, the banded sharded
  forward (S = 2, 3) against JAX's `make_camera_sharded_forward` and the
  port's unsharded forward, the presorted one (S = 2), a 3-shard streaming
  session over 2 calls against JAX's batched F=2 forward, and
  `build_serve_handler` with 3 shards against 1 (class grid >= 0.999,
  retrieval to 2e-4), and its refusal of a frame of another shape and
  recovery from a request that fails on every rank.
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
TOL = dict(rtol=2e-4, atol=2e-4)
TIMEOUT_S = 300
WORLD = 4
LR = 0.1


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# one process


def _rig_lifts(ds_feat):
    import jax.numpy as jnp
    from test_torch_common import to_torch
    from test_torch_lift import RIGS

    from veon_tpu.configs.base import GridConfig as JGrid
    from veon_tpu.lift import lss as jlss

    from veon_tpu_torch.configs.base import GridConfig as TGrid
    from veon_tpu_torch.lift import lss as tlss

    grid_kw, input_size, ds, args = RIGS["tiny"]
    jlift = jlss.LSSLift(grid=JGrid(**grid_kw), input_size=input_size, downsample=ds,
                         out_channels=3, ds_feat=ds_feat)
    tlift = tlss.LSSLift(grid=TGrid(**grid_kw), input_size=input_size, downsample=ds,
                         ds_feat=ds_feat)
    return jlift, tlift, [jnp.asarray(a) for a in args], [to_torch(a) for a in args]


def _feat_dist(jlift, shape, seed):
    """Random features (B, N, h, w, 3) and two-hot depth weights."""
    import jax.numpy as jnp

    from veon_tpu.lift import lss as jlss

    B, N, D, hf, wf = shape
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, N, hf, wf, 3)).astype(np.float32)
    dist = np.asarray(jlss.two_hot_depth(jnp.asarray(
        rng.uniform(1.2, 9.0, (B, N, hf, wf)).astype(np.float32)), jlift.grid))
    return feat, dist


@pytest.mark.parametrize("ds_feat", [(2, 2, 2), (1, 1, 1)], ids=["ds222", "ds111"])
def test_unfused_presorted_lift_matches_jax(ds_feat):
    """The flat layout (the key says which: "rk_sorted") integer-equal to
    JAX's fuse_ds_pool=False precompute, and lift_presorted (kernel #2's
    plain version, then the max-pool) at 1e-5; at ds_feat (1,1,1), which
    has no fused layout, the default picks the flat one."""
    import jax.numpy as jnp
    from test_torch_common import to_np, to_torch

    jlift, tlift, jargs, targs = _rig_lifts(ds_feat)
    want = jlift.precompute_sorted(*jargs, fuse_ds_pool=False)
    got = tlift.precompute_sorted(*targs, fuse_ds_pool=None if ds_feat == (1, 1, 1) else False)
    assert sorted(got) == sorted(want) == ["order", "ranks", "rk_sorted"]
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]), err_msg=k)
    feat, dist = _feat_dist(jlift, got["ranks"].shape, 4)
    w = jlift.lift_presorted(jnp.asarray(feat), jnp.asarray(dist), want)
    g = tlift.lift_presorted(to_torch(feat), to_torch(dist), got)
    np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_presorted_backward_matches_jax_vjp():
    """bev_pool_presorted's gather adjoint, through the [2,2,2] max-pool, vs
    JAX's custom VJP of bev_pool_pallas_presorted on the tiny rig. fp32,
    1e-5."""
    from test_torch_common import to_np
    from test_torch_lift import _grads, _torch_grads

    jlift, tlift, jargs, targs = _rig_lifts((2, 2, 2))
    want_pre = jlift.precompute_sorted(*jargs, fuse_ds_pool=False)
    got_pre = tlift.precompute_sorted(*targs, fuse_ds_pool=False)
    feat, dist = _feat_dist(jlift, got_pre["ranks"].shape, 6)
    B = feat.shape[0]
    nx, ny, nz = jlift.grid.size
    cot = np.random.default_rng(7).standard_normal(
        (B, nz // 2, ny // 2, nx // 2, 3)).astype(np.float32)
    want = _grads(lambda d, f: jlift.lift_presorted(f, d, want_pre), (dist, feat), (0, 1), cot)
    _, got = _torch_grads(lambda d, f: tlift.lift_presorted(f, d, got_pre), (dist, feat),
                          (0, 1), cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_resolve_sensor2keyegos_matches_jax():
    """The chain from the batch's own rig, and a pinned one taken as it is."""
    import jax.numpy as jnp
    from test_model_graph import _metas
    from test_torch_common import to_np, to_torch

    from veon_tpu.model.veon import resolve_sensor2keyegos as jresolve

    from veon_tpu_torch.model.veon import resolve_sensor2keyegos

    metas = _metas(2, 3, 6, np.random.default_rng(3))
    tm = {k: to_torch(np.asarray(v)) for k, v in metas.items()}
    np.testing.assert_allclose(to_np(resolve_sensor2keyegos(tm, 2, 3, 6)),
                               np.asarray(jresolve(metas, 2, 3, 6)), rtol=1e-6, atol=1e-6)
    pinned = np.random.default_rng(4).standard_normal((2, 3, 6, 4, 4)).astype(np.float32)
    got = resolve_sensor2keyegos(dict(tm, sensor2keyegos=to_torch(pinned)), 2, 3, 6)
    np.testing.assert_array_equal(to_np(got), np.asarray(
        jresolve(dict(metas, sensor2keyegos=jnp.asarray(pinned)), 2, 3, 6)))


@pytest.mark.parametrize("num_shards", [2, 3])
def test_prepare_camshard_metas_matches_jax(num_shards):
    """The pinned whole-rig keyegos, and with presort the stacked per-shard
    streams (padded with order 0 / rank num_cells) integer-equal to JAX's."""
    from test_torch_common import to_np

    from veon_tpu.cli.shapes import example_batch as j_example_batch
    from veon_tpu.configs import presets as jpresets
    from veon_tpu.serve.camshard import prepare_camshard_metas as jprepare

    from veon_tpu_torch.cli.shapes import example_batch
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.model.camshard import prepare_camshard_metas

    jcfg, tcfg = jpresets.veon_tiny_test(), presets.veon_tiny_test()
    want = jprepare(jcfg, j_example_batch(jcfg)[2], num_shards, presort=True)
    got = prepare_camshard_metas(tcfg, example_batch(tcfg, device="cpu")[2], num_shards,
                                 presort=True)
    np.testing.assert_allclose(to_np(got["sensor2keyegos"]), np.asarray(want["sensor2keyegos"]),
                               rtol=1e-6, atol=1e-6)
    assert got["lift_sorted"]["order"].shape[0] == num_shards
    for k in ("order", "rk_sorted", "ranks"):
        np.testing.assert_array_equal(to_np(got["lift_sorted"][k]),
                                      np.asarray(want["lift_sorted"][k]), err_msg=k)
    with pytest.raises(ValueError, match="not divisible by --cam-shards 4"):
        prepare_camshard_metas(tcfg, example_batch(tcfg, device="cpu")[2], 4)


def test_pooled_layout_refused_under_a_cam_group():
    """The fused layout max-pools before any cross-camera sum could run:
    a cam group refuses it with JAX's error, picks the flat layout by
    default, and lift_presorted refuses a "rk_pooled" dict."""
    from veon_tpu_torch.collectives import CamGroup

    jlift, tlift, jargs, targs = _rig_lifts((2, 2, 2))
    tlift = dataclasses.replace(tlift, cam_group=CamGroup(None, 2, 0))
    jlift = dataclasses.replace(jlift, psum_axis="cam")
    with pytest.raises(ValueError) as want:
        jlift.precompute_sorted(*jargs, fuse_ds_pool=True)
    with pytest.raises(ValueError) as got:
        tlift.precompute_sorted(*targs, fuse_ds_pool=True)
    assert str(got.value) == str(want.value) and "before the max-pool" in str(got.value)
    assert "rk_sorted" in tlift.precompute_sorted(*targs)
    pooled = dataclasses.replace(tlift, cam_group=None).precompute_sorted(*targs)
    assert "rk_pooled" in pooled
    feat = torch.zeros(pooled["ranks"].shape[:2] + pooled["ranks"].shape[3:] + (3,))
    with pytest.raises(AssertionError, match="cam-axis psum"):
        tlift.lift_presorted(feat, torch.zeros(pooled["ranks"].shape), pooled)


def test_max_before_sum_differs_where_cameras_share_cells():
    """On the tiny rig, whose neighbouring cameras put mass in the same
    coarse cells: the shards' fine grids summed, then max-pooled, equal the
    unsharded lift; max-pooled first, then summed, they do not (the order
    the pooled layout would force)."""
    from test_torch_common import to_torch

    from veon_tpu_torch.ops.bev_pool import bev_pool_presorted

    jlift, tlift, _, targs = _rig_lifts((2, 2, 2))
    full = tlift.precompute_sorted(*targs, fuse_ds_pool=False)
    feat, dist = (to_torch(a) for a in _feat_dist(jlift, full["ranks"].shape, 9))
    want = tlift.lift_presorted(feat, dist, full)
    fine = []
    for cams in (slice(0, 1), slice(1, 3)):
        pre = tlift.precompute_sorted(*[a[:, cams] for a in targs[:4]], targs[4],
                                      fuse_ds_pool=False)
        fine.append(bev_pool_presorted(dist[:, cams], feat[:, cams], pre["order"],
                                       pre["rk_sorted"], pre["ranks"], tlift.grid.size))
    occupied = [tlift._ds_pool(f.abs()).amax(-1) > 0 for f in fine]
    assert (occupied[0] & occupied[1]).sum() > 0, "the cameras share no coarse cell"
    torch.testing.assert_close(tlift._ds_pool(fine[0] + fine[1]), want, rtol=1e-5, atol=1e-5)
    wrong = tlift._ds_pool(fine[0]) + tlift._ds_pool(fine[1])
    assert (wrong - want).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# four gloo processes


def _port_model(F, sd):
    """The tiny model with JAX's weights (seeded where JAX's tree has none:
    the depth tower, which a forward from metric depth does not build)."""
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.entry import build_model

    model = build_model(presets.veon_tiny_test(num_temporal=F), torch.device("cpu"), 0, None)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    return model.eval()


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)) if isinstance(tree, np.ndarray) else tree


class _SGD:
    """Plain SGD in the optimizer interface the step takes (optax.sgd of
    JAX's test): parameter deltas are -lr * the gradient itself."""

    def init(self, params):
        from veon_tpu_torch.train.step import AdamState

        return AdamState(0, {}, {})

    @torch.no_grad()
    def update(self, grads, state, params):
        from veon_tpu_torch.train.step import AdamState

        for n, p in params.items():
            p.add_(grads[n], alpha=-LR)
        return AdamState(state.count + 1, {}, {})


def _worker(rank, ports, inputs, out):
    """Rank `rank` of the 4-process world: the CLI, the 2 x 2 step, then the
    forwards on the groups of the first 2 and 3 ranks. Saves its results."""
    import torch.distributed as dist
    from test_torch_distributed import _fixture_preset

    from veon_tpu_torch.cli import main as pcli
    from veon_tpu_torch.collectives import CamGroup, cam_groups
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.model.camshard import prepare_camshard_metas
    from veon_tpu_torch.serve.camshard import make_camera_sharded_forward
    from veon_tpu_torch.serve.streaming import TemporalSession
    from veon_tpu_torch.train import distributed as D
    from veon_tpu_torch.train import loop
    from veon_tpu_torch.train import step as tstep

    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    port_cli, port = ports.split(",")
    res = {}

    # (vi) `train --cam-shards 2` on a 2 x 2 world through the CLI
    presets.veon_tiny_fixture = _fixture_preset
    seen = dict(steps=0, saves=[])
    orig_prepare, orig_save = pcli.prepare_camshard_metas, loop.save_checkpoint

    def prepare(cfg, metas, num_shards, presort=False):
        assert num_shards == 2 and not presort and metas["sensor2egos"].shape[2] == 6
        seen["steps"] += 1
        return orig_prepare(cfg, metas, num_shards, presort)

    def save(directory, step, *a, **kw):
        seen["saves"].append(step)
        return orig_save(directory, step, *a, **kw)

    models = []
    orig_make = pcli.make_train_step

    def make_train_step(model, *a, **kw):
        models.append(model)
        seen["cam_group"] = (kw["cam_group"].size, kw["cam_group"].index,
                             kw["cam_group"].batch_index, kw["cam_group"].batch_shards)
        return orig_make(model, *a, **kw)

    pcli.prepare_camshard_metas, loop.save_checkpoint, pcli.make_train_step = (
        prepare, save, make_train_step)
    c = inp["cli"]
    seen["result"] = pcli.main(
        ["train", "--preset", "veon_tiny_fixture", "--data-root", c["root"], "--ann", c["pkl"],
         "--workers", "1", "--device", "cpu", "--epochs", "1", "--work-dir", c["work"],
         "--cam-shards", "2", "--dist-coordinator", f"localhost:{port_cli}",
         "--dist-num-processes", str(WORLD), "--dist-process-id", str(rank)])
    seen["params"] = {n: t.numpy().copy() for n, t in models[-1].state_dict().items()}
    res["cli"] = seen

    D.init_group(f"localhost:{port}", WORLD, rank, device="cpu")
    # (v) one SGD step on the 2 x 2 grid: each batch row takes one row of
    # the B=2 batch, each cam rank three of its six cameras
    t = inp["train"]
    cg = cam_groups(2, 2)
    model = _port_model(1, t["sd"]).set_cam_group(cg)
    model.train()
    tx = _SGD()
    state = tstep.create_train_state(model, tx)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    row = cg.batch_index
    batch = _tensors({k: (v[row:row + 1] if k in ("imgs", "depth", "voxel_semantics",
                                                   "mask_camera") else v)
                      for k, v in t["batch"].items() if k != "metas"})
    metas = {k: v[row:row + 1] for k, v in _tensors(t["batch"]["metas"]).items()}
    batch.update(metas=prepare_camshard_metas(model.cfg, metas, 2),
                 ov_weight=torch.from_numpy(t["ovw"]), epoch=0)
    step = tstep.make_train_step(model, tx, model.cfg, t["membership"], cam_group=cg)
    state, losses = step(state, batch)
    res["train"] = dict(
        losses={k: float(v) for k, v in losses.items()},
        deltas={n: (p.detach() - before[n]).numpy() for n, p in model.named_parameters()},
        buffers={n: b.numpy().copy() for n, b in model.named_buffers()})

    # the forwards, on the groups of the first 2 and 3 ranks (every rank
    # makes every group); eval mode: nothing else of the world syncs
    groups = {S: dist.new_group(list(range(S))) for S in (2, 3)}
    g1 = inp["tiny1"]
    imgs, depth, ovw = (torch.from_numpy(g1[k]) for k in ("imgs", "depth", "ovw"))
    metas1 = _tensors(g1["metas"])
    with torch.no_grad():
        for S in (2, 3):
            if rank >= S:
                continue
            cg = CamGroup(groups[S], S, rank)
            fwd = make_camera_sharded_forward(_port_model(1, g1["sd"]), cg, method="forward")
            res[f"banded{S}"] = {k: v.numpy() for k, v in fwd(
                imgs, depth, prepare_camshard_metas(model.cfg, metas1, S), ovw).items()}
            if S == 2:
                pre = prepare_camshard_metas(model.cfg, metas1, S, presort=True)
                res["presorted2"] = {k: v.numpy() for k, v in fwd(imgs, depth, pre, ovw).items()}
        if rank < 3:
            cg = CamGroup(groups[3], 3, rank)
            # (iii) a 3-shard session: the previous frame, then the current one
            g2 = inp["tiny2"]
            im2, d2, m2 = torch.from_numpy(g2["imgs"]), torch.from_numpy(g2["depth"]), \
                _tensors(g2["metas"])
            sess = TemporalSession(_port_model(2, g2["sd"]), torch.from_numpy(g2["ovw"]),
                                   estimate_depth=False, cam_group=cg)

            def frame(f):
                m = {k: m2[k][:, f:f + 1] for k in ("sensor2egos", "ego2globals", "intrins",
                                                    "post_rots", "post_trans")}
                m["bda"] = m2["bda"]
                return m

            sess.infer(im2[:, 1:2], d2[:, 1:2],
                       dict(frame(1), lidarego2global=m2["prev_lidarego2global"][:, 0]))
            cur = sess.infer(im2[:, 0:1], d2[:, 0:1],
                             dict(frame(0), lidarego2global=m2["lidarego2global"]))
            res["streaming"] = dict(calls=sess.calls, out={k: v.numpy() for k, v in cur.items()})
            # (iv) the serve handler with 3 shards: rank 0 serves, 1-2 follow
            handler, required, _expect, exclusive = pcli.build_serve_handler(
                inp["serve_args"], cam_group=cg)
            res["serve"] = dict(required=required, exclusive=exclusive, leader=handler.leader)
            if handler.leader:
                req = inp["serve_req"]
                res["serve"]["out"] = handler(**req)
                # refused before the broadcast: a frame of another shape
                try:
                    handler(**dict(req, imgs=req["imgs"][:, :, :5]))
                except ValueError as e:
                    res["serve"]["refused"] = str(e)
                # broadcast, then failing on every rank: a text embedding
                # of another width
                try:
                    handler(**dict(req, text_embed=req["text_embed"][:3]))
                except RuntimeError as e:
                    res["serve"]["failed"] = str(e)
                res["serve"]["after"] = handler(**req)
                handler.close()
            else:
                handler.follow()
    D.shutdown()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)


def _spawn(*args):
    """The WORLD ranks of this file's worker; their outputs, each rank
    exiting 0, all killed if one outlives the timeout."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "worker", str(r),
                               *map(str, args)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    return procs


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("camshard ranks timed out")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"camshard rank {r} failed:\n{out[out.rfind('Traceback'):][:4000]}"
    return outs


def _jax_train_step():
    """(the step's inputs, JAX's losses and parameter deltas after one SGD
    step on a ("batch", "cam") = (2, 2) mesh) at the JAX test's batch."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh
    from test_torch_common import np_tree

    from veon_tpu.cli.shapes import example_batch
    from veon_tpu.configs import presets
    from veon_tpu.model.veon import VeonModel
    from veon_tpu.nn import text as text_mod
    from veon_tpu.serve.camshard import prepare_camshard_metas
    from veon_tpu.train.step import create_train_state, make_train_step

    cfg = presets.veon_tiny_test()
    B = 2
    imgs, depth, metas = example_batch(cfg, B=B)
    prompts, refl = text_mod.build_vocabulary(cfg.vocabulary)
    rng = np.random.default_rng(7)
    ovw = rng.standard_normal((len(prompts) + 1, cfg.san.clip_embed_dim)).astype(np.float32)
    nx, ny, nz = cfg.grid.size
    labels = rng.integers(0, 18, size=(B, nx, ny, nz)).astype(np.int32)
    membership = text_mod.merge_matrix(refl)
    variables = jax.jit(VeonModel(cfg=cfg).init, static_argnames=("train",))(
        jax.random.PRNGKey(0), imgs[:1], depth[:1],
        jax.tree_util.tree_map(lambda x: x[:1], metas), jnp.asarray(ovw), train=True)
    base = jax.tree_util.tree_map(lambda x: np.array(x, copy=True), np_tree(variables))
    jbatch = {"imgs": imgs, "depth": depth, "metas": prepare_camshard_metas(cfg, metas, 2),
              "voxel_semantics": jnp.asarray(labels),
              "mask_camera": jnp.ones((B, nx, ny, nz), jnp.int32),
              "ov_weight": jnp.asarray(ovw), "epoch": jnp.asarray(0, jnp.int32)}
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("batch", "cam"))
    model = VeonModel(cfg=cfg, bn_axis_name="batch", cam_axis_name="cam")
    tx = optax.sgd(LR)
    state, losses = make_train_step(model, tx, cfg, membership, mesh=mesh, cam_axis="cam")(
        create_train_state(model, jax.tree_util.tree_map(jnp.asarray, base), tx), jbatch)
    deltas = jax.tree_util.tree_map(lambda a, b: a - b, np_tree(state.params),
                                    base["params"])
    batch = {"imgs": np.asarray(imgs), "depth": np.asarray(depth),
             "metas": {k: np.asarray(v) for k, v in metas.items()}, "voxel_semantics": labels,
             "mask_camera": np.ones((B, nx, ny, nz), np.int32)}
    return (dict(base=base, batch=batch, ovw=ovw, membership=membership),
            {k: float(v) for k, v in losses.items()}, deltas, np_tree(state.batch_stats))


def _port_sd(F, variables):
    from test_torch_common import np_tree

    from veon_tpu_torch.ckpt.from_jax import state_dict_from_jax
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.model.veon import VeonModel

    model = VeonModel(presets.veon_tiny_test(num_temporal=F), device="cpu")
    return {k: v.numpy() for k, v in state_dict_from_jax(model, np_tree(variables),
                                                         strict=False).items()}


@pytest.fixture(scope="module")
def sharded(tiny_graph, tmp_path_factory):
    """JAX's references and the four ranks' results."""
    import argparse

    import jax
    from jax.sharding import Mesh
    from test_data_pipeline import _make_fixture

    from veon_tpu.serve.camshard import make_camera_sharded_forward as jfwd
    from veon_tpu.serve.camshard import prepare_camshard_metas as jprepare

    from veon_tpu_torch.cli.shapes import example_batch_full
    from veon_tpu_torch.configs import presets

    d = tmp_path_factory.mktemp("camshard")
    g1, g2 = tiny_graph(1), tiny_graph(2)
    train_in, jlosses, jdeltas, jstats = _jax_train_step()
    root = str(d / "nusc")
    os.makedirs(root)
    cfg = presets.veon_tiny_test()
    imgs, depth_imgs, _ = example_batch_full(cfg, device="cpu")
    te = np.random.default_rng(11).standard_normal(
        cfg.propagation.clip_proj_dim).astype(np.float32)
    serve_args = argparse.Namespace(preset="veon_tiny_test", num_temporal=1, load_from=None,
                                    depth_load_from=None, bpe_path=None, device="cpu",
                                    raw_uint8=False, cam_shards=3)
    inputs = dict(
        cli=dict(root=root, pkl=_make_fixture(root), work=str(d / "work")),
        train=dict(sd=_port_sd(1, train_in["base"]), batch=train_in["batch"],
                   ovw=train_in["ovw"], membership=train_in["membership"]),
        tiny1=dict(sd=_port_sd(1, g1["params"]), imgs=np.asarray(g1["imgs"]),
                   depth=np.asarray(g1["depth"]), ovw=np.asarray(g1["ovw"]),
                   metas={k: np.asarray(v) for k, v in g1["metas"].items()}),
        tiny2=dict(sd=_port_sd(2, g2["params"]), imgs=np.asarray(g2["imgs"]),
                   depth=np.asarray(g2["depth"]), ovw=np.asarray(g2["ovw"]),
                   metas={k: np.asarray(v) for k, v in g2["metas"].items()}),
        serve_args=serve_args,
        serve_req=dict(imgs=imgs.numpy(), depth_imgs=depth_imgs.numpy(), text_embed=te))
    path = str(d / "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    procs = _spawn(f"{_free_port()},{_free_port()}", path, d / "out")
    try:
        # JAX's sharded forwards while the ranks run
        jout = {}
        for S in (2, 3):
            mesh = Mesh(np.asarray(jax.devices()[:S]), ("cam",))
            fwd = jfwd(g1["cfg"], mesh, method="forward")
            jout[f"banded{S}"] = fwd(g1["params"], g1["imgs"], g1["depth"],
                                     jprepare(g1["cfg"], g1["metas"], S), g1["ovw"])
            if S == 2:
                jout["presorted2"] = fwd(g1["params"], g1["imgs"], g1["depth"],
                                         jprepare(g1["cfg"], g1["metas"], S, presort=True),
                                         g1["ovw"])
        jout = {k: {n: np.asarray(v) for n, v in o.items()} for k, o in jout.items()}
    finally:
        outs = _wait(procs)
    ranks = []
    for r in range(WORLD):
        with open(d / f"out.{r}", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(ranks=ranks, outs=outs, jout=jout, jlosses=jlosses, jdeltas=jdeltas,
                jstats=jstats, inputs=inputs, g1=g1, g2=g2, work=inputs["cli"]["work"])


def _compare(got, want, keys=None):
    assert keys is not None or set(got) == set(want), (sorted(got), sorted(want))
    for k in keys or want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k, **TOL)


def _unsharded(sharded, F=1):
    g = sharded["g1"] if F == 1 else sharded["g2"]
    model = _port_model(F, sharded["inputs"][f"tiny{F}"]["sd"])
    with torch.no_grad():
        return {k: v.numpy() for k, v in model(
            torch.from_numpy(np.asarray(g["imgs"])), torch.from_numpy(np.asarray(g["depth"])),
            _tensors({k: np.asarray(v) for k, v in g["metas"].items()}),
            torch.from_numpy(np.asarray(g["ovw"]))).items()}


@pytest.mark.parametrize("num_shards", [2, 3])
def test_camshard_banded_forward_matches_jax_and_unsharded(sharded, num_shards):
    """Each rank's outputs (per-camera leaves gathered to six cameras, voxel
    leaves after the cross-camera sum) against JAX's sharded forward and
    the port's unsharded one."""
    want = _unsharded(sharded)
    for r in range(num_shards):
        got = sharded["ranks"][r][f"banded{num_shards}"]
        assert got["sem_seg_ds"].shape == want["sem_seg_ds"].shape
        _compare(got, sharded["jout"][f"banded{num_shards}"])
        _compare(got, want)


def test_camshard_presorted_forward_matches_jax(sharded):
    """The per-shard flat presorted streams (kernel #2's plain version on
    each rank's stream, then the sum, then the max-pool) against JAX's
    presorted sharded forward and the banded unsharded one."""
    for r in range(2):
        got = sharded["ranks"][r]["presorted2"]
        _compare(got, sharded["jout"]["presorted2"])
        _compare(got, sharded["g1"]["out"])


def test_camshard_streaming_session_matches_jax(sharded):
    """A 3-shard session over the previous frame, then the current one
    (each frame's keyego anchor pinned from its whole rig), against JAX's
    batched F=2 forward on the same frames."""
    for r in range(3):
        s = sharded["ranks"][r]["streaming"]
        assert s["calls"] == 2
        _compare(s["out"], sharded["g2"]["out"], keys=sorted(sharded["g2"]["out"]))


def test_camshard_serve_handler_matches_unsharded(sharded):
    """`build_serve_handler` with 3 shards (rank 0 serves the request, ranks
    1-2 follow its broadcast) against the same handler unsharded: the
    class grid agrees on >= 0.999 of the voxels, retrieval to 2e-4."""
    from veon_tpu_torch.cli.main import build_serve_handler

    ns = sharded["inputs"]["serve_args"]
    one = type(ns)(**dict(vars(ns), cam_shards=1))
    handler, required, _expect, exclusive = build_serve_handler(one)
    want = handler(**sharded["inputs"]["serve_req"])
    s = [sharded["ranks"][r]["serve"] for r in range(3)]
    assert [x["leader"] for x in s] == [True, False, False]
    assert s[0]["required"] == required == ("imgs", "depth_imgs") and not s[0]["exclusive"]
    got = s[0]["out"]
    same = np.mean(got["pred"] == want["pred"])
    assert same >= 0.999, f"pred agreement {same}"
    np.testing.assert_allclose(got["retrieval"], want["retrieval"], **TOL)
    assert not exclusive


def test_camshard_serve_handler_survives_bad_requests(sharded):
    """The 3-shard handler refuses a frame of another shape before it
    broadcasts it, and a request that fails on every rank's compute (a
    text embedding of another width) is reported by rank 0 and logged by
    ranks 1-2, which keep following: the next good request is answered
    exactly as the first, and every rank exits."""
    s = sharded["ranks"][0]["serve"]
    assert "imgs shape (1, 1, 5," in s["refused"], s["refused"]
    assert s["failed"]
    for k, v in s["out"].items():
        np.testing.assert_array_equal(s["after"][k], v, err_msg=k)
    for r in (1, 2):
        assert "request failed: RuntimeError" in sharded["outs"][r], sharded["outs"][r][-2000:]
        assert "imgs shape" not in sharded["outs"][r]


def test_camshard_train_step_deltas_match_jax_and_unsharded(sharded):
    """One SGD step on the (batch x cam) = 2 x 2 grid: the losses and every
    parameter's delta (-lr * the combined gradient) against JAX's 2-D mesh
    step at JAX's tolerances (losses rtol 2e-4; deltas rtol 5e-3, atol
    1e-5, where a wrong cam combine is an exact 2x error), and against the
    port's unsharded step on the whole B=2 batch, whose BatchNorm running
    stats the grid's world-synced ones match; all four ranks bit-equal."""
    from test_torch_common import np_tree

    from veon_tpu_torch.ckpt.from_jax import state_dict_from_jax
    from veon_tpu_torch.entry import build_model
    from veon_tpu_torch.train import step as tstep

    t = sharded["inputs"]["train"]
    ranks = [sharded["ranks"][r]["train"] for r in range(WORLD)]
    for r in range(1, WORLD):
        assert ranks[r]["losses"] == ranks[0]["losses"]
        for n, v in ranks[0]["deltas"].items():
            assert np.array_equal(ranks[r]["deltas"][n], v), n
    got = ranks[0]
    for k, v in sharded["jlosses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=2e-4, err_msg=k)

    # the port's unsharded step on the whole batch
    model = _port_model(1, t["sd"])
    model.train()
    tx = _SGD()
    state = tstep.create_train_state(model, tx)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = _tensors({k: v for k, v in t["batch"].items()})
    batch.update(ov_weight=torch.from_numpy(t["ovw"]), epoch=0)
    _, losses = tstep.make_train_step(model, tx, model.cfg, t["membership"])(state, batch)
    for k, v in losses.items():
        np.testing.assert_allclose(got["losses"][k], float(v), rtol=2e-4, err_msg=k)
    ref = build_model(model.cfg, torch.device("cpu"), 0, None)
    jd = state_dict_from_jax(ref, {"params": np_tree(sharded["jdeltas"])}, strict=False)
    moved = 0.0
    for n, p in model.named_parameters():
        d1 = (p.detach() - before[n]).numpy()
        np.testing.assert_allclose(got["deltas"][n], d1, rtol=5e-3, atol=1e-5, err_msg=n)
        if p.requires_grad:  # JAX's optax.sgd also moves the frozen towers' leaves
            np.testing.assert_allclose(got["deltas"][n], jd[n].numpy(), rtol=5e-3, atol=1e-5,
                                       err_msg=n)
        moved = max(moved, float(np.abs(d1).max()))
    assert moved > 1e-6, "no parameter moved"
    assert sum(p.requires_grad for p in model.parameters()) > 20
    stats = state_dict_from_jax(ref, {"batch_stats": sharded["jstats"]}, strict=False)
    for n, b in model.named_buffers():
        np.testing.assert_allclose(got["buffers"][n], b.numpy(), rtol=1e-4, atol=1e-5, err_msg=n)
        if n in stats:
            np.testing.assert_allclose(got["buffers"][n], stats[n].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=n)


def test_train_cli_cam_shards_wiring(sharded):
    """`train --cam-shards 2` on 4 processes: a 2 x 2 grid (this rank's
    cam index and batch row), the whole rig's keyegos pinned in every
    batch of six cameras, 2 steps per rank (the fixture's 3 frames over 2
    batch rows), rank 0 alone saves, and every rank ends with the same
    params."""
    recs = [sharded["ranks"][r]["cli"] for r in range(WORLD)]
    for r, rec in enumerate(recs):
        assert rec["cam_group"] == (2, r % 2, r // 2, 2)
        assert rec["steps"] == 2 and rec["result"] == {"start_epoch": 0, "step": 2}
        assert rec["saves"] == ([2] if r == 0 else [])
        for n, a in recs[0]["params"].items():
            assert np.array_equal(rec["params"][n], a), (r, n)
    assert ("TOTAL" in sharded["outs"][0]) and not any("TOTAL" in o for o in sharded["outs"][1:])
    assert "step_2" in os.listdir(sharded["work"])


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    _worker(int(sys.argv[2]), *sys.argv[3:])
