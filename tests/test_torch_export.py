"""The port's deployment export against the JAX package's, on the CPU, tiny
preset, fp32, shared weights (`ckpt/from_jax.py`): kernels #1-#3 as
registered operators, the F=1 serving graph and the T=2 streaming step
exported with `torch.export`, saved, reloaded and run beside JAX's
`jax.export` artifacts of the same graphs, the live session against the
artifact, and an artifact served over the socket (`serve_exported`).

Tolerances: the F=1 class grid equal; the T=2 outputs within JAX's own
streaming-artifact tolerance, rtol 2e-5 / atol 2e-6 (`tests/test_export.py`
test_export_streaming_roundtrip), but early_vox and retrieval, which cross
frameworks within looser bounds (`_t2_tol` says why), the uint8 grid equal;
the port's artifact against the port's live module bit-equal (the program
runs the same aten ops in the same order)."""

import os

import numpy as np
import pytest
import torch

from test_torch_common import np_tree, to_np, to_torch

from veon_tpu_torch.ops import bev_pool as bp
from veon_tpu_torch.serve.client import TensorClient
from veon_tpu_torch.serve.server import serve_exported
from veon_tpu_torch.serve.streaming import TemporalSession
from veon_tpu_torch.utils import export as t_export
from veon_tpu_torch.utils.bench_model import build_serving_forward

TINY = "veon_tiny_test"


def _pooled_nodes(program):
    return [n for n in program.graph.nodes if n.target is torch.ops.veon.bev_pool_pooled.default]


def _jax_inputs(tree):
    """A JAX argument tree (dicts of arrays) as torch tensors."""
    if isinstance(tree, dict):
        return {k: _jax_inputs(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_jax_inputs(v) for v in tree)
    return to_torch(np.asarray(tree))


def _opcheck_cases():
    rng = np.random.default_rng(3)
    B, N, D, h, w, C, cells = 1, 2, 5, 3, 4, 8, 64
    P = B * N * D * h * w
    depth = torch.from_numpy(rng.uniform(size=(B, N, D, h, w)).astype(np.float32))
    feat = torch.from_numpy(rng.standard_normal((B, N, h, w, C)).astype(np.float32))
    rk = torch.from_numpy(np.sort(rng.integers(0, cells + 1, P)).astype(np.int32))
    order = torch.from_numpy(rng.permutation(P).astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((P, C)).astype(np.float32))
    return {"bev_pool_pooled": (depth, feat, order, rk, cells, 8),
            "bev_pool_sorted": (vals, rk, cells),
            "bev_pool_sorted2": (vals, rk, vals.flip(0).contiguous(), rk, cells)}


@pytest.mark.parametrize("name", ["bev_pool_pooled", "bev_pool_sorted", "bev_pool_sorted2"])
def test_kernel_ops_pass_opcheck(name):
    """Schema, fake version (shape and dtype without data), autograd
    registration and AOT dispatch of each registered kernel; its CPU
    version equals the plain one bit for bit and counts no launch."""
    op = getattr(torch.ops.veon, name).default
    args = _opcheck_cases()[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    fn = getattr(bp, name)
    fn.launches = 0
    got = op(*args)
    if name == "bev_pool_pooled":
        depth, feat, order, rk, cells, r = args
        want = bp.bev_pool_pooled_plain(bp.presorted_vals(depth, feat, order), rk, cells, r,
                                        feat.dtype)
    else:
        streams = list(zip(args[:-1:2], args[1:-1:2]))
        want = bp.bev_pool_sorted_plain(streams, args[-1], torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert fn.launches == 0


@pytest.fixture(scope="module")
def f1_artifacts(tmp_path_factory):
    """JAX's `build_serving_forward` tiny fp32 through JAX's exporter, and the
    port's on the same weights through `torch.export`, both reloaded."""
    from veon_tpu.utils import bench_model as j_bench
    from veon_tpu.utils import export as j_export

    tmp = tmp_path_factory.mktemp("f1")
    j_fn, j_args = j_bench.build_serving_forward(TINY, "float32")
    j_path = j_export.export_inference(j_fn, j_args, str(tmp / "veon_infer.stablehlo"))
    want = np.asarray(j_export.load_inference(j_path)(*j_args))
    forward, args = build_serving_forward(TINY, "float32", device="cpu",
                                          variables=np_tree(j_args[0]))
    path = t_export.export_inference(forward, args, str(tmp / "veon_infer.pt2"))
    return dict(j_args=j_args, want=want, forward=forward, args=args, path=path,
                program=t_export.load_program(path))


def test_f1_artifact_matches_jax_artifact(f1_artifacts):
    """The reloaded port program on JAX's own inputs (frames, rig metas with
    JAX's presorted streams, open-vocabulary matrix) gives JAX's artifact's
    class grid, and the live module's on the port's inputs."""
    a = f1_artifacts
    program = a["program"].module()
    _params, *j_inputs = a["j_args"]
    got = to_np(program(*_jax_inputs(tuple(j_inputs))))
    assert got.dtype == np.int32 and got.shape == a["want"].shape
    np.testing.assert_array_equal(got, a["want"])
    assert (got != 17).any() and (got == 17).any()  # both branches of the fusion rule occur
    with torch.no_grad():
        np.testing.assert_array_equal(to_np(program(*a["args"])), to_np(a["forward"](*a["args"])))


def test_f1_graph_holds_one_pooled_kernel(f1_artifacts):
    """Kernel #1 is one node of the saved graph (not its plain version
    traced into aten ops), and no value is copied to the host inside it."""
    program = f1_artifacts["program"]
    assert len(_pooled_nodes(program)) == 1
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert not any("index_add" in t for t in targets), targets
    copies = t_export.device_copies(program)
    assert copies["to_host"] == [] and copies["scalar_reads"] == [], copies


def test_serve_exported_round_trip(f1_artifacts):
    """A saved F=1 program served over the socket with its rig metas and
    open-vocabulary matrix bound: the response equals the live module, a
    missing request tensor is reported and the connection keeps serving."""
    a = f1_artifacts
    imgs, depth_imgs, metas, ovw = a["args"]
    sock = os.path.join(os.path.dirname(a["path"]), "veon.sock")
    srv = serve_exported(a["path"], sock, bound={"metas": metas, "ov_weight": ovw},
                         request_keys=("imgs", "depth_imgs"),
                         arg_order=("imgs", "depth_imgs", "metas", "ov_weight"),
                         out_names=("pred",), device="cpu")
    try:
        with TensorClient(sock) as c:
            out = c.infer(imgs=to_np(imgs), depth_imgs=to_np(depth_imgs))
            with pytest.raises(RuntimeError, match="missing tensors"):
                c.infer(imgs=to_np(imgs))
            again = c.infer(imgs=to_np(imgs), depth_imgs=to_np(depth_imgs))
    finally:
        srv.stop()
    with torch.no_grad():
        want = to_np(a["forward"](*a["args"]))
    np.testing.assert_array_equal(out["pred"], want)
    np.testing.assert_array_equal(again["pred"], want)
    assert "server_ms" in out


@pytest.fixture(scope="module")
def t2_artifacts(tmp_path_factory):
    """JAX's `export_streaming` tiny T=2 and the port's on JAX's weights,
    both reloaded."""
    from veon_tpu.utils import export as j_export

    tmp = tmp_path_factory.mktemp("t2")
    j_path, j_example = j_export.export_streaming(str(tmp / "t2.stablehlo"), preset=TINY,
                                                  num_temporal=2)
    path, example = t_export.export_streaming(str(tmp / "veon_infer_t2.pt2"), TINY, 2,
                                              device="cpu", variables=np_tree(j_example[0]))
    return dict(j_call=j_export.load_inference(j_path), j_example=j_example, path=path,
                example=example, program=t_export.load_program(path))


def _t2_tol(key, want):
    """JAX's artifact tolerance, but for two outputs that cross frameworks
    move more: early_vox, the pool's fp32 sums of many points taken in
    another order (the plain version's index_add_ against the Pallas
    kernel's chunks; measured 9.4e-6 of the grid's largest value beyond
    rtol), within 2e-5 of its largest value; retrieval, a cosine that is
    ill-conditioned where feat_occ is near 0, within the repo's
    cross-framework retrieval tolerance (`test_torch_temporal.py`)."""
    if key == "early_vox":
        return dict(rtol=2e-5, atol=2e-5 * np.abs(want).max())
    if key == "retrieval":
        return dict(rtol=2e-4, atol=2e-4)
    return dict(rtol=2e-5, atol=2e-6)


def _roll(prev_vox, prev_l2g, early, l2g):
    """The session's cache roll, newest first, written out."""
    return (torch.cat([early[:, None].to(prev_vox.dtype), prev_vox[:, :-1]], 1),
            torch.cat([l2g[:, None].float(), prev_l2g[:, :-1]], 1))


def test_t2_artifact_matches_jax_artifact(t2_artifacts):
    """Two calls of each artifact on JAX's inputs, the second with the first
    call's early_vox rolled into prev_vox and the pose moved: every output
    key within JAX's tolerance, pred uint8 and equal, early_vox the shape of
    a prev_vox slot; the graph holds kernel #1 once."""
    import jax.numpy as jnp

    a = t2_artifacts
    program = a["program"].module()
    variables, imgs, depth_imgs, m1, ovw, pv, pl, te = a["j_example"]
    rng = np.random.default_rng(5)
    step = np.eye(4, dtype=np.float32)
    step[:3, 3] = [1.5, -0.3, 0.0]
    l2g2 = np.asarray(m1["lidarego2global"]) @ step
    te2 = rng.standard_normal(np.shape(te)).astype(np.float32)
    j_out = a["j_call"](variables, imgs, depth_imgs, m1, ovw, pv, pl, te)
    args = _jax_inputs((imgs, depth_imgs, m1, ovw, pv, pl, te))
    out = program(*args)
    assert set(out) == set(j_out)
    assert out["pred"].dtype == torch.uint8
    assert tuple(out["early_vox"].shape) == tuple(pv.shape[:1]) + tuple(pv.shape[2:])
    pv2, pl2 = _roll(args[4], args[5], out["early_vox"], args[2]["lidarego2global"])
    j_pv2 = jnp.concatenate([j_out["early_vox"][:, None].astype(pv.dtype), pv[:, :-1]], 1)
    j_pl2 = jnp.concatenate([jnp.asarray(m1["lidarego2global"])[:, None], pl[:, :-1]], 1)
    j_m2 = dict(m1, lidarego2global=jnp.asarray(l2g2))
    j_out2 = a["j_call"](variables, imgs, depth_imgs, j_m2, ovw, j_pv2, j_pl2, jnp.asarray(te2))
    m2 = dict(args[2], lidarego2global=torch.from_numpy(l2g2))
    out2 = program(args[0], args[1], m2, args[3], pv2, pl2, torch.from_numpy(te2))
    for got, want in ((out, j_out), (out2, j_out2)):
        for k in want:
            if k == "pred":
                np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]))
            else:
                w = np.asarray(want[k])
                np.testing.assert_allclose(to_np(got[k]), w, err_msg=k, **_t2_tol(k, w))
    assert np.abs(np.asarray(j_out2["retrieval"])).max() > 0
    assert len(_pooled_nodes(a["program"])) == 1
    copies = t_export.device_copies(a["program"])
    assert copies["to_host"] == [] and copies["scalar_reads"] == [], copies


def test_live_session_matches_artifact(t2_artifacts):
    """Three calls of the live `TemporalSession` of a drive equal the
    program's, with the cache rolled by hand between program calls."""
    from veon_tpu_torch.cli.shapes import drive_poses

    a = t2_artifacts
    program = a["program"].module()
    imgs, depth_imgs, m1, ovw, pv, pl, te = a["example"]
    step, _ = t_export._build_streaming(TINY, 2, device="cpu",
                                        variables=np_tree(a["j_example"][0]))
    rig = {k: v for k, v in m1.items() if k != "lidarego2global"}
    sess = TemporalSession(step.model, ovw, step.membership, rig_metas=rig)
    rng = np.random.default_rng(11)
    for pose in drive_poses(3, seed=2):
        x = imgs + torch.from_numpy(rng.standard_normal(imgs.shape).astype(np.float32))
        l2g = torch.from_numpy(pose)[None]
        live = sess.infer(x, depth_imgs, {"lidarego2global": l2g})
        out = program(x, depth_imgs, dict(m1, lidarego2global=l2g), ovw, pv, pl, te)
        pv, pl = _roll(pv, pl, out.pop("early_vox"), l2g)
        assert set(out) == set(live)
        for k in live:
            torch.testing.assert_close(out[k], live[k], rtol=0, atol=0, msg=k)
    assert sess.calls == 3
    for got, want in zip((pv, pl), sess.state()):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
