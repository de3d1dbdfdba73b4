"""The port's temporal serving slice against the JAX reference on the CPU,
fp32, tiny preset: grid_sample_3d, the ego-motion warp under real motion at
~1000 m global translation, TemporalDeformable (stencil and gather),
TemporalFusion at T=2 and T=3, the batched F=2 / F=3 forwards, streaming ==
batched, the TemporalSession, the uint8 normalizers and retrieval_map.

Module tests carry perturbed weights (`perturbed`); the whole-model tests
use the session-scoped `tiny_graph(T)` tree of `tests/conftest.py`, so no
extra JAX model compile is paid. Tolerances: 2e-4 rtol / 2e-5 atol where
JAX's own streaming and session tests use them (`TOL`), 1e-5 for the
single ops, and for module outputs rtol 1e-4 with an atol of 1e-5 of the
output's largest magnitude (perturbed weights take the fusion stack's
activations to ~25, where fp32 sums in another order cancel to ~1e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_common import np_tree, perturbed, to_np, to_torch

from veon_tpu.data import transforms as j_tf
from veon_tpu.model.veon import VeonModel as JModel
from veon_tpu.model.veon import retrieval_map as j_retrieval_map
from veon_tpu.nn import alignnet as j_align
from veon_tpu.ops.grid_sample import grid_sample_3d as j_grid_sample_3d

from veon_tpu_torch import entry as entry_mod
from veon_tpu_torch.ckpt.from_jax import load_from_jax, state_dict_from_jax
from veon_tpu_torch.cli.shapes import drive_poses, temporal_batch
from veon_tpu_torch.configs import presets
from veon_tpu_torch.data.transforms import normalize_in_graph
from veon_tpu_torch.model.veon import VOXEL_OUTPUTS, VeonModel, retrieval_map
from veon_tpu_torch.nn import alignnet as t_align
from veon_tpu_torch.ops import deform_stencil as t_stencil
from veon_tpu_torch.ops.grid_sample import grid_sample_3d
from veon_tpu_torch.serve.streaming import TemporalSession

TOL = dict(rtol=2e-4, atol=2e-5)
RNG = np.random.default_rng(31)
OUTPUTS = ("sem_seg_ds", "sem_embed_ds", "clip_feat") + VOXEL_OUTPUTS


def _close_scaled(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_3d_matches_reference(align_corners, padding_mode):
    x = RNG.standard_normal((2, 4, 5, 6, 3)).astype(np.float32)
    grid = RNG.uniform(-1.3, 1.3, size=(2, 3, 4, 2, 3)).astype(np.float32)
    want = np.asarray(j_grid_sample_3d(jnp.asarray(x), jnp.asarray(grid), align_corners,
                                       padding_mode))
    got = to_np(grid_sample_3d(to_torch(x), to_torch(grid), align_corners, padding_mode))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_grid_sample_3d_promotes_as_reference():
    """bf16 features at fp32 coordinates come back fp32, as JAX promotes."""
    x = RNG.standard_normal((1, 3, 4, 5, 2)).astype(np.float32)
    grid = RNG.uniform(-1, 1, size=(1, 6, 3)).astype(np.float32)
    want = j_grid_sample_3d(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(grid), True)
    got = grid_sample_3d(to_torch(x).to(torch.bfloat16), to_torch(grid), True)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def _motion(case):
    """(lidarego2global, prev_lidarego2global), (1, 4, 4) each: two frames
    of the synthetic drive (a few metres, a few degrees, ~1000 m from the
    map origin), or a larger turn that moves most voxels by cells and
    pushes some outside the grid (the zeros padding)."""
    poses = drive_poses(2, seed=5)
    if case == "turn":
        th = np.deg2rad(25.0)
        poses[1, :3, :3] = poses[0, :3, :3] @ np.array(
            [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
        poses[1, :3, 3] = poses[0, :3, 3] + np.array([13.0, -9.0, 0.6], np.float32)
    assert np.abs(poses[:, :3, 3]).max() > 500.0
    return poses[1:2], poses[0:1]


@pytest.mark.parametrize("case", ["drive", "turn"])
def test_align_to_prev_matches_jitted_reference(tiny_graph, case):
    cfg = tiny_graph(2)["cfg"]
    nx, ny, nz = cfg.grid.size
    occ = _rand(3, 1, nz // 2, ny // 2, nx // 2, cfg.propagation.dim)
    l2g, prev = _motion(case)
    align = jax.jit(lambda o, a, b: JModel(cfg=cfg).apply(
        {}, o, a, b, method=JModel.align_to_prev))
    want = np.asarray(align(jnp.asarray(occ), jnp.asarray(l2g), jnp.asarray(prev)))
    model = VeonModel(presets.veon_tiny_test(num_temporal=2), device="cpu")
    got = to_np(model.align_to_prev(to_torch(occ), to_torch(l2g), to_torch(prev)))
    assert got.dtype == np.float32
    moved = np.abs(want - occ).max()
    assert moved > 0.1, moved  # the warp is not the identity
    np.testing.assert_allclose(got, want, **TOL)


def _deform_inputs():
    B, D, H, W, C = 1, 2, 10, 10, 16  # the tiny preset's lifted grid
    return _rand(40, B, D, H, W, C), _rand(41, B, D, H, W, C)


@pytest.fixture(scope="module")
def deform_vars():
    prev, cur = _deform_inputs()
    jm = j_align.TemporalDeformable(num_heads=4, num_samples=8, use_stencil=True)
    variables = perturbed(jm.init(jax.random.PRNGKey(2), jnp.asarray(prev), jnp.asarray(cur)), 2)
    return variables, np.asarray(jm.apply(variables, jnp.asarray(prev), jnp.asarray(cur)))


@pytest.mark.parametrize("use_stencil", [True, False])
def test_temporal_deformable_matches_reference(deform_vars, use_stencil):
    """The stencil form against JAX's stencil, and the port's gather form
    (grid_sample_3d, border padding) against the same: the +-0.5 cell bound
    makes the two exact up to rounding."""
    variables, want = deform_vars
    prev, cur = _deform_inputs()
    tm = load_from_jax(t_align.TemporalDeformable(16, use_stencil=use_stencil), variables)
    with torch.no_grad():
        got = to_np(tm(to_torch(prev), to_torch(cur)))
    _close_scaled(got, want)


def test_temporal_deformable_bf16_follows_reference_dtypes(deform_vars):
    """In bf16 (fp32 params) the port keeps JAX's dtype of every
    intermediate: both return bf16, differ by at most a bf16 step of the
    output's largest magnitude (2e-2 of it, two ulps at most), and the port's
    distance to the fp32 result is no larger than JAX's own bf16 one
    (1.25x slack for rounding in another order)."""
    variables, want32 = deform_vars
    prev, cur = _deform_inputs()
    for use_stencil in (True, False):
        jm = j_align.TemporalDeformable(use_stencil=use_stencil, dtype=jnp.bfloat16)
        want = jm.apply(variables, jnp.asarray(prev, jnp.bfloat16), jnp.asarray(cur, jnp.bfloat16))
        tm = load_from_jax(t_align.TemporalDeformable(16, use_stencil=use_stencil,
                                                      dtype=torch.bfloat16), variables)
        with torch.no_grad():
            got = tm(to_torch(prev).to(torch.bfloat16), to_torch(cur).to(torch.bfloat16))
        assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
        g, w = to_np(got.float()), np.asarray(want, np.float32)
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-2 * np.abs(w).max())
        assert np.abs(g - want32).max() <= 1.25 * np.abs(w - want32).max()


def test_shift3d_matches_reference():
    """Every stencil tap: edge replication on each axis, as JAX's pad-based
    `_shift3d`."""
    x = _rand(45, 1, 3, 4, 5, 2, 3)
    xp = t_stencil._edge_pad3d(to_torch(x))
    for t in t_stencil._TAPS:
        np.testing.assert_array_equal(to_np(t_stencil._shift3d(xp, t)),
                                      np.asarray(j_align._shift3d(jnp.asarray(x), t)))


@pytest.mark.parametrize("n", [2, 8, 10, 16, 100])
def test_linspace_matches_jitted_reference(n):
    """The deformable attention's base grid, element for element with the
    jitted jnp.linspace (torch.linspace rounds up to half the entries
    differently)."""
    want = np.asarray(jax.jit(lambda: jnp.linspace(-1, 1, n))())
    np.testing.assert_array_equal(to_np(t_stencil._linspace_pm1(n, "cpu")), want)


@pytest.mark.parametrize("T", [2, 3])
def test_temporal_fusion_matches_reference(T):
    """`before_fusion`, the t_fuse chain over the previous frames
    (newest-last), the shared `t_deform` applied twice and `t_final`."""
    C = 16
    cur = _rand(50, 1, 2, 10, 10, C)
    prevs = [_rand(51 + i, 1, 2, 10, 10, C) for i in range(T - 1)]
    jm = j_align.TemporalFusion(C, seqs=T - 1)
    jp = [jnp.asarray(p) for p in prevs]
    variables = perturbed(jm.init(jax.random.PRNGKey(3), jnp.asarray(cur), jp), 3)
    want = np.asarray(jm.apply(variables, jnp.asarray(cur), jp))
    tm = load_from_jax(t_align.TemporalFusion(C, T - 1), variables)
    assert sorted(n for n, _ in tm.named_children()) == sorted(
        ["before_fusion", "t_deform", "t_final"] + [f"t_fuse_{i}" for i in range(T - 1)])
    with torch.no_grad():
        got = to_np(tm(to_torch(cur), [to_torch(p) for p in prevs]))
    _close_scaled(got, want)


def test_alignnet_temporal_subtree_maps_strictly(tiny_graph):
    """`alignnet/temporal_fusion/...` of the JAX tree fills the port's
    AlignNet3D exactly: a stray leaf or a missing one raises."""
    g = tiny_graph(3)
    cfg = presets.veon_tiny_test(num_temporal=3)
    variables = {col: np_tree(g["params"][col]["alignnet"]) for col in ("params", "batch_stats")}
    tm = t_align.AlignNet3D(cfg.propagation, cfg.propagation.clip_proj_dim, 3)
    sd = state_dict_from_jax(tm, variables)
    assert set(sd) == set(tm.state_dict())
    assert any(k.startswith("temporal_fusion.t_fuse_1.") for k in sd)
    stray = dict(variables, params=dict(variables["params"]))
    stray["params"]["temporal_fusion"] = dict(stray["params"]["temporal_fusion"],
                                              t_fuse_2={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not consumed"):
        state_dict_from_jax(tm, stray)
    short = dict(variables, params=dict(variables["params"]))
    short["params"]["temporal_fusion"] = {k: v for k, v in variables["params"]["temporal_fusion"]
                                          .items() if k != "t_deform"}
    with pytest.raises(ValueError, match="no JAX leaf"):
        state_dict_from_jax(tm, short)


def _port(g):
    """The port's model with tiny_graph's JAX weights (every entry but the
    depth tower, which a forward from metric depth never builds in JAX) and
    its inputs as tensors."""
    model = VeonModel(presets.veon_tiny_test(num_temporal=g["cfg"].num_temporal), device="cpu")
    sd = state_dict_from_jax(model, np_tree(g["params"]), strict=False)
    missing = set(model.state_dict()) - set(sd)
    assert missing and all(k.startswith("depth.") for k in missing), sorted(missing)[:5]
    model.load_state_dict(sd, strict=False)
    metas = {k: to_torch(np.asarray(v)) for k, v in g["metas"].items()}
    return model, to_torch(np.asarray(g["imgs"])), to_torch(np.asarray(g["depth"])), metas, \
        to_torch(np.asarray(g["ovw"]))


@pytest.mark.parametrize("T", [2, 3])
def test_batched_temporal_forward_matches_reference(tiny_graph, T):
    g = tiny_graph(T)
    model, imgs, depth, metas, ovw = _port(g)
    with torch.no_grad():
        out = model(imgs, depth, metas, ovw)
    assert set(out) == set(g["out"])
    for k in OUTPUTS:
        np.testing.assert_allclose(to_np(out[k]), np.asarray(g["out"][k]), err_msg=k, **TOL)


def _frame_metas(metas, f):
    m = {k: metas[k][:, f:f + 1] for k in ("sensor2egos", "ego2globals", "intrins",
                                           "post_rots", "post_trans")}
    m["bda"] = metas["bda"]
    return m


def test_streaming_matches_batched(tiny_graph):
    """forward_early of the previous frame with its own metas, then
    forward_streaming of the current one against it == the batched F=2
    forward; the returned early_vox == forward_early of the current frame."""
    g = tiny_graph(2)
    model, imgs, depth, metas, ovw = _port(g)
    with torch.no_grad():
        vox_prev = model.forward_early(imgs[:, 1:2], depth[:, 1:2], _frame_metas(metas, 1))
        cur = dict(_frame_metas(metas, 0), lidarego2global=metas["lidarego2global"])
        out = model.forward_streaming(imgs[:, 0:1], depth[:, 0:1], cur, ovw, vox_prev[:, None],
                                      metas["prev_lidarego2global"])
        vox_cur = model.forward_early(imgs[:, 0:1], depth[:, 0:1], _frame_metas(metas, 0))
    assert set(out) == set(g["out"]) | {"early_vox"}
    for k in OUTPUTS:
        np.testing.assert_allclose(to_np(out[k]), np.asarray(g["out"][k]), err_msg=k, **TOL)
    np.testing.assert_allclose(to_np(out["early_vox"]), to_np(vox_cur), **TOL)


def test_temporal_session_rolling_parity(tiny_graph):
    """A session fed the previous frame, then the current one, reproduces the
    batched forward; reset, state and load_state; raw uint8 frames
    normalized on the device == host-normalized floats."""
    g = tiny_graph(2)
    model, imgs, depth, metas, ovw = _port(g)
    sess = TemporalSession(model, ovw, estimate_depth=False)
    assert sess.calls == 0
    m1 = dict(_frame_metas(metas, 1), lidarego2global=metas["prev_lidarego2global"][:, 0])
    sess.infer(imgs[:, 1:2], depth[:, 1:2], m1)
    saved = [t.clone() for t in sess.state()]
    m0 = dict(_frame_metas(metas, 0), lidarego2global=metas["lidarego2global"])
    te = np.random.default_rng(7).standard_normal(g["out"]["feat_occ"].shape[-1]).astype(np.float32)
    out = sess.infer(imgs[:, 0:1], depth[:, 0:1], m0, text_embed=te)
    assert sess.calls == 2
    for k in OUTPUTS:
        np.testing.assert_allclose(to_np(out[k]), np.asarray(g["out"][k]), err_msg=k, **TOL)
    want = np.asarray(j_retrieval_map(g["out"]["feat_occ"], jnp.asarray(te)))
    np.testing.assert_allclose(to_np(out["retrieval"]), want, rtol=2e-4, atol=2e-4)

    # restoring the cache after call 1 replays call 2 exactly
    sess.load_state(*saved, calls=1)
    again = sess.infer(imgs[:, 0:1], depth[:, 0:1], m0, text_embed=te)
    for k in OUTPUTS:
        np.testing.assert_array_equal(to_np(again[k]), to_np(out[k]))
    with pytest.raises(ValueError, match="vox shape"):
        sess.load_state(saved[0][:, :, :1], saved[1])

    sess.reset()
    assert sess.calls == 0
    vox, l2g = sess.state()
    assert not vox.any()
    np.testing.assert_array_equal(to_np(l2g[0, 0]), np.eye(4))

    u8 = np.random.default_rng(9).integers(0, 256, size=tuple(imgs[:, 0:1].shape)).astype(np.uint8)
    s_u8 = TemporalSession(model, ovw, estimate_depth=False, normalize=("clipsan", "depthanythingv2"))
    out_u8 = s_u8.infer(torch.from_numpy(u8), depth[:, 0:1], m0)
    out_f32 = sess.infer(to_torch(j_tf.normalize_clipsan(u8)), depth[:, 0:1], m0)
    for k in OUTPUTS + ("retrieval",):
        np.testing.assert_allclose(to_np(out_u8[k]), to_np(out_f32[k]), rtol=2e-5, atol=2e-6,
                                   err_msg=k)


@pytest.mark.parametrize("method", ["clipsan", "mmlab", "midas", "depthanythingv2"])
def test_normalize_in_graph_matches_host_normalizers(method):
    img = np.random.default_rng(11).integers(0, 256, size=(2, 5, 7, 3)).astype(np.uint8)
    want = j_tf.NORMALIZERS[method](img)
    np.testing.assert_allclose(to_np(normalize_in_graph(torch.from_numpy(img), method)), want,
                               rtol=1e-6, atol=1e-6)


def test_retrieval_map_matches_reference():
    feat = _rand(60, 1, 4, 20, 20, 16)
    te = _rand(61, 16)
    want = np.asarray(j_retrieval_map(jnp.asarray(feat), jnp.asarray(te)))
    np.testing.assert_allclose(to_np(retrieval_map(to_torch(feat), to_torch(te))), want,
                               rtol=1e-5, atol=1e-6)
    assert not to_np(retrieval_map(to_torch(feat), torch.zeros(16))).any()


def test_temporal_entry_streams_the_drive():
    """temporal_entry on the CPU: the session over the seeded drive (the
    presorted lift for each call's frame) ends where the batched forward
    over the same frames (the banded lift on every frame) ends, and serves
    the uint8 class grid."""
    cfg = presets.veon_tiny_test(num_temporal=3)
    sess, reqs = entry_mod.temporal_entry(cfg, device="cpu", frames=4)
    for r in reqs:
        out = sess.infer(r["imgs"], r["depth_imgs"], {"lidarego2global": r["lidarego2global"]})
    assert sess.calls == 4
    nx, ny, nz = cfg.grid.size
    assert out["pred"].dtype == torch.uint8 and tuple(out["pred"].shape) == (1, nx, ny, nz)
    assert int(out["pred"].max()) <= 17
    imgs, depth_imgs, metas = temporal_batch(sess.rig_metas, reqs[1:])
    with torch.no_grad():
        want = sess.model.full_forward(imgs, depth_imgs, metas, sess.ov_weight)
    for k in OUTPUTS:
        np.testing.assert_allclose(to_np(out[k]), to_np(want[k]), err_msg=k, **TOL)


def test_temporal_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry_mod.temporal_entry(presets.veon_tiny_test(num_temporal=2))
