"""The port's lift against the JAX reference on the CPU: resize ops, depth
binning, the fixed-rig rank precompute and the banded lift's rank streams
(integer-equal, on a tiny rig and at the production frustum), and the voxel
pools (the plain versions of the CUDA kernels vs the Pallas kernels in
interpret mode), forward and backward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import to_np, to_torch

from veon_tpu.configs.base import GridConfig as JGrid
from veon_tpu.lift import lss as jlss
from veon_tpu.geometry.frustum import pixel_ray_geometry as j_rays, voxel_ranks as j_voxel_ranks
from veon_tpu.ops.bev_pool import (bev_pool_pallas, bev_pool_pallas_banded,
                                   bev_pool_pallas_banded2, bev_pool_pallas_presorted_pooled)
from veon_tpu.ops.bev_pool import pooled_rank_remap as j_pooled_rank_remap
from veon_tpu.ops import resize as jres

from veon_tpu_torch.configs.base import GridConfig as TGrid
from veon_tpu_torch.lift import lss as tlss
from veon_tpu_torch.ops import bev_pool as tbp
from veon_tpu_torch.ops import resize as tres

RNG = np.random.default_rng(21)


@pytest.mark.parametrize("op,args", [
    ("resize_bilinear", ((7, 19), False)),
    ("resize_bilinear", ((7, 19), True)),
    ("resize_bicubic", ((9, 4), False)),
    ("resize_bicubic_scaled", ((6, 13), (6.1 / 5, 13.1 / 5))),
    ("resize_nearest", ((11, 4),)),
    ("adaptive_max_pool2d", ((3, 4),)),
])
def test_resize_ops_match_reference(op, args):
    x = RNG.standard_normal((2, 5, 5 if op == "resize_bicubic_scaled" else 9, 3)).astype(np.float32)
    want = np.asarray(getattr(jres, op)(jnp.asarray(x), *args))
    got = to_np(getattr(tres, op)(to_torch(x), *args))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_trilinear_matches_reference(align_corners):
    x = RNG.standard_normal((1, 2, 5, 6, 3)).astype(np.float32)
    want = np.asarray(jres.resize_trilinear(jnp.asarray(x), (4, 10, 12), align_corners))
    got = to_np(tres.resize_trilinear(to_torch(x), (4, 10, 12), align_corners))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_depth_binning_matches_reference():
    depth = RNG.uniform(0.5, 70.0, (1, 2, 16, 24)).astype(np.float32)
    depth[0, 0, :2] = 0.0  # missing depth
    d_ds = jlss.min_pool_depth(jnp.asarray(depth), 8)
    np.testing.assert_array_equal(to_np(tlss.min_pool_depth(to_torch(depth), 8)), np.asarray(d_ds))
    want = np.asarray(jlss.two_hot_depth(d_ds, JGrid()))
    got = to_np(tlss.two_hot_depth(to_torch(np.asarray(d_ds)), TGrid()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pooled_rank_remap_matches_reference():
    grid_size, ds, B = (6, 4, 4), (2, 2, 2), 2
    num_cells = B * 6 * 4 * 4
    r = np.arange(num_cells + 1, dtype=np.int32)
    want = np.asarray(j_pooled_rank_remap(jnp.asarray(r), grid_size, ds, num_cells))
    np.testing.assert_array_equal(to_np(tbp.pooled_rank_remap(to_torch(r), grid_size, ds,
                                                              num_cells)), want)


def _ring(N, radius, height, f, cx, cy):
    s2e = np.tile(np.eye(4, dtype=np.float32), (1, N, 1, 1))
    for n in range(N):
        th = 2 * np.pi * n / N
        c, s = np.cos(th), np.sin(th)
        s2e[:, n, :3, :3] = (np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
                             @ np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32))
        s2e[:, n, :3, 3] = (radius * c, radius * s, height)
    K = np.tile(np.eye(3, dtype=np.float32), (1, N, 1, 1))
    K[:, :, 0, 0] = K[:, :, 1, 1] = f
    K[:, :, 0, 2], K[:, :, 1, 2] = cx, cy
    return (s2e, K, np.tile(np.eye(3, dtype=np.float32), (1, N, 1, 1)),
            np.zeros((1, N, 3), np.float32), np.eye(3, dtype=np.float32)[None])


# tiny: the rig of tests/test_bev_pool_pallas.py's fused-gradient test;
# production: the frustum of test_presorted_production_geometry_exact
RIGS = {
    "tiny": (dict(x=(-8.0, 8.0, 1.0), y=(-8.0, 8.0, 1.0), z=(-1.0, 3.0, 1.0),
                  depth=(1.0, 9.0, 0.5)), (32, 64), 8, _ring(3, 0.3, 1.0, 40.0, 32.0, 16.0)),
    "production": ({}, (512, 1408), 16, _ring(6, 0.5, 1.5, 560.0, 704.0, 256.0)),
}


@pytest.fixture(scope="module", params=sorted(RIGS))
def rig(request):
    grid_kw, input_size, ds, args = RIGS[request.param]
    jlift = jlss.LSSLift(grid=JGrid(**grid_kw), input_size=input_size, downsample=ds,
                         out_channels=2, ds_feat=(2, 2, 2))
    tlift = tlss.LSSLift(grid=TGrid(**grid_kw), input_size=input_size, downsample=ds,
                         ds_feat=(2, 2, 2))
    want = jlift.precompute_sorted(*map(jnp.asarray, args))
    got = tlift.precompute_sorted(*map(to_torch, args))
    return request.param, jlift, tlift, want, got


@pytest.mark.parametrize("key", ["order", "rk_pooled", "ranks"])
def test_rig_precompute_integer_equal(rig, key):
    _, _, _, want, got = rig
    assert got[key].dtype == torch.int32
    np.testing.assert_array_equal(to_np(got[key]), np.asarray(want[key]))


def test_prefix_holds_every_in_grid_point(rig):
    _, jlift, tlift, _, got = rig
    num_cells = int(np.prod(tlift.grid.size))
    n_valid = int((got["ranks"] < num_cells).sum())
    p_cap = got["order"].shape[0]
    assert p_cap == min(-(-n_valid // tlss.PREFIX_ROUND) * tlss.PREFIX_ROUND, got["ranks"].numel())
    assert int((got["rk_pooled"] < num_cells).sum()) == n_valid


def test_pool_plain_matches_pallas_kernel(rig):
    """The CUDA kernel's plain version (the CPU path of the wrapper, gather
    included) vs the Pallas kernel run in interpret mode, at 1e-5 (fp32 sums
    in another order): through the lift, and the wrapper called directly."""
    _, jlift, tlift, want_pre, got_pre = rig
    C = 2
    B, N = got_pre["ranks"].shape[:2]
    hf, wf = jlift.input_size[0] // jlift.downsample, jlift.input_size[1] // jlift.downsample
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((B, N, hf, wf, C)).astype(np.float32)
    metric = rng.uniform(1.2, 60.0, (B, N, hf, wf)).astype(np.float32)
    dist = np.asarray(jlss.two_hot_depth(jnp.asarray(metric), jlift.grid))
    want = np.asarray(jlift.lift_presorted(jnp.asarray(feat), jnp.asarray(dist), want_pre))
    got = to_np(tlift.lift_presorted(to_torch(feat), to_torch(dist), got_pre))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    num_cells = B * int(np.prod(tlift.grid.size))
    direct = tbp.bev_pool_pooled(to_torch(dist), to_torch(feat), got_pre["order"],
                                 got_pre["rk_pooled"], num_cells, 8)
    np.testing.assert_array_equal(to_np(direct), got.reshape(-1, C))
    assert tbp.bev_pool_pooled.launches == 0  # the plain path launches nothing


def _bf16_ulp(x):
    """One bf16 ulp at each value of x (fp32 numpy)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_wrapper_matches_pallas_op(dtype):
    """The pooled pool's wrapper on CPU tensors (gather + plain pool) vs the
    JAX op `bev_pool_pallas_presorted_pooled` (Pallas in interpret mode) on
    the tiny rig, with the sliced softmax view of `two_hot_depth` as the
    weights. fp32 at 1e-5; bf16 (products rounded once to bf16, fp32 sums,
    one cast) within one bf16 ulp of the fp32 sum of the same bf16
    products, for the port and for JAX. The non-contiguous view gives what
    its contiguous copy gives."""
    grid_kw, input_size, ds, args = RIGS["tiny"]
    jgrid, tgrid = JGrid(**grid_kw), TGrid(**grid_kw)
    jlift = jlss.LSSLift(grid=jgrid, input_size=input_size, downsample=ds, out_channels=16)
    tlift = tlss.LSSLift(grid=tgrid, input_size=input_size, downsample=ds)
    want_pre = jlift.precompute_sorted(*map(jnp.asarray, args))
    pre = tlift.precompute_sorted(*map(to_torch, args))
    B, N = pre["ranks"].shape[:2]
    hf, wf = input_size[0] // ds, input_size[1] // ds
    rng = np.random.default_rng(9)
    feat = rng.standard_normal((B, N, hf, wf, 16)).astype(np.float32)
    metric = rng.uniform(1.2, 9.0, (B, N, hf, wf)).astype(np.float32)
    tdt = getattr(torch, dtype)
    depth = tlss.two_hot_depth(to_torch(metric), tgrid).to(tdt)
    if dtype == "float32":
        assert not depth.is_contiguous()  # the sliced softmax view
    f = to_torch(feat).to(tdt)
    num_cells = B * int(np.prod(tgrid.size))
    got = tbp.bev_pool_pooled(depth, f, pre["order"], pre["rk_pooled"], num_cells, 8)
    assert got.dtype == tdt and tuple(got.shape) == (num_cells // 8, 16)
    torch.testing.assert_close(got, tbp.bev_pool_pooled(depth.contiguous(), f, pre["order"],
                                                        pre["rk_pooled"], num_cells, 8),
                               rtol=0, atol=0)
    jd = jnp.asarray(depth.float().numpy()).astype(dtype)
    want = np.asarray(bev_pool_pallas_presorted_pooled(
        jd, jnp.asarray(f.float().numpy()).astype(dtype), want_pre["order"],
        want_pre["rk_pooled"], want_pre["ranks"], jgrid.size, (2, 2, 2)).astype(jnp.float32))
    got = to_np(got.float()).reshape(want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    ref32 = to_np(tbp.bev_pool_pooled_plain(tbp.presorted_vals(depth, f, pre["order"]),
                                            pre["rk_pooled"], num_cells, 8, torch.float32))
    ref32 = ref32.reshape(want.shape)
    for name, out in (("port", got), ("jax", want)):
        over = np.abs(out - ref32) - (_bf16_ulp(np.maximum(np.abs(out), np.abs(ref32)))
                                      + 1e-5 + 1e-5 * np.abs(ref32))
        assert over.max() <= 0, f"{name} bf16 off by more than one ulp: {over.max()}"
    assert np.abs(ref32).max() > 0.1  # the rig puts mass in the grid


def _grads(fn, args, argnums, cot):
    """d sum(fn(*args) * cot) / d args[i] for i in argnums, JAX side."""
    return jax.grad(lambda *a: jnp.sum(fn(*a) * cot), argnums=argnums)(*map(jnp.asarray, args))


def _torch_grads(fn, args, argnums, cot):
    ts = [to_torch(np.asarray(a)).requires_grad_(i in argnums) if np.asarray(a).dtype == np.float32
          else to_torch(np.asarray(a)) for i, a in enumerate(args)]
    out = fn(*ts)
    out.backward(to_torch(cot))
    return out, [ts[i].grad for i in argnums]


def test_pooled_backward_matches_reference():
    """bev_pool_presorted_pooled's backward (fine grid recomputed by the
    one-stream pool, cotangent through the group max with ties split
    evenly, gather adjoints) vs the JAX custom VJP on the tiny rig, whose
    sparse fine grid has many zero ties. fp32, 1e-5."""
    grid_kw, input_size, ds, args = RIGS["tiny"]
    jlift = jlss.LSSLift(grid=JGrid(**grid_kw), input_size=input_size, downsample=ds,
                         out_channels=3, ds_feat=(2, 2, 2))
    tlift = tlss.LSSLift(grid=TGrid(**grid_kw), input_size=input_size, downsample=ds)
    want_pre = jlift.precompute_sorted(*map(jnp.asarray, args))
    got_pre = tlift.precompute_sorted(*map(to_torch, args))
    B, N, D = got_pre["ranks"].shape[:3]
    hf, wf = input_size[0] // ds, input_size[1] // ds
    rng = np.random.default_rng(6)
    feat = rng.standard_normal((B, N, hf, wf, 3)).astype(np.float32)
    dist = np.asarray(jlss.two_hot_depth(jnp.asarray(
        rng.uniform(1.2, 9.0, (B, N, hf, wf)).astype(np.float32)), jlift.grid))
    nx, ny, nz = jlift.grid.size
    cot = rng.standard_normal((B, nz // 2, ny // 2, nx // 2, 3)).astype(np.float32)
    want = _grads(lambda d, f: jlift.lift_presorted(f, d, want_pre), (dist, feat), (0, 1), cot)
    _, got = _torch_grads(lambda d, f: tlift.lift_presorted(f, d, got_pre), (dist, feat), (0, 1),
                          cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)


def _pool_case(B, N, D, h, w, C, grid_size, seed, K2=None):
    """Random weights, features and ranks (half of them overflow)."""
    rng = np.random.default_rng(seed)
    V = B * int(np.prod(grid_size))

    def ranks(shape):
        r = rng.integers(0, V, size=shape).astype(np.int32)
        r[rng.random(shape) > 0.5] = V
        return r

    wts = rng.random((B, N, D, h, w)).astype(np.float32)
    feat = rng.standard_normal((B, N, h, w, C)).astype(np.float32)
    out = [wts, feat, ranks(wts.shape)]
    if K2 is not None:
        out += [rng.random((B, N, h, w, K2)).astype(np.float32), ranks((B, N, h, w, K2))]
    return out


# small: far below one TPU cell block; multiblock: 2170 cells, 5 blocks,
# not a multiple of the block (tests/test_bev_pool_pallas.py's cases)
POOL_CASES = {"small": ((1, 2, 4, 3, 5, 8), (10, 10, 2)),
              "multiblock": ((2, 3, 6, 4, 9, 16), (31, 7, 5))}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
@pytest.mark.parametrize("op", ["full", "banded", "banded2"])
def test_sorted_pools_match_pallas(op, case):
    """The sorted-stream pools (plain versions of kernels #2 and #3) vs
    bev_pool_pallas / _banded / _banded2 in interpret mode: forward at 1e-5
    (fp32 sums in another order), and the VJP w.r.t. every weight stream
    and the features at 1e-5 (the same gather adjoints)."""
    shape, grid_size = POOL_CASES[case]
    arrs = _pool_case(*shape, grid_size, seed=len(op) + len(case), K2=5 if op == "banded2" else None)
    if op == "full":
        jfn = lambda d, f, r: bev_pool_pallas(d, f, r, grid_size)  # noqa: E731
        tfn = lambda d, f, r: tbp.bev_pool(d, f, r, grid_size)  # noqa: E731
        wrt = (0, 1)
    else:
        # pixel-major (B, N, h, w, K) streams
        arrs[0], arrs[2] = arrs[0].transpose(0, 1, 3, 4, 2).copy(), arrs[2].transpose(0, 1, 3, 4, 2).copy()
        if op == "banded":
            jfn = lambda w, f, r: bev_pool_pallas_banded(w, f, r, grid_size)  # noqa: E731
            tfn = lambda w, f, r: tbp.bev_pool_banded(w, f, r, grid_size)  # noqa: E731
            wrt = (0, 1)
        else:
            jfn = lambda w, f, r, w2, r2: bev_pool_pallas_banded2(  # noqa: E731
                w, f, r, w2, r2, grid_size)
            tfn = lambda w, f, r, w2, r2: tbp.bev_pool_banded2(  # noqa: E731
                w, f, r, w2, r2, grid_size)
            wrt = (0, 1, 3)
    jargs = tuple(map(jnp.asarray, arrs))
    want = np.asarray(jfn(*jargs))
    cot = np.random.default_rng(3).standard_normal(want.shape).astype(np.float32)
    got, grads = _torch_grads(tfn, arrs, wrt, cot)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=1e-5)
    for g, w in zip(grads, _grads(jfn, jargs, wrt, cot)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)


def _jax_banded_streams(jlift, metric, *metas):
    """The point streams `veon_tpu` LSSLift.lift_from_metric builds inside
    the train step's jit (the same lines, returned instead of pooled)."""
    D = jlift.grid.num_depth_bins
    d0, _, dd = jlift.grid.depth
    w, bins, floor = jlss.banded_two_hot_with_floor(metric, jlift.grid, jlift.band_k)
    dirs, origin = j_rays(jlift.input_size, jlift.downsample, *metas)

    def ranks_at(dv):
        coor = dv[..., None] * dirs[:, :, :, :, None, :] + origin[:, :, None, None, None, :]
        return j_voxel_ranks(coor, jlift.grid)[0]

    num_cells = metric.shape[0] * int(np.prod(jlift.grid.size))
    ranks = jnp.where(bins >= D, num_cells, ranks_at(bins.astype(jnp.float32) * dd + d0))
    spray_px = floor >= jlift.spray_eps
    shape = metric.shape + (D,)
    ranks_f = ranks_at(jnp.broadcast_to(jnp.arange(D, dtype=jnp.float32) * dd + d0, shape))
    spray = jnp.where(spray_px, floor, 0.0)[..., None]
    return (w - spray, ranks, jnp.broadcast_to(spray, shape),
            jnp.where(spray_px[..., None], ranks_f, num_cells))


@pytest.fixture(scope="module", params=sorted(RIGS))
def banded_streams(request):
    """Both rigs with 0.5 m depth bins to 45 m, so K=17 < D+1 and the far
    spray runs; metric depths U(1.5, 59.5) m put pixels past the spray
    threshold. Returns (want, got) stream tuples."""
    grid_kw, input_size, ds, args = RIGS[request.param]
    grid_kw = dict(grid_kw, depth=(1.0, 45.0, 0.5))
    jlift = jlss.LSSLift(grid=JGrid(**grid_kw), input_size=input_size, downsample=ds,
                         out_channels=2)
    tlift = tlss.LSSLift(grid=TGrid(**grid_kw), input_size=input_size, downsample=ds)
    B, N = args[0].shape[:2]
    metric = np.random.default_rng(5).uniform(
        1.5, 59.5, (B, N, input_size[0] // ds, input_size[1] // ds)).astype(np.float32)
    want = jax.jit(_jax_banded_streams, static_argnums=0)(jlift, jnp.asarray(metric),
                                                          *map(jnp.asarray, args))
    got = tlift.banded_streams(to_torch(metric), *map(to_torch, args))
    return [np.asarray(a) for a in want], [to_np(t) for t in got]


@pytest.mark.parametrize("stream", ["main", "spray"])
def test_banded_lift_ranks_integer_equal(banded_streams, stream):
    """Both rank streams of the banded lift equal JAX's integer for integer
    (one point binned across a cell face would move its row of mass), and
    the spray carries in-grid points."""
    want, got = banded_streams
    i = 1 if stream == "main" else 3
    assert got[i].dtype == np.int32
    np.testing.assert_array_equal(got[i], want[i])
    assert (got[i] < got[i].max()).any()


def test_banded_lift_weights_match(banded_streams):
    """Main and spray weights at 1e-6 (fp32 exp and sums)."""
    want, got = banded_streams
    for i in (0, 2):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("depth_bins", [(1.0, 45.0, 0.5), (1.0, 45.0, 5.5)])
def test_banded_two_hot_matches_reference(depth_bins):
    """banded_two_hot_with_floor: bins integer-equal (jnp.round and
    torch.round both round half to even), weights and floor at 1e-6, at the
    production bins and the tiny preset's, with depths in range, below d0,
    past d1 and on bin centers and edges."""
    grid_kw = dict(x=(-40, 40, 8.0), y=(-40, 40, 8.0), z=(-1, 3, 1.0), depth=depth_bins)
    rng = np.random.default_rng(11)
    depth = np.concatenate([
        rng.uniform(0.5, 70.0, size=(1, 1, 3, 13)),
        np.array([0.3, 1.0, 4.9, 44.9, 45.3, 60.0, 80.0, 2.501, 42.499,
                  47.0, 48.9, 49.25, 3.75]).reshape(1, 1, 1, 13)], axis=2).astype(np.float32)
    fn = jax.jit(lambda d: jlss.banded_two_hot_with_floor(d, JGrid(**grid_kw), 17))
    want = [np.asarray(a) for a in fn(jnp.asarray(depth))]
    got = [to_np(t) for t in tlss.banded_two_hot_with_floor(to_torch(depth), TGrid(**grid_kw), 17)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-12)
    w, bins = tlss.banded_two_hot(to_torch(depth), TGrid(**grid_kw), 17)
    np.testing.assert_array_equal(to_np(w), got[0])
    np.testing.assert_array_equal(to_np(bins), got[1])


def _aug_rig():
    """tests/test_geometry_lift.py's banded-lift rig: three ringed pinhole
    cameras with a mild image augmentation, a coarse grid, 0.5 m bins."""
    B, N = 1, 3
    s2e = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    for n in range(N):
        th = 2 * np.pi * n / N
        c, s = np.cos(th), np.sin(th)
        s2e[:, n, :3, :3] = (np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
                             @ np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32))
        s2e[:, n, :3, 3] = (0.5 * c, 0.5 * s, 1.5)
    K = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    K[..., 0, 0] = K[..., 1, 1] = 10.0
    K[..., 0, 2], K[..., 1, 2] = 8.0, 4.0
    post_rot = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    post_rot[:, :, :2, :2] *= 0.5
    rng = np.random.default_rng(13)
    post_tran = np.zeros((B, N, 3), np.float32)
    post_tran[:, :, :2] = rng.normal(0, 1, size=(B, N, 2)).astype(np.float32)
    grid_kw = dict(x=(-40, 40, 8.0), y=(-40, 40, 8.0), z=(-1, 3, 1.0), depth=(1.0, 45.0, 0.5))
    feat = rng.standard_normal((B, N, 4, 8, 5)).astype(np.float32)
    metric = rng.uniform(1.5, 55.0, size=(B, N, 4, 8)).astype(np.float32)
    return grid_kw, (s2e, K, post_rot, post_tran, np.eye(3, dtype=np.float32)[None]), feat, metric


@pytest.mark.parametrize("ds_feat", [(1, 1, 1), (2, 2, 2)])
def test_lift_from_metric_matches_reference(ds_feat):
    """lift_from_metric vs JAX (jitted, as in the train step) at 1e-5, and
    its gradient w.r.t. the features at 1e-5; vs the port's own full-frustum
    lift at 1e-4 (tests/test_geometry_lift.py's tolerance: the banded form
    drops floors below spray_eps); without the spray the far mass is lost."""
    grid_kw, metas, feat, metric = _aug_rig()
    jlift = jlss.LSSLift(grid=JGrid(**grid_kw), input_size=(16, 32), downsample=4,
                         out_channels=5, ds_feat=ds_feat)
    tlift = tlss.LSSLift(grid=TGrid(**grid_kw), input_size=(16, 32), downsample=4,
                         ds_feat=ds_feat)
    jm = tuple(map(jnp.asarray, metas))
    jfn = jax.jit(lambda f, m: jlift.lift_from_metric(f, m, *jm))
    want = np.asarray(jfn(jnp.asarray(feat), jnp.asarray(metric)))
    cot = np.random.default_rng(2).standard_normal(want.shape).astype(np.float32)
    tm = tuple(map(to_torch, metas))
    got, (g_feat,) = _torch_grads(lambda f, m: tlift.lift_from_metric(f, m, *tm),
                                  (feat, metric), (0,), cot)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5, atol=1e-5)
    (want_g,) = _grads(jfn, (jnp.asarray(feat), jnp.asarray(metric)), (0,), cot)
    np.testing.assert_allclose(to_np(g_feat), np.asarray(want_g), rtol=1e-5, atol=1e-5)
    full = to_np(tlift(to_torch(feat), tlss.two_hot_depth(to_torch(metric), tlift.grid), *tm))
    np.testing.assert_allclose(to_np(got), full, rtol=1e-4, atol=1e-5)
    no_spray = dataclasses.replace(tlift, far_spray=False)
    assert np.abs(to_np(no_spray.lift_from_metric(to_torch(feat), to_torch(metric), *tm))
                  - full).max() > 1e-3


def test_lift_from_metric_rejects_a_narrow_band():
    grid_kw, metas, feat, metric = _aug_rig()
    lift = tlss.LSSLift(grid=TGrid(**grid_kw), input_size=(16, 32), downsample=4, band_k=9)
    with pytest.raises(ValueError, match="too narrow"):
        lift.lift_from_metric(to_torch(feat), to_torch(metric), *map(to_torch, metas))


def test_sorted_pool_wrappers_are_plain_on_cpu():
    """On CPU tensors the kernel wrappers run their plain versions and
    launch nothing; the plain version sums both streams per cell and drops
    overflow rows."""
    rng = np.random.default_rng(8)
    v1, v2 = (torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32)) for n in (30, 20))
    r1, r2 = (torch.from_numpy(np.sort(rng.integers(0, 12, n)).astype(np.int32)) for n in (30, 20))
    want = np.zeros((11, 4), np.float32)
    np.add.at(want, np.minimum(r1.numpy(), 10), v1.numpy())
    np.add.at(want, np.minimum(r2.numpy(), 10), v2.numpy())
    np.testing.assert_allclose(tbp.bev_pool_sorted2(v1, r1, v2, r2, 10).numpy(), want[:10],
                               rtol=1e-6, atol=1e-6)
    one = np.zeros((11, 4), np.float32)
    np.add.at(one, np.minimum(r1.numpy(), 10), v1.numpy())
    np.testing.assert_allclose(tbp.bev_pool_sorted(v1, r1, 10).numpy(), one[:10],
                               rtol=1e-6, atol=1e-6)
    assert tbp.bev_pool_sorted.launches == 0 and tbp.bev_pool_sorted2.launches == 0


def test_pool_wrapper_is_forward_only_and_plain_on_cpu():
    """On CPU tensors the pooled wrapper gathers and weights the sorted rows
    (`presorted_vals`) and runs the plain pool, launching nothing: the max
    over fine-cell sums, empty cells counting as 0, overflow rows dropped.
    It is forward-only and takes depth and feat of one dtype."""
    rng = np.random.default_rng(2)
    B, N, D, h, w, C = 1, 2, 5, 2, 2, 8
    depth = torch.from_numpy(rng.random((B, N, D, h, w)).astype(np.float32))
    feat = torch.from_numpy(rng.standard_normal((B, N, h, w, C)).astype(np.float32))
    ranks = rng.integers(0, 70, B * N * h * w * D).astype(np.int32)  # >= 64 overflow
    order = torch.from_numpy(np.argsort(ranks, kind="stable").astype(np.int32))
    rk = torch.from_numpy(ranks[order.numpy()])
    out = tbp.bev_pool_pooled(depth, feat, order, rk, 64, 8)
    vals = tbp.presorted_vals(depth, feat, order)
    torch.testing.assert_close(out, tbp.bev_pool_pooled_plain(vals, rk, 64, 8, torch.float32))
    # direct check of the contract: max over fine-cell sums, empty cells count as 0
    wts = depth.permute(0, 1, 3, 4, 2).reshape(-1).numpy()
    rows = feat.reshape(-1, C).numpy()[order.numpy() // D] * wts[order.numpy()][:, None]
    want = np.zeros((65, C), np.float32)
    np.add.at(want, np.minimum(rk.numpy(), 64), rows)
    want = want[:64].reshape(8, 8, C).max(1)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    assert tbp.bev_pool_pooled.launches == 0  # the plain path launches nothing
    with pytest.raises(NotImplementedError, match="forward-only"):
        tbp.bev_pool_pooled(depth.clone().requires_grad_(), feat, order, rk, 64, 8)
    with pytest.raises(TypeError, match="one dtype"):
        tbp.bev_pool_pooled(depth.to(torch.bfloat16), feat, order, rk, 64, 8)
