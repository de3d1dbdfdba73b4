"""The port's lift against the JAX reference on the CPU: resize ops, depth
binning, the fixed-rig rank precompute (integer-equal, on a tiny rig and at
the production frustum) and the presorted pooled voxel pool (the plain
version of the CUDA kernel vs the Pallas kernel in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import to_np, to_torch

from veon_tpu.configs.base import GridConfig as JGrid
from veon_tpu.lift import lss as jlss
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
    """The CUDA kernel's plain version (the CPU path of the wrapper) vs the
    Pallas kernel run in interpret mode, at 1e-5 (fp32 sums in another order)."""
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


def test_pool_wrapper_is_forward_only_and_plain_on_cpu():
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    rk = torch.from_numpy(np.sort(rng.integers(0, 70, 40)).astype(np.int32))  # >= 64 overflow
    out = tbp.bev_pool_pooled(vals, rk, 64, 8, torch.float32)
    torch.testing.assert_close(out, tbp.bev_pool_pooled_plain(vals, rk, 64, 8, torch.float32))
    # direct check of the contract: max over fine-cell sums, empty cells count as 0
    want = np.zeros((65, 8), np.float32)
    np.add.at(want, np.minimum(rk.numpy(), 64), vals.numpy())
    want = want[:64].reshape(8, 8, 8).max(1)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    assert tbp.bev_pool_pooled.launches == 0  # the plain path launches nothing
    with pytest.raises(NotImplementedError, match="forward-only"):
        tbp.bev_pool_pooled(vals.requires_grad_(), rk, 64, 8, torch.float32)
