"""The port's host data plane (`veon_tpu_torch/data/`) against the JAX
package's, on the synthetic nuScenes fixture of `test_data_pipeline.py`
and the raw tables of `test_vis_infos.py`, at the tiny input size.

Everything here is host numpy and PIL on both sides, so the expected
result is equality: transforms, LiDAR depth GT, samples of both datasets
(train and eval, T=1 and T=2, raw uint8, LiDAR depth, the depth cache in
`.npy` and the reference's `.tensor`, the BDA flip, the rot/scale
refusal), the loader's order, sharding and process mode, the retrieval CSV
and `create_infos`. The one tolerance: the native C++ depth projection
against the numpy one, 1e-6 (a float32 matrix product's rounding)."""

import dataclasses
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_data_pipeline import _make_fixture
from test_retrieval_cli import _write_retrieval_fixture
from test_torch_common import REPO  # noqa: F401  (sets torch to one thread)
from test_vis_infos import _write_tables

from veon_tpu.configs.base import DataConfig as JDataConfig, GridConfig as JGridConfig
from veon_tpu.data import create_infos as jci, depth_gt as jdg, loader as jld
from veon_tpu.data import native as jnative, nuscenes as jns, transforms as jT
from veon_tpu.geometry.frustum import voxel_ranks as jvoxel_ranks
from veon_tpu_torch.configs.base import DataConfig, GridConfig
from veon_tpu_torch.data import create_infos as pci, depth_gt as pdg, loader as pld
from veon_tpu_torch.data import native as pnative, nuscenes as pns, transforms as pT

TINY_GRID = dict(x=(-40.0, 40.0, 4.0), y=(-40.0, 40.0, 4.0), z=(-1.0, 5.4, 1.6),
                 depth=(1.0, 45.0, 5.5))
TINY_DATA = dict(input_size=(64, 176), depth_input_size=(32, 88), src_size=(90, 160))


def _cfgs(**data):
    """(JAX, port) data and grid configs of the fixture's tiny size."""
    return ((JDataConfig(**TINY_DATA, **data), JGridConfig(**TINY_GRID)),
            (DataConfig(**TINY_DATA, **data), GridConfig(**TINY_GRID)))


def assert_same(got, want, path="sample"):
    """Equal trees: same keys, types, dtypes, shapes and values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, path


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    return root, _make_fixture(root)


# ----------------------------------------------------------------- transforms


def test_normalizers_equal_reference():
    u8 = np.random.default_rng(0).integers(0, 256, size=(2, 8, 10, 3)).astype(np.uint8)
    assert pT.NORMALIZERS.keys() == jT.NORMALIZERS.keys()
    for m in jT.NORMALIZERS:
        got, want = pT.NORMALIZERS[m](u8), jT.NORMALIZERS[m](u8)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=m)
        # the device normalizer of the same table, on the CPU, bit-equal too
        np.testing.assert_array_equal(pT.normalize_in_graph(torch.from_numpy(u8), m).numpy(),
                                      want, err_msg=m)


def test_geometry_helpers_equal_reference():
    rng = np.random.default_rng(1)
    for _ in range(5):
        q, t = rng.normal(size=4), rng.normal(size=3) * 10
        np.testing.assert_array_equal(pT.quaternion_matrix(q), jT.quaternion_matrix(q))
        np.testing.assert_array_equal(pT.se3(q, t), jT.se3(q, t))
    for rot, scale, fdx, fdy in ((0.0, 1.0, False, False), (7.5, 1.05, True, False),
                                 (-22.0, 0.95, True, True)):
        np.testing.assert_array_equal(pT.bda_matrix(rot, scale, fdx, fdy),
                                      jT.bda_matrix(rot, scale, fdx, fdy))


def test_image_augmentation_equals_reference():
    """sample_augmentation with the same generator state (train with every
    range on, and test), its homography, and the PIL images it makes."""
    from PIL import Image

    (jcfg, _), (pcfg, _) = _cfgs(resize=(-0.06, 0.11), rot=(-5.4, 5.4), flip=True,
                                 crop_h=(0.0, 0.1), resize_test=0.02)
    img = Image.fromarray(np.random.default_rng(2).integers(0, 255, (90, 160, 3), np.uint8))
    for is_train in (True, False):
        jrng, prng = np.random.default_rng((3, 1)), np.random.default_rng((3, 1))
        for _ in range(6):
            want = jT.sample_augmentation(jcfg, (90, 160), is_train=is_train, rng=jrng)
            got = pT.sample_augmentation(pcfg, (90, 160), is_train=is_train, rng=prng)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            for g, w in zip(pT.aug_homography(got), jT.aug_homography(want)):
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(np.asarray(pT.apply_image_aug(img, got)),
                                          np.asarray(jT.apply_image_aug(img, want)))


def test_bda_sampling_and_gt_flip_equal_reference():
    (jcfg, _), (pcfg, _) = _cfgs(bda_rot_lim=(-22.5, 22.5), bda_scale_lim=(0.95, 1.05),
                                 bda_flip_dx_ratio=0.5, bda_flip_dy_ratio=0.5)
    jrng, prng = np.random.default_rng(4), np.random.default_rng(4)
    for is_train in (True, True, True, False):
        assert (pT.sample_bda_augmentation(pcfg, is_train, prng)
                == jT.sample_bda_augmentation(jcfg, is_train, jrng))
    rng = np.random.default_rng(5)
    base = {k: rng.integers(0, 18, size=(5, 6, 3)).astype(np.int32)
            for k in ("voxel_semantics", "mask_lidar", "mask_camera")}
    for fdx in (False, True):
        for fdy in (False, True):
            got, want = dict(base), dict(base)
            pT.flip_occ_gt(got, fdx, fdy)
            jT.flip_occ_gt(want, fdx, fdy)
            assert_same(got, want)
            assert all(v.flags["C_CONTIGUOUS"] for v in got.values())


# ------------------------------------------------------------------ depth GT


def _rig(rng, N=3):
    """N cameras' lidar2img = K @ [R | t] with a focal length of 30 px: the
    depth row is a unit rotation row, as in a real rig."""
    l2i = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    K = np.diag([30.0, 30.0, 1.0]).astype(np.float32)
    for n in range(N):
        th = n * 2.0
        l2i[n, :3, :3] = K @ np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                                       [-np.sin(th), 0, np.cos(th)]], np.float32)
        l2i[n, 0, 3], l2i[n, 1, 3] = 80.0, 30.0
    post_rots = np.tile(np.eye(3, dtype=np.float32) * 0.5, (N, 1, 1))
    post_rots[:, 2, 2] = 1.0
    post_trans = rng.normal(0, 2, size=(N, 3)).astype(np.float32)
    post_trans[:, 2] = 0
    return l2i, post_rots, post_trans


def test_depth_gt_equals_reference():
    rng = np.random.default_rng(6)
    grid = GridConfig()
    jgrid = JGridConfig()
    pts = rng.uniform(-50, 50, size=(3000, 3)).astype(np.float32)
    l2i, post_rots, post_trans = _rig(rng)
    for n in range(3):
        got = pdg.project_points(pts, l2i[n], post_rots[n], post_trans[n])
        want = jdg.project_points(pts, l2i[n], post_rots[n], post_trans[n])
        np.testing.assert_array_equal(got, want)
        for ds in (1, 4):
            np.testing.assert_array_equal(pdg.points_to_depth_map(got, 64, 176, grid, ds),
                                          jdg.points_to_depth_map(want, 64, 176, jgrid, ds))
    # downsample 4 takes the numpy path on both sides
    np.testing.assert_array_equal(
        pdg.points_to_multiview_depth(pts, l2i, post_rots, post_trans, 64, 176, grid, 4),
        jdg.points_to_multiview_depth(pts, l2i, post_rots, post_trans, 64, 176, jgrid, 4))
    mats = [rng.normal(size=(4, 4)).astype(np.float32) for _ in range(2)] + [
        rng.normal(size=(3, 4, 4)).astype(np.float32) for _ in range(2)] + [
        np.tile(np.eye(3, dtype=np.float32) * 100, (3, 1, 1))]
    for m in mats[:4]:
        m[..., 3, :] = (0, 0, 0, 1)
    np.testing.assert_array_equal(pdg.lidar2img_matrices(*mats), jdg.lidar2img_matrices(*mats))
    small = GridConfig(x=(-4, 4, 2), y=(-4, 4, 2), z=(-1, 3, 2), depth=(1.0, 9.0, 1.0))
    jsmall = JGridConfig(x=(-4, 4, 2), y=(-4, 4, 2), z=(-1, 3, 2), depth=(1.0, 9.0, 1.0))
    p = rng.uniform(-5, 5, size=(400, 3)).astype(np.float32)
    l2e = jT.se3([0.99, 0.0, 0.0, 0.14], [0.1, 0.0, 1.8])
    np.testing.assert_array_equal(pdg.points_to_pseudo_mask(p, l2e, small),
                                  jdg.points_to_pseudo_mask(p, l2e, jsmall))
    np.testing.assert_array_equal(pdg.points_to_voxel_indices(p, l2e, small),
                                  jdg.points_to_voxel_indices(p, l2e, jsmall))


def test_native_matches_numpy_and_reference():
    """The port's build of its own copy of depth_proj.cpp: the depth maps
    within 1e-6 of the numpy projection (float32 rounding of the matrix
    product), equal to the JAX package's build, and the voxel ranks equal
    to the reference's eager `voxel_ranks`."""
    assert pnative.available(), "g++ is present here: the library must build"
    assert pnative.library_path().parent.name == "veon_tpu_torch"
    rng = np.random.default_rng(0)
    grid = GridConfig()
    pts = rng.uniform(-50, 50, size=(5000, 3)).astype(np.float32)
    l2i, post_rots, post_trans = _rig(rng)
    got = pnative.points_to_depth_native(pts, l2i, post_rots, post_trans, (64, 176),
                                         grid.depth[:2])
    for n in range(3):
        uvd = pdg.project_points(pts, l2i[n], post_rots[n], post_trans[n])
        np.testing.assert_allclose(got[n], pdg.points_to_depth_map(uvd, 64, 176, grid),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got, jnative.points_to_depth_native(
        pts, l2i, post_rots, post_trans, (64, 176), grid.depth[:2]))
    coor = rng.uniform(-50, 50, size=(2, 2, 3, 4, 5, 3)).astype(np.float32)  # (B, N, D, H, W, 3)
    # the eager JAX function divides by the interval, as the C++ does (the
    # jitted graph and the port's `voxel_ranks` multiply by its reciprocal)
    want, _ = jvoxel_ranks(jnp.asarray(coor), JGridConfig())
    np.testing.assert_array_equal(
        pnative.voxel_ranks_native(coor, grid.lower_bound, grid.interval, grid.size),
        np.asarray(want))


def test_native_jpeg_open_equals_pil(tmp_path):
    from PIL import Image

    p = str(tmp_path / "cam.jpg")
    want = np.random.default_rng(0).integers(0, 255, size=(45, 67, 3), dtype=np.uint8)
    Image.fromarray(want).save(p, quality=90)
    np.testing.assert_array_equal(np.asarray(pnative.open_image_native(p)),
                                  np.asarray(Image.open(p).convert("RGB")))


# ------------------------------------------------------------------ datasets


def _datasets(cls_j, cls_p, pkl, root, data=None, **kw):
    (jcfg, jgrid), (pcfg, pgrid) = _cfgs(**(data or {}))
    return (cls_j(infos=jns.load_infos(pkl), data_cfg=jcfg, grid=jgrid, data_root=root, **kw),
            cls_p(infos=pns.load_infos(pkl), data_cfg=pcfg, grid=pgrid, data_root=root, **kw))


@pytest.mark.parametrize("case", [
    dict(),  # eval, T=1, LiDAR depth, occ GT
    dict(num_temporal=2),  # index 2 starts a new scene: the adjacent fallback
    dict(num_temporal=2, raw_uint8=True),
    dict(is_train=True, seed=3, data=dict(resize=(-0.06, 0.11), rot=(-5.4, 5.4), flip=True,
                                          crop_h=(0.0, 0.1))),
    dict(is_train=True, num_temporal=2, data=dict(bda_flip_dx_ratio=1.0,
                                                  bda_flip_dy_ratio=0.5)),
], ids=["eval_t1", "eval_t2", "eval_t2_raw_uint8", "train_aug", "train_t2_bda_flip"])
def test_occ_dataset_samples_equal_reference(fixture_root, case):
    root, pkl = fixture_root
    jds, pds = _datasets(jns.NuScenesOccDataset, pns.NuScenesOccDataset, pkl, root, **case)
    assert len(pds) == len(jds) == 3
    for i in range(3):
        assert_same(pds[i], jds[i], f"sample{i}")
    if case.get("data", {}).get("bda_flip_dx_ratio"):
        assert pds[0]["metas"]["bda"][0, 0] == -1.0


def test_occ_dataset_depth_cache_equals_reference(fixture_root, tmp_path):
    """Cache mode reads each frame's per-camera metric depth: the port's
    `.npy` files and the reference's torch.save `.tensor` files."""
    root, pkl = fixture_root
    rng = np.random.default_rng(7)
    cams = DataConfig().cams
    for si in range(3):
        tok = f"tok{si}"
        d = tmp_path / tok[:2] / tok
        d.mkdir(parents=True)
        for ci, cam in enumerate(cams):
            depth = rng.uniform(1, 40, size=(32, 88)).astype(np.float32)
            if (si + ci) % 2:
                np.save(d / f"{tok}-{cam}.npy", depth)
            else:
                torch.save(torch.from_numpy(depth), str(d / f"{tok}-{cam}.tensor"))
    jds, pds = _datasets(jns.NuScenesOccDataset, pns.NuScenesOccDataset, pkl, root,
                         num_temporal=2, depth_cache_dir=str(tmp_path), load_lidar_depth=False)
    for i in range(3):
        got = pds[i]
        assert "depth_imgs" not in got and got["depth_preds"].shape == (2, 6, 32, 88)
        assert_same(got, jds[i], f"sample{i}")


def test_occ_dataset_refuses_bda_rot_and_scale_as_reference(fixture_root):
    root, pkl = fixture_root
    for data in (dict(bda_rot_lim=(5.0, 5.0)), dict(bda_scale_lim=(1.1, 1.1))):
        jds, pds = _datasets(jns.NuScenesOccDataset, pns.NuScenesOccDataset, pkl, root,
                             is_train=True, data=data)
        with pytest.raises(ValueError) as want:
            jds[0]
        with pytest.raises(ValueError) as got:
            pds[0]
        assert str(got.value) == str(want.value)


def test_occ_dataset_evaluate_equals_reference(fixture_root):
    root, pkl = fixture_root
    jds, pds = _datasets(jns.NuScenesOccDataset, pns.NuScenesOccDataset, pkl, root)
    preds = [np.random.default_rng(8).integers(0, 18, size=(20, 20, 4)) for _ in range(3)]
    for mask in (True, False):
        got, want = pds.evaluate(preds, use_image_mask=mask), jds.evaluate(preds, use_image_mask=mask)
        assert got == want and np.isfinite(got["mIoU"])


def test_retrieval_csv_and_dataset_equal_reference(fixture_root, tmp_path):
    root, pkl = fixture_root
    csv_path = _write_retrieval_fixture(str(tmp_path))
    assert_same(pns.load_retrieval_csv(csv_path), jns.load_retrieval_csv(csv_path))
    jds, pds = _datasets(jns.NuScenesRetrievalDataset, pns.NuScenesRetrievalDataset, pkl, root,
                         load_lidar_depth=False)
    jds.filter_to_retrieval_csv(csv_path)
    pds.filter_to_retrieval_csv(csv_path)
    assert len(pds) == len(jds) == 1
    assert_same(pds[0], jds[0])
    results = [{"map": 0.5, "map_visible": 0.25}, {"map": float("nan"), "map_visible": 0.75}]
    assert pds.evaluate_retrieval(results) == jds.evaluate_retrieval(results)


# -------------------------------------------------------------------- loader


class _Range:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"x": np.asarray([i]), "name": f"s{i}", "meta": {"v": np.full((2,), i)}}


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_loader_order_sharding_and_modes_equal_reference(mode):
    """Batches, shuffled per epoch, with and without a remainder, across
    three shards, in both worker modes: equal to the JAX loader's."""
    for kw in (dict(batch_size=3, drop_last=False), dict(batch_size=3, shuffle=True),
               dict(batch_size=1, shuffle=True, shard=(1, 3), drop_last=False),
               dict(batch_size=2, shard=(2, 3), drop_last=False)):
        for epoch in (0, 1):
            jl = jld.DataLoader(_Range(), num_workers=2, mode=mode, **kw)
            pl = pld.DataLoader(_Range(), num_workers=2, mode=mode, **kw)
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            want = list(jl)
            assert len(pl) == len(jl) == len(want)
            assert_same(list(pl), want, f"{kw} epoch {epoch}")


def test_loader_process_mode_samples_equal_thread_mode(fixture_root):
    root, pkl = fixture_root
    _, pds = _datasets(jns.NuScenesOccDataset, pns.NuScenesOccDataset, pkl, root)
    thread = list(pld.DataLoader(pds, num_workers=2, drop_last=False))
    assert_same(list(pld.DataLoader(pds, num_workers=2, drop_last=False, mode="process")),
                thread)
    assert thread[0]["imgs"].shape == (1, 1, 6, 64, 176, 3)


# -------------------------------------------------------------- create_infos


def test_create_infos_equals_reference(tmp_path):
    root = str(tmp_path)
    _write_tables(root)
    for val in ([], ["scene-0002"], ["scene-0001", "scene-0002"]):
        got = pci.create_infos(root, "v1.0-mini", val, out_prefix=os.path.join(root, "p"))
        with open(os.path.join(root, "p_infos_val.pkl"), "rb") as f:
            written = pickle.load(f)
        want = jci.create_infos(root, "v1.0-mini", val, out_prefix=os.path.join(root, "j"))
        assert_same(got, want)
        with open(os.path.join(root, "j_infos_val.pkl"), "rb") as f:
            assert_same(written, pickle.load(f))


def test_loader_bench_shard_equals_reference(tmp_path):
    """`utils/loader_bench.py` `make_frames` writes the reference's shard
    (the same JPEG bytes, labels and infos but for the root), and
    `loader_fps` runs a VEON-B eval loader over it."""
    from veon_tpu.utils import loader_bench as jlb
    from veon_tpu_torch.utils import loader_bench as plb

    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    jpkl = jlb.make_frames(roots["jax"], 3, hw=(45, 80), grid_shape=(20, 20, 4))
    ppkl = plb.make_frames(roots["port"], 3, hw=(45, 80), grid_shape=(20, 20, 4))
    with open(jpkl, "rb") as f, open(ppkl, "rb") as g:
        want, got = pickle.load(f), pickle.load(g)
    def rebase(x):
        if isinstance(x, dict):
            return {k: rebase(v) for k, v in x.items()}
        if isinstance(x, list):
            return [rebase(v) for v in x]
        return x.replace(roots["port"], roots["jax"]) if isinstance(x, str) else x

    assert_same(rebase(got), want)
    names = sorted(os.listdir(os.path.join(roots["jax"], "imgs")))
    assert names == sorted(os.listdir(os.path.join(roots["port"], "imgs"))) and len(names) == 36
    for n in names:
        with open(os.path.join(roots["jax"], "imgs", n), "rb") as f, \
                open(os.path.join(roots["port"], "imgs", n), "rb") as g:
            assert f.read() == g.read(), n
    for k, v in np.load(os.path.join(roots["jax"], "occ", "labels.npz")).items():
        np.testing.assert_array_equal(np.load(os.path.join(roots["port"], "occ",
                                                           "labels.npz"))[k], v)
    assert plb.loader_fps(ppkl, roots["port"], workers=1) > 0
