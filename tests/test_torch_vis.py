"""The port's visualization helpers (`veon_tpu_torch/utils/vis.py`, its own
numpy copy) against the JAX package's on the cases of
`tests/test_vis_infos.py` (equal arrays and files), and the `vis` CLI at
the tiny preset on the CPU: on the synthetic batch and on a shard through
--ann, the images' shapes, one point per non-free voxel of the predicted
grid and one overlay per camera."""

import os

import numpy as np
import pytest

import test_torch_common  # noqa: F401  (one thread)

from veon_tpu.data.transforms import normalize_clipsan
from veon_tpu.utils import vis as jvis

from veon_tpu_torch.cli import main as pcli
from veon_tpu_torch.utils import vis as tvis


def _occ():
    occ = np.full((4, 4, 3), 17, dtype=np.int64)
    occ[1, 2, 0] = 4   # car at z=0
    occ[1, 2, 2] = 7   # pedestrian above it: the BEV shows it
    occ[3, 0, 2] = 7
    return occ


def test_colorize_depth_matches_reference():
    d = np.linspace(1, 40, 12).reshape(3, 4)
    img = tvis.colorize_depth(d)
    assert img.shape == (3, 4, 3) and img.dtype == np.uint8
    assert not np.array_equal(img[0, 0], img[-1, -1])
    np.testing.assert_array_equal(img, jvis.colorize_depth(d))
    np.testing.assert_array_equal(tvis.colorize_depth(d, 5.0, 30.0),
                                  jvis.colorize_depth(d, 5.0, 30.0))


def test_vis_occ_bev_and_slices_match_reference():
    occ = _occ()
    img = tvis.vis_occ_bev(occ)
    assert img.shape == (4, 4, 3)
    np.testing.assert_array_equal(img[2, 1], [255, 0, 0])  # pedestrian color
    np.testing.assert_array_equal(img[0, 0], [255, 255, 255])  # free
    np.testing.assert_array_equal(img, jvis.vis_occ_bev(occ))
    strip = tvis.vis_occ_height_slices(occ)
    assert strip.shape == (4, 12, 3)
    np.testing.assert_array_equal(strip, jvis.vis_occ_height_slices(occ))


def test_vis_occ_pointcloud_matches_reference(tmp_path):
    occ = _occ()
    files = {}
    for side, mod in (("port", tvis), ("jax", jvis)):
        files[side] = (str(tmp_path / f"{side}.ply"), str(tmp_path / f"{side}.npy"))
        verts = mod.vis_occ_pointcloud(occ, grid_range=((-40, 40), (-40, 40), (-1, 5.4)),
                                       ply_path=files[side][0], npy_path=files[side][1])
        assert verts.shape == (3, 4)
    np.testing.assert_allclose(np.load(files["port"][1])[0],
                               [-10.0, 10.0, -1 + 3.2 / 3, 4.0], rtol=1e-5)
    for i in range(2):
        assert open(files["port"][i], "rb").read() == open(files["jax"][i], "rb").read()
    lines = open(files["port"][0]).read().splitlines()
    assert lines[0] == "ply" and "element vertex 3" in lines[2] and len(lines) == 10 + 3


@pytest.mark.parametrize("mode", ["overlay", "mask"])
def test_semseg_overlay_matches_reference(mode):
    img = np.full((8, 8, 3), 100, dtype=np.uint8)
    sem = np.zeros((4, 4), dtype=np.int64)
    sem[2:, 2:] = 3
    got = tvis.semseg_overlay(img, sem, num_classes=18, alpha=0.5, mode=mode)
    assert got.shape == (8, 8, 3)
    np.testing.assert_array_equal(got, jvis.semseg_overlay(img, sem, num_classes=18, alpha=0.5,
                                                           mode=mode))
    if mode == "mask":  # both classes in their own seeded color, nearest-upsampled 2x
        assert not np.array_equal(got[0, 0], got[7, 7])
        np.testing.assert_array_equal(got[6, 6], got[7, 7])


def test_camera_grid_and_denorm_roundtrip_match_reference():
    raw = np.random.default_rng(0).integers(0, 255, size=(8, 10, 3), dtype=np.uint8)
    norm = normalize_clipsan(raw)
    rec = tvis.denormalize_clipsan(norm)
    np.testing.assert_allclose(rec, raw, atol=1)
    np.testing.assert_array_equal(rec, jvis.denormalize_clipsan(norm))
    grid = tvis.camera_grid([raw] * 6, cols=3)
    assert grid.shape == (16, 30, 3)
    np.testing.assert_array_equal(grid, jvis.camera_grid([raw] * 6, cols=3))


def _check_vis(paths, cfg_grid, work):
    from PIL import Image

    nx, ny, nz = cfg_grid.size
    assert np.asarray(Image.open(paths["bev"])).shape == (ny, nx, 3)
    assert np.asarray(Image.open(paths["slices"])).shape == (ny, nx * nz, 3)
    verts = np.load(paths["npy"])
    head = open(paths["ply"]).read().splitlines()
    assert head[2] == f"element vertex {len(verts)}" and len(head) == 10 + len(verts)
    assert len(paths["semseg"]) == 6
    for p in paths["semseg"]:
        assert os.path.dirname(p) == work
    return verts


@pytest.mark.parametrize("source", ["synthetic", "ann"])
def test_vis_cli_tiny(source, tmp_path, capsys, monkeypatch):
    """`vis --preset veon_tiny_test --device cpu`: the images' shapes, the
    point cloud holding one point per non-free voxel of the predicted grid
    (captured from the CLI's fusion rule), one overlay per camera of the
    input's size, on the synthetic batch and on a 2-frame shard."""
    from PIL import Image

    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.utils.loader_bench import make_frames

    preds = []
    fused = pcli.fused_classes
    monkeypatch.setattr(pcli, "fused_classes",
                        lambda out, m: preds.append(fused(out, m)) or preds[-1])
    work = str(tmp_path / "vis")
    argv = ["vis", "--preset", "veon_tiny_test", "--device", "cpu", "--work-dir", work,
            "--ann", str(tmp_path / "absent.pkl")]
    if source == "ann":
        root = str(tmp_path / "shard")
        pkl = make_frames(root, 2, hw=(90, 160), grid_shape=(20, 20, 4))
        argv[-1:] = [pkl, "--data-root", root]
    paths = pcli.main(argv)
    cfg = presets.veon_tiny_test()
    verts = _check_vis(paths, cfg.grid, work)
    pred = preds[-1][0].numpy()
    assert len(verts) == int((pred < 17).sum()) > 0
    H, W = cfg.data.input_size
    assert np.asarray(Image.open(paths["semseg"][0])).shape == (H, W, 3)
    assert f"occ_points.ply ({len(verts)} voxels)" in capsys.readouterr().out
