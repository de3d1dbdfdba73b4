"""The port's dataset-driven loops against the JAX package's, on the
synthetic nuScenes fixture of `test_data_pipeline.py` with the
reference-layout mirror checkpoints of `test_torch_mirror.py` at
`veon_tiny_test` (one set per frame count), both CLIs on the same files.
The JAX CLI's one-slot init memo keeps the plain init tree of the last
config it built, which is what it would compute again.

- `evaluate_occ`: the grids reach `dataset.evaluate` in loader order at
  pipeline 1, 2 and 3, as JAX's loop hands them.
- `test`: plain, --fuse-conv-bn, --raw-uint8 with --pipeline 2, and
  --num-temporal 2: the class grids equal on every voxel and the mIoU
  dicts equal (as `test_torch_weights.py` holds tiny served grids). JAX keeps
  the DA-V2 adapters unmerged and the port folds them, so the two differ by
  fp32 rounding; these weights leave no voxel near a tie.
- `test --retrieval` from the CSV: the cosines of the annotated points
  within 2e-4 (Queue 3 item 5's floor, max(2e-4, 8 x the one-ulp
  spread)) and ranked alike, so the summary's mAP is equal.
- `cache-depth`: the same files, values within the slice's 2e-4
  (`test_torch_slice.py`), idempotent.
- `benchmark --eval` at the tiny preset: every leg positive, the last line
  one JSON record.
- The refusals that remain: JAX's remat policy factories, `export
  --native` and `export --raw-uint8` at F=1; `train --cam-shards 2` in a
  world of one process raises JAX's error.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from test_data_pipeline import _make_fixture
from test_retrieval_cli import _write_retrieval_fixture
from test_torch_mirror import write_weights_dir

import veon_tpu.data.nuscenes as jns
from veon_tpu.cli import main as jcli
from veon_tpu.train.loop import evaluate_occ as jevaluate_occ
from veon_tpu_torch.cli import main as pcli
from veon_tpu_torch.configs import presets
from veon_tpu_torch.data import nuscenes as pns
from veon_tpu_torch.train.loop import _to_device, evaluate_occ, prefetch_to_device


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    pkl = _make_fixture(root)
    weights = {t: write_weights_dir(presets.veon_tiny_test(num_temporal=t),
                                    os.path.join(root, f"ckpts{t}")) for t in (1, 2)}
    return root, pkl, weights, _write_retrieval_fixture(root)


def _argv(cmd, root, pkl, paths, *extra):
    return [*cmd, "--preset", "veon_tiny_test", "--data-root", root, "--ann", pkl,
            "--workers", "1", "--load-from", paths["san"], "--depth-load-from", paths["depth"],
            "--bpe-path", paths["bpe"], *extra]


def _run_both(monkeypatch, argv, capture):
    """(port result, JAX result, {side: captured}) of one command line run
    by both CLIs; `capture(module, side, store)` patches what to record."""
    store = {}
    capture(monkeypatch, "port", store)
    capture(monkeypatch, "jax", store)
    return pcli.main(argv + ["--device", "cpu"]), jcli.main(argv), store


def _capture_grids(monkeypatch, side, store):
    mod = pns if side == "port" else jns
    orig = mod.NuScenesOccDataset.evaluate

    def evaluate(self, results, **kw):
        store[side] = np.stack([np.asarray(r) for r in results])
        return orig(self, results, **kw)

    monkeypatch.setattr(mod.NuScenesOccDataset, "evaluate", evaluate)


class _Loader:
    """Five one-sample batches whose grids carry their index."""

    class dataset:
        @staticmethod
        def evaluate(results):
            return {"order": [int(r.reshape(-1)[0]) for r in results], "n": len(results)}

    def __iter__(self):
        for i in range(5):
            yield {"imgs": np.full((1, 2, 2), i, np.float64),  # narrowed to float32
                   "depth_imgs": np.zeros((1, 2, 2), np.float32),
                   "metas": {"k": np.zeros((1, 3), np.int64)}, "token": [f"t{i}"]}


def test_evaluate_occ_in_order_at_every_pipeline_depth():
    import jax.numpy as jnp

    seen = []

    def predict(imgs, depth, metas, ovw):
        seen.append((imgs.dtype, metas["k"].dtype))
        return imgs.to(torch.int32)

    lines = []
    want = jevaluate_occ(lambda i, d, m, o: jnp.asarray(i, jnp.int32), _Loader(), None,
                         log_fn=lines.append)
    for pipeline in (1, 2, 3):
        got = evaluate_occ(predict, _Loader(), None, log_fn=lines.append, pipeline=pipeline,
                           device="cpu")
        assert got == want == {"order": [0, 1, 2, 3, 4], "n": 5}
    assert all("inference done: 5 samples" in ln for ln in lines)
    assert set(seen) == {(torch.float32, torch.int32)}


def test_to_device_narrows_64_bit_types_as_the_reference():
    """As `jnp.asarray` with 64-bit mode off; `prefetch_to_device` keeps
    the batches' order through its two-deep queue."""
    tree = {"a": np.zeros(2, np.float64), "b": [np.zeros(2, np.int64), "tok"],
            "c": np.zeros(2, np.uint8), "d": 3}
    got = _to_device(tree, "cpu")
    assert got["a"].dtype == torch.float32 and got["b"][0].dtype == torch.int32
    assert got["b"][1] == "tok" and got["c"].dtype == torch.uint8 and got["d"] == 3
    batches = [{"x": np.full(3, i, np.int64)} for i in range(5)]
    out = list(prefetch_to_device(iter(batches), "cpu", size=2))
    assert [int(b["x"][0]) for b in out] == list(range(5))
    assert all(b["x"].dtype == torch.int32 for b in out)


def test_retrieval_command_matches_reference(fixture, monkeypatch):
    root, pkl, weights, csv_path = fixture
    import veon_tpu.eval.retrieval as jret

    def capture(mp, side, store):
        mod, name = (pcli, "retrieval_scores") if side == "port" else (jret, "retrieval_scores")
        orig = getattr(mod, name)

        def scores(occ_feat, emb, idx, match, anno):
            i = idx.astype(np.int64)
            f = occ_feat[i[:, 0], i[:, 1], i[:, 2]]
            store[side] = f @ emb / np.maximum(np.linalg.norm(f, axis=-1)
                                              * np.linalg.norm(emb), 1e-8)
            return orig(occ_feat, emb, idx, match, anno)

        mp.setattr(mod, name, scores)

    got, want, cos = _run_both(
        monkeypatch, _argv(["test", "--retrieval", "--retrieval-items", csv_path], root, pkl,
                           weights[1]), capture)
    np.testing.assert_allclose(cos["port"], cos["jax"], rtol=0, atol=2e-4)
    # the points rank alike, so the average precisions are equal
    np.testing.assert_array_equal(np.argsort(-cos["port"], kind="stable"),
                                  np.argsort(-cos["jax"], kind="stable"))
    assert got == want and got["num_prompts"] == 1 and np.isfinite(got["mAP"])


def test_cache_depth_matches_reference(fixture, tmp_path):
    root, pkl, weights, _csv = fixture
    argv = ["cache-depth", "--preset", "veon_tiny_test", "--data-root", root, "--ann", pkl,
            "--workers", "1", "--depth-load-from", weights[1]["depth"]]
    n = pcli.main(argv + ["--cache-dir", str(tmp_path / "port"), "--device", "cpu"])
    jcli.main(argv + ["--cache-dir", str(tmp_path / "jax")])
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*.npy"))
    assert n == len(files) == 18 and str(files[0]) == "to/tok0/tok0-CAM_BACK.npy"
    for f in files:
        got, want = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert got.shape == want.shape == (32, 88) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert pcli.main(argv + ["--cache-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0


@pytest.mark.parametrize("extra", [
    (), ("--fuse-conv-bn",), ("--raw-uint8", "--pipeline", "2"), ("--num-temporal", "2"),
], ids=["plain", "fuse_conv_bn", "raw_uint8_pipeline2", "t2"])
def test_test_command_matches_reference(fixture, monkeypatch, extra):
    root, pkl, weights, _csv = fixture
    paths = weights[2 if "--num-temporal" in extra else 1]
    got, want, grids = _run_both(monkeypatch, _argv(["test"], root, pkl, paths, *extra),
                                 _capture_grids)
    assert grids["port"].dtype == np.uint8 and grids["port"].shape == (3, 20, 20, 4)
    np.testing.assert_array_equal(grids["port"], grids["jax"])
    assert 0.02 < (grids["port"] != 17).mean() < 0.98  # both branches of the fusion rule
    assert got == want and np.isfinite(got["mIoU"])


def test_benchmark_eval_tiny_all_legs(monkeypatch, tmp_path, capsys):
    def veon_tiny_fixture(num_temporal=1):
        cfg = presets.veon_tiny_test(num_temporal=num_temporal)
        return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, src_size=(90, 160)))

    monkeypatch.setattr(presets, "veon_tiny_fixture", veon_tiny_fixture, raising=False)
    out = pcli.main(["benchmark", "--eval", "--frames", "2", "--preset", "veon_tiny_fixture",
                     "--workers", "1", "--pipeline", "2", "--device", "cpu"])
    d = out["detail"]
    assert out["unit"] == "frames/s" and out["device"] == "cpu" and out["value"] > 0
    for k in ("device_path_ms_per_frame", "h2d_ms", "forward_ms", "readback_ms",
              "pipelined_fps", "e2e_fps", "hist_ms_per_frame", "first_frame_s"):
        assert d[k] > 0, k
    assert "inference done: 2 samples" in d["e2e_inference_line"]
    assert np.isfinite(d["miou"]) and d["dtype"] == "float32" and d["pipeline"] == 2
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


@pytest.mark.parametrize("argv, error, item", [
    # camera sharding is ported (item 16, test_torch_camshard.py); a world
    # size that --cam-shards does not divide raises JAX's error
    pytest.param(["train", "--cam-shards", "2"], ValueError,
                 "1 devices not divisible by --cam-shards 2", id="argv0-item 16"),
    # remat policies are ported (item 11a); JAX's policy factories stay refused
    pytest.param(["train", "--remat", "save_only_these_names"], ValueError, "factory",
                 id="argv3-item 11a"),
    # the ids name the items these two cases refused before `benchmark` and
    # `export` were ported (23, 21); what stays refused of export is tested
    pytest.param(["export", "--raw-uint8"], SystemExit, "needs --num-temporal > 1",
                 id="argv5-item 23"),
    pytest.param(["export", "--native"], NotImplementedError, "item 25", id="argv6-item 21"),
])
def test_cli_refuses_what_is_not_ported(argv, error, item):
    with pytest.raises(error, match=item):
        pcli.main(argv + ["--device", "cpu"])
