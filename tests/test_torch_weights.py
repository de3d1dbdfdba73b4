"""Weights day on the CPU: the reference's checkpoint files, written from
the mirrors of `tests/ref_layout_mirror.py` at `veon_tiny_test` (a
semantic dump with the text tower, a DA-V2 dump with LoRA adapters of rank
16, a learned BPE merges file; `tests/test_torch_mirror.py`), loaded by
the port's CLI and by the JAX package's.

- `build_serve_handler` with --load-from/--depth-load-from/--bpe-path
  against JAX's `_build_serve_handler` on the same files: the classifier
  within 1e-5 of a unit row, `pred` equal on every voxel, `retrieval`
  within atol 2e-4 (the tolerance of `test_torch_serve.py`). JAX keeps
  the DA-V2 adapters unmerged (use_lora=True) and the port folds them into
  the base kernels, so the two differ by fp32 rounding only. These weights
  give small logits (merged class logits within [-1.3, 0.9]), so a 1e-3
  near-tie margin would leave out 8% of the voxels; the smallest margins
  here are 2.6e-5 (class) and 5.4e-5 (occupancy), far above the two
  sides' fp32 differences, and the grids are equal everywhere.
- `selftest --weights-dir`: the same five step lines and the same mIoU;
  `selftest` alone: the same line of output shapes.
- The refusals: missing files, a real text tower without BPE merges, a
  vocabulary-size mismatch, each as the reference raises it."""

import argparse
import dataclasses
import os

import numpy as np
import pytest

from test_torch_common import to_np
from test_torch_mirror import write_weights_dir

from veon_tpu.configs import presets as jpresets
from veon_tpu_torch.cli import main as pmain
from veon_tpu_torch.cli.shapes import example_batch_full
from veon_tpu_torch.configs import presets
from veon_tpu_torch.nn import text as ptext


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpts"))
    return root, write_weights_dir(presets.veon_tiny_test(), root)


def _args(paths, **kw):
    return argparse.Namespace(**dict(dict(
        preset="veon_tiny_test", num_temporal=1, device="cpu", load_from=paths.get("san"),
        depth_load_from=paths.get("depth"), bpe_path=paths.get("bpe"), raw_uint8=False,
        cam_shards=1), **kw))


class _Memo:
    """Restores the JAX CLI's one-slot init memo after a build."""

    def __enter__(self):
        from veon_tpu.cli import main as jmain

        self.memo, self.saved = jmain._INIT_MEMO, dict(jmain._INIT_MEMO)
        return jmain

    def __exit__(self, *exc):
        self.memo.clear()
        self.memo.update(self.saved)


def test_served_checkpoints_match_reference(weights):
    _root, paths = weights
    args = _args(paths)
    handler, required, _expect, exclusive = pmain.build_serve_handler(args)
    assert required == ("imgs", "depth_imgs") and not exclusive
    with _Memo() as jmain:
        jax_handler, jreq, _jexpect, _jexcl = jmain._build_serve_handler(args)
        jcfg = jmain._build_cfg(args)
        _m, _v, jovw, _refl, extras = jmain._build_model_and_params(
            jcfg, san_ckpt=paths["san"], depth_ckpt=paths["depth"], bpe_path=paths["bpe"])
    assert jreq == required and set(extras) == {"text_tower", "bg_embed", "logit_scale"}
    scale = float(np.exp(np.asarray(extras["logit_scale"])))
    np.testing.assert_allclose(to_np(handler.server.ov_weight) / scale, np.asarray(jovw) / scale,
                               rtol=0, atol=1e-5)
    cfg = presets.veon_tiny_test()
    imgs, depth_imgs, _ = example_batch_full(cfg, device="cpu")
    frame = {"imgs": imgs.numpy(), "depth_imgs": depth_imgs.numpy()}
    te = np.random.default_rng(3).standard_normal(cfg.propagation.clip_proj_dim).astype(np.float32)
    tokens = ptext.ClipTokenizer(paths["bpe"]).tokenize(["a parked red car"])
    for text in ({}, {"text_tokens": tokens}, {"text_embed": te}):
        got, want = handler(**frame, **text), jax_handler(**frame, **text)
        assert got.keys() == want.keys() == ({"pred", "retrieval"} if text else {"pred"})
        assert got["pred"].dtype == np.uint8
        np.testing.assert_array_equal(got["pred"], np.asarray(want["pred"]))
        assert 0.05 < (got["pred"] != 17).mean() < 0.95  # both branches of the fusion rule
        if text:
            np.testing.assert_allclose(got["retrieval"], np.asarray(want["retrieval"]),
                                       rtol=0, atol=2e-4)


def _step_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith(("[", "WARNING"))]


def test_selftest_weights_drill_matches_reference(weights, capsys):
    root, _paths = weights
    argv = ["selftest", "--preset", "veon_tiny_test", "--weights-dir", root]
    got = pmain.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    with _Memo() as jmain:
        want = jmain.main(argv)
    jax_out = capsys.readouterr().out
    lines = _step_lines(port_out)
    assert [ln[:5] for ln in lines] == ["[1/5]", "[2/5]", "[4/5]", "[5/5]"]
    assert lines == _step_lines(jax_out)
    assert got == want and got["miou"] > 0


def test_selftest_smoke_matches_reference(capsys):
    """`selftest` without --weights-dir: the tiny preset's seeded forward
    without a presorted rig prints the reference's line, every output's
    shape and the class grid's."""
    from veon_tpu.cli import main as jmain

    pmain.main(["selftest", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()[-1]
    jmain.main(["selftest"])
    want = capsys.readouterr().out.splitlines()[-1]
    assert got.startswith("selftest ok: {'bin_occ': (1, 4, 20, 20, 2)")
    assert got == want


def test_missing_files_refused_as_the_reference(tmp_path, weights):
    from veon_tpu.cli.main import _resolve_weights_dir

    _root, paths = weights
    os.makedirs(tmp_path / "depth_pretrain")
    os.link(paths["depth"], tmp_path / "depth_pretrain" / os.path.basename(paths["depth"]))
    for d in (str(tmp_path / "empty"), str(tmp_path)):
        for preset in ("veon_b", "veon_l"):
            with pytest.raises(FileNotFoundError) as want:
                _resolve_weights_dir(d, preset)
            with pytest.raises(FileNotFoundError) as got:
                pmain.resolve_weights_dir(d, preset)
            assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError, match="san: expected one of"):
        pmain.main(["selftest", "--device", "cpu", "--weights-dir", str(tmp_path)])


def test_real_tower_without_bpe_refused_as_the_reference(weights):
    _root, paths = weights
    cfg = presets.veon_tiny_test()
    with pytest.raises(ValueError, match="no BPE vocab") as got:
        pmain.build_model_and_params(cfg, paths["san"], paths["depth"], None, device="cpu")
    with pytest.raises(ValueError, match="no BPE vocab"):
        pmain.build_serve_handler(_args(paths, bpe_path=None))
    with _Memo() as jmain:
        with pytest.raises(ValueError, match="no BPE vocab") as want:
            jmain._build_model_and_params(jpresets.veon_tiny_test(), san_ckpt=paths["san"])
    assert type(got.value) is type(want.value)
    # without the tower the placeholder classifier needs no merges
    _m, _t, ovw, _mm, extras = pmain.build_model_and_params(cfg, None, paths["depth"],
                                                            device="cpu")
    assert extras == {}
    np.testing.assert_array_equal(to_np(ovw), np.random.default_rng(0).standard_normal(
        (67, cfg.san.clip_embed_dim)).astype(np.float32))


def test_vocabulary_mismatch_refused_as_the_reference(tmp_path, weights):
    _root, paths = weights
    cfg = presets.veon_tiny_test()
    small = dataclasses.replace(cfg, san=dataclasses.replace(cfg.san, text_vocab_size=1000))
    other = write_weights_dir(small, str(tmp_path))
    msg = "text tower vocab size 1000 != configured 49408; checkpoint/config mismatch"
    with pytest.raises(ValueError) as got:
        pmain.build_model_and_params(cfg, other["san"], None, paths["bpe"], device="cpu")
    with _Memo() as jmain:
        with pytest.raises(ValueError) as want:
            jmain._build_model_and_params(jpresets.veon_tiny_test(), san_ckpt=other["san"],
                                          bpe_path=paths["bpe"])
    assert msg in str(got.value) and msg in str(want.value)
