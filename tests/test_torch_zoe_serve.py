"""The zoe branch through the port's entry points and CLI on the CPU, at
`veon_tiny_test` with JAX's tiny ZoeDepth-NK tower (`test_torch_mirror.py`
`with_tiny_zoe`) registered on both sides as the preset `veon_tiny_zoe` for the tests' run:

- the depth input of a zoe preset (midas-normalized) at depth_input_size,
  not at the DA-V2 size, in `example_depth_imgs`, `example_drive` and the
  shapes `serve_entry` expects; DA-V2 presets keep theirs;
- a T=2 streaming session through `serve_entry` against JAX's
  `_build_serve_handler` on the same perturbed weights (JAX applies the
  adapters, the port the folded tree): `pred` equal off near-ties and
  `retrieval` within atol 2e-4, as `test_torch_serve.py` holds them;
- weights day: reference-layout files with a ZoeDepth-NK dump (LoRA r=2,
  `write_weights_dir`), `selftest --weights-dir` on both CLIs (the same
  step lines and mIoU), `cache-depth` on the `_make_fixture` shard (the
  same files within the slice's 2e-4) and the port's `test`."""

import argparse
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_common import np_tree, perturbed
from test_torch_mirror import with_tiny_zoe, write_weights_dir
from test_torch_serve import _clear, _compare, _text_requests
from test_torch_weights import _Memo, _step_lines

from veon_tpu.configs import presets as jpresets
from veon_tpu_torch.cli import main as pmain
from veon_tpu_torch.cli.shapes import example_depth_imgs, example_drive
from veon_tpu_torch.configs import presets
from veon_tpu_torch.entry import serve_entry


def _jax_tiny_zoe(num_temporal: int = 1):
    return with_tiny_zoe(jpresets.veon_tiny_test(num_temporal=num_temporal))


def _port_tiny_zoe(num_temporal: int = 1):
    return with_tiny_zoe(presets.veon_tiny_test(num_temporal=num_temporal))


@pytest.fixture(autouse=True)
def tiny_zoe_preset(monkeypatch):
    """`veon_tiny_zoe` in both packages' preset modules, for this test only."""
    monkeypatch.setattr(jpresets, "veon_tiny_zoe", _jax_tiny_zoe, raising=False)
    monkeypatch.setattr(presets, "veon_tiny_zoe", _port_tiny_zoe, raising=False)


@pytest.mark.parametrize("name", ["veon_b_zoe", "veon_l_zoe", "veon_tiny_zoe"])
def test_zoe_depth_input_is_not_resized(name):
    cfg = getattr(presets, name)(num_temporal=2)
    want = cfg.data.depth_input_size
    assert example_depth_imgs(cfg, device="cpu").shape[3:5] == want
    _rig, reqs = example_drive(cfg, 1, device="cpu")
    assert reqs[0]["depth_imgs"].shape[3:5] == want


@pytest.mark.parametrize("name", ["veon_b", "veon_tiny_test"])
def test_dav2_depth_input_keeps_the_dav2_size(name):
    from veon_tpu_torch.data.transforms import dav2_size

    cfg = getattr(presets, name)()
    want = dav2_size(*cfg.data.depth_input_size, target=cfg.data.dav2_target)
    assert want != cfg.data.depth_input_size
    assert example_depth_imgs(cfg, device="cpu").shape[3:5] == want
    assert example_drive(cfg, 1, device="cpu")[1][0]["depth_imgs"].shape[3:5] == want


@pytest.mark.parametrize("T", [1, 2])
def test_serve_entry_expects_the_zoe_size(T):
    cfg = _port_tiny_zoe(T)
    _handler, _required, expect, _excl = serve_entry(cfg, device="cpu")
    h, w = cfg.data.depth_input_size
    assert f"depth_imgs (1, 1, 6, {h}, {w}, 3)" in expect, expect


@functools.lru_cache(maxsize=None)
def _handlers(T):
    """(JAX handler, port handler) of `veon_tiny_zoe` at num_temporal T on
    the JAX CLI's init tree, every leaf perturbed (the zoe LoRA B factors
    nonzero); the JAX CLI's one-slot memo is planted for one build and
    restored after. The text tower is JAX's seeded one on both sides."""
    from veon_tpu.ckpt.convert import merge_lora
    from veon_tpu.nn.vit import CLIPTextEncoder

    args = argparse.Namespace(preset="veon_tiny_zoe", num_temporal=T, load_from=None,
                              depth_load_from=None, bpe_path=None)
    with _Memo() as jmain:
        cfg = jmain._build_cfg(args)
        jmain._build_model_and_params(cfg)
        variables = perturbed(np_tree(jmain._INIT_MEMO["variables"]))
        jmain._INIT_MEMO["variables"] = jax.tree_util.tree_map(jnp.asarray, variables)
        jax_handler, required, _expect, exclusive = jmain._build_serve_handler(args)
    assert np.abs(variables["params"]["depth"]["core"]["readout_0"]["project"]["lora_B"]).min() > 0
    s = cfg.san
    enc = CLIPTextEncoder(width=s.text_width, heads=s.text_heads, num_layers=s.text_layers,
                          out_dim=s.clip_embed_dim, vocab_size=s.text_vocab_size,
                          context_length=s.text_context_length)
    text_params = jax.jit(enc.init)(jax.random.PRNGKey(1), jnp.zeros((1, 77), jnp.int32))
    port = serve_entry(_port_tiny_zoe(T), device="cpu",
                       variables=dict(variables, params=merge_lora(variables["params"])),
                       text_tower=np_tree(text_params["params"]))
    assert port[1] == required and port[3] == exclusive
    return jax_handler, port[0]


def test_zoe_streaming_handler_matches_reference():
    jax_handler, handler = _handlers(2)
    cfg = _port_tiny_zoe(2)
    _rig, drive = example_drive(cfg, 3, device="cpu", seed=2)
    reqs = [{k: v.numpy() for k, v in r.items()} for r in drive]
    texts = _text_requests(cfg)
    got = [handler(**r, **t) for r, t in zip(reqs, texts)]
    want = [jax_handler(**r, **t) for r, t in zip(reqs, texts)]
    session = handler.session  # replay the calls for the port's raw outputs
    session.reset()
    for r, g, w, t in zip(drive, got, want, texts):
        out = session.infer(r["imgs"], r["depth_imgs"], {"lidarego2global": r["lidarego2global"]})
        _compare(g, w, _clear(out, session.membership), bool(t))


@pytest.fixture(scope="module")
def zoe_weights(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zoe_ckpts"))
    return root, write_weights_dir(_port_tiny_zoe(), root)


def test_zoe_weights_dir_layout(zoe_weights):
    from veon_tpu_torch.ckpt.convert import load_torch_state_dict

    root, paths = zoe_weights
    assert paths["depth"] == os.path.join(root, "depth_pretrain", "zoedepth_pretrain.pth")
    sd = load_torch_state_dict(paths["depth"])
    assert "core.core.pretrained.model.blocks.0.attn.qkv.lora_A" in sd
    assert pmain.resolve_weights_dir(root, "veon_tiny_zoe")["depth"] == paths["depth"]


def test_zoe_selftest_weights_drill_matches_reference(zoe_weights, capsys):
    root, _paths = zoe_weights
    argv = ["selftest", "--preset", "veon_tiny_zoe", "--weights-dir", root]
    got = pmain.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    with _Memo() as jmain:
        want = jmain.main(argv)
    jax_out = capsys.readouterr().out
    lines = _step_lines(port_out)
    assert [ln[:5] for ln in lines] == ["[1/5]", "[2/5]", "[4/5]", "[5/5]"]
    assert "zoedepth_pretrain.pth" in lines[0]
    assert lines == _step_lines(jax_out)
    assert got == want and got["miou"] > 0


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    from test_data_pipeline import _make_fixture

    root = str(tmp_path_factory.mktemp("nusc_zoe"))
    return root, _make_fixture(root)


def test_zoe_cache_depth_matches_reference(shard, zoe_weights, tmp_path):
    from veon_tpu.cli import main as jcli

    root, pkl = shard
    argv = ["cache-depth", "--preset", "veon_tiny_zoe", "--data-root", root, "--ann", pkl,
            "--workers", "1", "--depth-load-from", zoe_weights[1]["depth"]]
    n = pmain.main(argv + ["--cache-dir", str(tmp_path / "port"), "--device", "cpu"])
    with _Memo():
        jcli.main(argv + ["--cache-dir", str(tmp_path / "jax")])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.npy"))
    assert n == len(files) == 18
    for f in files:
        got, want = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert got.shape == want.shape == (32, 88) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_zoe_test_command_runs(shard, zoe_weights, monkeypatch):
    """The port's `test` on the zoe preset: the dataset's depth frames at
    depth_input_size reach the zoe tower, one grid per sample."""
    from veon_tpu_torch.data import nuscenes as pns

    root, pkl = shard
    paths = zoe_weights[1]
    grids = []
    orig = pns.NuScenesOccDataset.evaluate

    def evaluate(self, results, **kw):
        grids.extend(np.asarray(r) for r in results)
        return orig(self, results, **kw)

    monkeypatch.setattr(pns.NuScenesOccDataset, "evaluate", evaluate)
    res = pmain.main(["test", "--preset", "veon_tiny_zoe", "--data-root", root, "--ann", pkl,
                      "--workers", "1", "--load-from", paths["san"], "--depth-load-from",
                      paths["depth"], "--bpe-path", paths["bpe"], "--device", "cpu"])
    assert len(grids) == 3 and grids[0].shape == (20, 20, 4) and np.isfinite(res["mIoU"])
