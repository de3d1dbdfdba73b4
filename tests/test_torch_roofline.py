"""The port's serving-graph FLOP and byte audit
(`veon_tpu_torch/utils/roofline.py`) against JAX's
(`veon_tpu/utils/roofline.py`): every stage's FLOPs, bytes and note equal
for every preset, the helpers equal, and the port's rates the H100 SXM
data sheet's, not JAX's v5e figures."""

import json

import pytest

import test_torch_common  # noqa: F401  (one thread)

from veon_tpu.configs import presets as jpresets
from veon_tpu.utils import roofline as jroof

from veon_tpu_torch.configs import presets as ppresets
from veon_tpu_torch.utils import roofline as proof

PRESETS = ("veon_b", "veon_l", "veon_b_fast", "veon_b_fast2", "veon_b_zoe", "veon_l_zoe",
           "veon_tiny_test")


@pytest.mark.parametrize("preset", PRESETS)
def test_audit_stages_equal_jax_per_preset(preset):
    """Stage for stage: name, FLOPs, bytes and note, for the preset at its
    default frame count and the streaming configuration (num_temporal=2)."""
    for kw in ({}, {"num_temporal": 2}):
        want = jroof.audit_stages(getattr(jpresets, preset)(**kw))
        got = proof.audit_stages(getattr(ppresets, preset)(**kw))
        assert [s.name for s in got] == [s.name for s in want]
        for g, w in zip(got, want):
            assert (g.flops, g.bytes_min, g.note) == (w.flops, w.bytes_min, w.note), g.name


@pytest.mark.parametrize("args", [(196, 768), (705, 1024, 4.0, 32, 100), (11264, 384, 2.0)])
def test_helpers_equal_jax(args):
    assert proof.transformer_layer(*args) == jroof.transformer_layer(*args)
    assert proof.transformer_params(*args[1:2]) == jroof.transformer_params(*args[1:2])
    assert proof.conv2d(32, 88, 256, 128, 3, 2) == jroof.conv2d(32, 88, 256, 128, 3, 2)
    assert proof.conv3d(8, 100, 100, 256, 64, 1) == jroof.conv3d(8, 100, 100, 256, 64, 1)


def test_print_audit_defaults_are_h100_data_sheet(capsys):
    """The floors at 989 TFLOP/s dense bf16 and 3.35 TB/s, each stage the
    larger of its compute and memory time; the JSON names the rates'
    source; JAX's own floors at the same rates are the same."""
    cfg = ppresets.veon_b()
    out = proof.print_audit(cfg, as_json=True)
    assert json.loads(capsys.readouterr().out) == out
    assert out["rates"] == {"matmul_tfs": 989.0, "conv_tfs": 989.0, "hbm_gbps": 3350.0,
                            "source": "NVIDIA H100 SXM data-sheet peaks"}
    for row, st in zip(out["stages"], proof.audit_stages(cfg)):
        want = max(st.flops / 989e12, st.bytes_min / 3350e9) * 1e3
        assert row["ms_floor"] == round(want, 3)
    want = jroof.print_audit(jpresets.veon_b(), 989.0, 989.0, 3350.0, as_json=True)
    capsys.readouterr()
    assert out["total_gflop"] == want["total_gflop"]
    assert out["total_mb_min"] == want["total_mb_min"]
    assert abs(out["floor_ms"] - want["floor_ms"]) < 0.05


def test_main_prints_table(capsys):
    out = proof.main(["--preset", "veon_tiny_test"])
    text = capsys.readouterr().out
    assert "data-sheet peaks" in text and "total:" in text
    assert [r["stage"] for r in out["stages"]][:2] == ["depth_trunk", "dpt_head"]
