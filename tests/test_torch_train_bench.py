"""The port's train-step benchmark (`veon_tpu_torch/utils/train_bench.py`)
on the CPU at the tiny preset, the JAX tool's cases
(`tests/test_train_bench.py`): policy parsing, the --remat flag reaching
the model, a timed policy leg with its memory field and the 24-epoch
projection arithmetic; plus the port's legs: the batch equal to JAX's
`build_train_setup` batch, a policy run for its memory only, the forward
and loss alone, and `main`'s JSON lines."""

import json

import numpy as np
import pytest

import test_torch_common  # noqa: F401  (one thread)

from veon_tpu.utils import train_bench as jtb

from veon_tpu_torch.cli import main as pcli
from veon_tpu_torch.configs import presets
from veon_tpu_torch.nn.rematutil import parse_policy
from veon_tpu_torch.utils import train_bench as tb


@pytest.fixture(scope="module")
def setup():
    return tb.build_train_setup("veon_tiny_test", "float32", device="cpu")


def test_parse_policy_tokens():
    assert parse_policy("true") is True
    assert parse_policy("full") is True
    assert parse_policy("false") is False
    assert parse_policy("none") is False
    assert parse_policy(" dots_saveable ") == "dots_saveable"
    for tok in ("true", "FULL", "none", " dots_saveable "):
        assert parse_policy(tok) == jtb._parse_policy(tok)


def test_remat_policy_flag_threads_to_model():
    """`train --remat dots_saveable` reaches VeonModel.remat (train only;
    an eval build never recomputes)."""
    cfg = presets.veon_tiny_test()
    model, *_ = pcli.build_model_and_params(cfg, device="cpu", train=True,
                                            remat_policy="dots_saveable")
    assert model.remat == "dots_saveable"
    model, *_ = pcli.build_model_and_params(cfg, device="cpu", train=True, remat_policy=None)
    assert model.remat is True
    model, *_ = pcli.build_model_and_params(cfg, device="cpu", train=False,
                                            remat_policy="dots_saveable")
    assert model.remat is False


def test_train_setup_batch_equals_jax(setup):
    """The cached-depth batch: images, metric depth, metas, labels and the
    open-vocabulary matrix equal JAX's `build_train_setup`'s."""
    cfg, batch, weights, membership = setup
    assert cfg.compute_dtype == "float32" and cfg.depth.use_lora is False
    jcfg, jbatch, _jvars, jmembership = jtb.build_train_setup("veon_tiny_test", "float32")
    for k in ("imgs", "depth", "voxel_semantics", "mask_camera", "ov_weight"):
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]), err_msg=k)
    assert set(batch["metas"]) == set(jbatch["metas"])
    for k, v in batch["metas"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbatch["metas"][k]), err_msg=k)
    np.testing.assert_array_equal(membership, np.asarray(jmembership))
    assert batch["epoch"] == 0 and all(not v.requires_grad for v in weights.values())


def test_train_bench_tiny_policy_leg(setup):
    cfg, batch, weights, membership = setup
    r = tb.measure_policy(cfg, batch, weights, membership, "dots_saveable", steps=1)
    assert "run_error" not in r, r
    assert r["remat"] == "dots_saveable"
    assert r["ms_per_step"] > 0 and np.isfinite(r["ms_per_step"])
    assert r["memory"] == {"error": "peak device memory is read on the card only"}
    # 24-epoch projection: ceil(28130/8) * 24 steps at the measured rate
    steps_total = -(-tb.NUSC_TRAIN_SAMPLES // tb.RECIPE_REPLICAS) * tb.RECIPE_EPOCHS
    assert steps_total == -(-jtb.NUSC_TRAIN_SAMPLES // jtb.RECIPE_REPLICAS) * jtb.RECIPE_EPOCHS
    expect_h = steps_total * (r["ms_per_step"] / 1e3) / 3600.0
    assert abs(r["projected_24ep_8chip_h"] - expect_h) < 0.06


def test_memory_only_leg_and_forward_loss(setup):
    """run=False takes one untimed step and reports memory, no timing; the
    forward and loss alone give a finite median."""
    cfg, batch, weights, membership = setup
    r = tb.measure_policy(cfg, batch, weights, membership, True, run=False)
    assert r["remat"] == "True" and "memory" in r and "ms_per_step" not in r
    f = tb.measure_forward_loss(cfg, batch, weights, membership, steps=1)
    assert f["ms_forward_loss"] > 0 and f["first_call_s"] > 0


def test_main_prints_one_json_line_per_leg(capsys):
    rows = tb.main(["--preset", "veon_tiny_test", "--dtype", "float32", "--device", "cpu",
                    "--steps", "1", "--policies", "none", "--compile-only-policies", "",
                    "--skip-forward"])
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [ln["leg"] for ln in lines] == ["train_step"]
    assert lines[0]["remat"] == "False" and rows[0]["ms_per_step"] == lines[0]["ms_per_step"]
