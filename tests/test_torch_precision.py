"""The port's bf16 serving forward against its own fp32 forward on the CPU,
the battery of `tests/test_precision.py` with its bounds: the
fusion-rule class flip rate < 0.15, the cosine of the `feat_occ` field
(what retrieval reads) > 0.98, and the mean absolute difference of the
occupancy probability < 0.05. `veon_tiny_test`, the same weights and
inputs on both sides, only `compute_dtype` differs: seeded weights, and
weights converted from spread mirror dumps of the reference's layout.
`chip_smoke.py` runs the same battery at VEON-B full width on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_common import to_np
from test_torch_mirror import write_weights_dir

from veon_tpu_torch.cli.main import load_checkpoints
from veon_tpu_torch.configs import presets
from veon_tpu_torch.entry import entry
from veon_tpu_torch.eval.precision import precision_battery


def _pair(cfg, variables):
    out = {}
    for dt in ("float32", "bfloat16"):
        server, (imgs, depth_imgs) = entry(dataclasses.replace(cfg, compute_dtype=dt),
                                           device="cpu", seed=0, variables=variables)
        out[dt] = (server.outputs(imgs, depth_imgs), server.membership)
    return out


@pytest.mark.parametrize("weights", ["seeded", "converted"])
def test_bf16_forward_divergence_bounded(weights, tmp_path):
    cfg = presets.veon_tiny_test()
    variables = None
    if weights == "converted":
        paths = write_weights_dir(cfg, str(tmp_path))
        variables, _extras = load_checkpoints(cfg, paths["san"], paths["depth"])
    pair = _pair(cfg, variables)
    (out32, membership), (out16, _) = pair["float32"], pair["bfloat16"]
    for k, v in out16.items():
        assert v.dtype == torch.float32 and torch.isfinite(v).all(), k
    assert not torch.equal(out16["feat_occ"], out32["feat_occ"])  # bf16 really computed
    r = precision_battery(out32, out16, membership)
    print(f"bf16 vs fp32 ({weights}): {r}")
    assert r["flip_rate"] < 0.15, r
    assert r["feat_cos"] > 0.98, r
    assert r["occ_prob_mad"] < 0.05, r


def test_battery_reads_identical_outputs_as_equal():
    server, (imgs, depth_imgs) = entry(presets.veon_tiny_test(), device="cpu", seed=1)
    out = server.outputs(imgs, depth_imgs)
    r = precision_battery(out, out, server.membership)
    assert r == {"flip_rate": 0.0, "feat_cos": pytest.approx(1.0, abs=1e-6), "occ_prob_mad": 0.0}
    assert to_np(out["bin_occ"]).shape[-1] == 2
