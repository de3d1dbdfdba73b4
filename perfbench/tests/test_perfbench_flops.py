"""The benchmark's analytic FLOP counts (`flops.py`): the single frame
against the port's `utils/roofline.py` audit, and each cell's count
against `FlopCounterMode` over the reference at the miniature size."""

import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from perfbench import flops, harness, judge  # noqa: E402
from perfbench.reference.configs import base as ref_base  # noqa: E402
from test_perfbench_reference import SEED, miniatures, tiny_cell  # noqa: E402,F401


def test_frame_matches_the_roofline_audit():
    from veon_tpu_torch.configs import presets
    from veon_tpu_torch.utils.roofline import audit_stages

    cfg = presets.veon_b()
    ours = sum(s.flops for s in flops.serving_stages(cfg))
    assert round(ours / 1e9, 1) == 12971.6
    assert ours == sum(s.flops for s in audit_stages(cfg))


def test_the_cells_counts():
    got = {c["name"]: flops.per_request(harness.config_from_file(
        ref_base, harness.load_json(ROOT / c["file"])), 2) for c in harness.manifest()["configs"]}
    # T=2 adds the temporal fusion's convs at the 100x100x8 pooled grid of
    # 256 channels (~2.85 TFLOP) and the warp
    assert 15.7e12 < got["veon_b"] < 15.95e12
    assert got["veon_b_zoe"] < got["veon_b"]


CELLS = [(t, p) for p in ("veon_tiny_test", "veon_tiny_zoe", "veon_tiny_l")
         for t in ("stream_t2", "frame_f1")]


@pytest.mark.parametrize("traffic,preset", CELLS, ids=[f"{t}-{p}" for t, p in CELLS])
def test_against_flop_counter(traffic, preset, miniatures):  # noqa: F811
    """`FlopCounterMode` counts only matmuls, convolutions and attention,
    and counts what the reference dispatches: the analytic count adds the
    lift's weighting, the trilinear upsample and the stencil's products,
    and rounds the lift's in-grid share and the 67 prompts of the output
    product, so it may read a few percent above the counter, never below
    it by more than rounding."""
    cell = tiny_cell(traffic, preset)
    drv = harness.driver(cell.traffic)
    nt = cell.traffic["num_temporal"]
    cfg = harness.config_from_file(ref_base, cell.config, nt)
    dev = torch.device("cpu")
    ref = judge.RefServing(cell.config, nt, SEED, dev)
    frames = drv.make_frames(torch, cfg, cell.traffic, SEED, 2, dev)
    early = ref.early(frames[0]) if nt > 1 else None
    with FlopCounterMode(display=False) as fc:
        ref.step(frames[1], frames[0], early)
    counted = fc.get_total_flops()
    ratio = flops.per_item(cfg, cell.traffic) / counted
    assert 0.99 < ratio < 1.08, ratio
