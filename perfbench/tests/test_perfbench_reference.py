"""The benchmark's plain reference against the port's CPU path at the
miniature presets in fp32, on the benchmark's own seeded weights (the
reference builds each from the cell's sizes, as it does every cell); the
rest of a run driven on the CPU, with the timed path broken underneath,
seen to come out not correct; the imports nothing under `perfbench/` may
make; and, on the card only, the control that has to come out not
correct."""

import ast
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness, judge  # noqa: E402
from perfbench.run import run_cell  # noqa: E402
from veon_tpu_torch.configs import base as port_base  # noqa: E402
from veon_tpu_torch.configs import presets as port_presets  # noqa: E402

SEED = 2 ** 40 + 12345  # past 32 bits, as the benchmark's seeds are
TINY_ZOE = dict(width=32, depth=2, heads=2, patch_size=16, hooks=(0, 1, 1, 1),
                pyramid_channels=(8, 16, 16, 16), features=8, n_bins=6, bin_embedding_dim=8,
                n_attractors=(4, 2, 2, 1), lora_r=2)


def _tiny_zoe(num_temporal=1):
    cfg = port_presets.veon_tiny_test(num_temporal)
    return dataclasses.replace(cfg, depth_mode="zoedepth", zoe=port_base.ZoeConfig(**TINY_ZOE),
                               data=dataclasses.replace(cfg.data, depth_norm_method="midas"))


def _tiny_l(num_temporal=1):
    """The miniature in VEON-L's shape: CLIP patch 14 on a 32x88 CLIP
    input it does not divide (2x6 tokens from a 3x3 pretrain grid), HSA
    blocks that take the CLIP grid of one layer and add another, and a
    deep-CLIP rerun over the two layers after `feature_last_layer_idx`."""
    cfg = port_presets.veon_tiny_test(num_temporal)
    san = dataclasses.replace(cfg.san, clip_patch_size=14, clip_pretrain_grid=(3, 3),
                              clip_layers=5, feature_last_layer_idx=3)
    hsa = dataclasses.replace(cfg.hsa, fusion_map=((0, 1, 2), (1, 2, 3)), manip_attn_layers=2)
    return dataclasses.replace(cfg, san=san, hsa=hsa)


@pytest.fixture
def miniatures(monkeypatch):
    """The zoe and the VEON-L-shaped miniature as presets of the port, for
    the test only; the reference builds them from the cell's file."""
    monkeypatch.setattr(port_presets, "veon_tiny_zoe", _tiny_zoe, raising=False)
    monkeypatch.setattr(port_presets, "veon_tiny_l", _tiny_l, raising=False)


def tiny_cell(traffic: str, preset: str = "veon_tiny_test", dtype: str = "float32",
              config: str = "veon_b"):
    """A cell of the traffic mix `traffic` at the port's miniature preset
    `preset`, with the end-to-end metrics and limits of the manifest's
    cell of that mix on `config`."""
    sizes = harness._as_lists(dataclasses.asdict(getattr(port_presets, preset)()))
    sizes.pop("num_temporal")
    sizes.pop("compute_dtype")
    bench = harness.manifest()
    w = next(w["name"] for w in bench["workloads"]
             if w["traffic"] == traffic and w["config"] == config)
    tr = dict(harness.load_json(harness.BENCH / "traffic" / f"{traffic}.json"),
              pool_frames=3, check_within=2, profiled_requests=2)
    conf = {"name": "tiny", "preset": preset, "compute_dtype": dtype, "sizes": sizes}
    return dataclasses.replace(harness.find_cell(w, bench), config=conf, traffic=tr)


# ----------------------------------------------------------- the imports --

FORBIDDEN = {"jax", "jaxlib", "flax", "veon_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant):
                    yield str(arg.value), 0


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports(path):
    in_reference = (ROOT / "perfbench" / "reference") in path.parents
    depth = len(path.relative_to(ROOT / "perfbench" / "reference").parts) - 1 \
        if in_reference else 0
    for name, level in _imports(path):
        top = name.split(".")[0]
        if level == 0:
            assert top not in FORBIDDEN, f"{path} imports {name}"
            if in_reference:
                assert top not in ("veon_tpu_torch", "perfbench"), f"{path} imports {name}"
        elif in_reference:
            assert level <= depth + 1, f"{path} imports {'.' * level}{name} from outside reference/"


# ------------------------------------------------- the port vs reference --

def _program(cell):
    drv = harness.driver(cell.traffic)
    return drv, drv.build_program(torch, cell, SEED, torch.device("cpu"))


@pytest.mark.parametrize("preset", ["veon_tiny_test", "veon_tiny_zoe", "veon_tiny_l"])
def test_stream_t2_two_requests(preset, miniatures):
    cell = tiny_cell("stream_t2", preset)
    drv, (cfg, _model, handler) = _program(cell)
    frames = drv.make_frames(torch, cfg, cell.traffic, SEED, 2, torch.device("cpu"))
    keep = drv.Keep(handler)
    served = [handler(**f)["pred"] for f in frames]
    ref = judge.RefServing(cell.config, 2, SEED, "cpu")
    prev = ref.early(frames[0])
    out = ref.step(frames[1], frames[0], prev)
    np.testing.assert_array_equal(served[1], out["pred"].numpy())
    rec = {n: v.float().numpy() for n, v in keep.latest.items()}
    torch.testing.assert_close(torch.from_numpy(rec["vox"]), out["early_vox"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.from_numpy(rec["prev_vox"]), prev, rtol=1e-5, atol=1e-6)
    nums = judge.serving_numbers(ref, frames, {1: dict(rec, pred=served[1])})
    assert nums["pred_mismatch"] == 0.0
    assert max(nums.values()) < 1e-5, nums


@pytest.mark.parametrize("preset", ["veon_tiny_test", "veon_tiny_zoe", "veon_tiny_l"])
def test_single_frame_request(preset, miniatures):
    cell = tiny_cell("frame_f1", preset)
    drv, (cfg, _model, handler) = _program(cell)
    frames = drv.make_frames(torch, cfg, cell.traffic, SEED, 2, torch.device("cpu"))
    keep = drv.Keep(handler)
    served = handler(**frames[1])["pred"]
    ref = judge.RefServing(cell.config, 1, SEED, "cpu")
    out = ref.step(frames[1])
    np.testing.assert_array_equal(served, out["pred"].numpy())
    rec = {n: v.float().numpy() for n, v in keep.latest.items()}
    torch.testing.assert_close(torch.from_numpy(rec["vox"]), out["early_vox"], rtol=1e-5, atol=1e-6)
    nums = judge.serving_numbers(ref, frames, {1: dict(rec, pred=served)})
    assert nums["pred_mismatch"] == 0.0
    assert max(nums.values()) < 1e-5, nums


# ------------------------------------------- a whole run, faults planted --

def _altered_voxels(handler):
    """The frame's voxels altered where the streaming step produces them."""
    step = handler.session.step
    forward = step.forward

    def altered(*a, **k):
        out = forward(*a, **k)
        out["early_vox"] = out["early_vox"] * 1.25
        return out

    step.forward = altered


def _flipped_voxels(handler):
    """The frame's voxels mirrored along x (a flipped grid) where the
    streaming step produces them: every channel's mean stays as it was."""
    step = handler.session.step
    forward = step.forward

    def flipped(*a, **k):
        out = forward(*a, **k)
        out["early_vox"] = out["early_vox"].flip(3)
        return out

    step.forward = flipped


def _unrolled_cache(handler):
    """The session's step returns its state unchanged: no frame is cached."""
    session = handler.session
    infer = session.infer

    def stuck(*a, **k):
        vox, l2g, calls = session._vox, session._l2g, session.calls
        out = infer(*a, **k)
        session._vox, session._l2g, session.calls = vox, l2g, calls
        return out

    session.infer = stuck


def _fusion_skipped(handler):
    """The 3D head runs without the previous frame: no temporal fusion."""
    alignnet = handler.session.model.alignnet
    forward = alignnet.forward
    alignnet.forward = lambda x, prevs=None, train=False: forward(x, None, train)


def _altered_grid(handler):
    """The served grid altered where the step produces it: one row of
    voxels given the next class."""
    step = handler.session.step
    forward = step.forward

    def altered(*a, **k):
        out = forward(*a, **k)
        pred = out["pred"].clone()
        pred[:, 0] = (pred[:, 0] + 1) % 18
        out["pred"] = pred
        return out

    step.forward = altered


def _flipped_lift(handler):
    """The single frame's lifted voxels mirrored along x on their way into
    the 3D head: every channel's mean stays as it was."""
    handler.server.model.alignnet.register_forward_pre_hook(
        lambda m, a: (a[0].flip(3),) + tuple(a[1:]))


def _altered_grid_f1(handler):
    """The single frame's served grid altered where the server produces
    it: one row of voxels given the next class."""
    server = handler.server
    infer = server.infer

    def altered(*a, **k):
        out = infer(*a, **k)
        pred = out["pred"].clone()
        pred[:, 0] = (pred[:, 0] + 1) % 18
        out["pred"] = pred
        return out

    server.infer = altered


# (config whose cell's limits judge, mix, fault, miniature); the fusion
# left out is a fault of the zoe cell only, whose limits hold the logits
# after the lift; the VEON-L-shaped miniature has no preset in the
# reference, which builds it from the cell's file alone
RUNS = [("veon_b", "stream_t2", f, "veon_tiny_test") for f in (
    None, _altered_voxels, _flipped_voxels, _unrolled_cache, _altered_grid)] + [
    ("veon_b_zoe", "stream_t2", f, "veon_tiny_test") for f in (None, _fusion_skipped)] + [
    ("veon_b", "frame_f1", f, "veon_tiny_test") for f in (
        None, _flipped_lift, _altered_grid_f1)] + [
    ("veon_b", "stream_t2", f, "veon_tiny_l") for f in (None, _altered_voxels)] + [
    ("veon_b", "frame_f1", f, "veon_tiny_l") for f in (None, _flipped_lift)]


def _run_id(config, traffic, fault, preset):
    miniature = "" if preset == "veon_tiny_test" else f"-{preset}"
    return f"{config}.{traffic}{miniature}-{fault.__name__ if fault else 'sound'}"


@pytest.mark.parametrize("config,traffic,fault,preset", RUNS, ids=[_run_id(*r) for r in RUNS])
def test_run_correct(config, traffic, fault, preset, miniatures):
    """A whole run at a miniature size on the CPU, judged by the limits
    of the manifest's cell of that configuration and mix: sound, it is
    correct; with a fault planted in the timed path, it is not."""
    cell = tiny_cell(traffic, preset, config=config)
    assert cell.limits, "the cell has no limits"
    res = run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter(), program_hook=fault)
    assert res["correct"] is (fault is None), res["numbers"]
    assert res["attempted"] > 0 and set(res["metrics"]) == {
        m["name"] for m in cell.end_to_end}


# ---------------------------------------------------- on the card only --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in harness.manifest()["workloads"]])
def test_control_is_not_correct(workload, card):
    """The reference in fp8 (the next precision below bf16) in the
    program's place fails the cell's limits, at the cell's own size."""
    from perfbench.control import control_numbers

    cell = harness.find_cell(workload)
    nums = control_numbers(cell, SEED, 200, card)
    assert not harness.judge(nums, cell.limits), nums
