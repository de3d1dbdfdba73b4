"""VEON-L's shape through the port's streaming session on the CPU, against
the benchmark's plain reference (`perfbench/reference`, fp32, no kernel of
the port) on the benchmark's seeded weights (`perfbench/harness.py`
`make_weights`), and the spans and counter of its CLIP blocks.

The miniature has VEON-L's shape where VEON-B's differs: CLIP patch 14 on
a 32x88 CLIP input it does not divide (a 2x6 token grid from a 3x3
pretrain grid), a side-adapter grid (4x11) unlike the CLIP grid, so the
attention biases are re-gridded by uneven max pooling, HSA blocks that
take the CLIP grid of one layer and add another, and a deep-CLIP rerun
over the two layers after `feature_last_layer_idx`."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one thread)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import harness, judge  # noqa: E402
from perfbench.reference.configs import base as ref_base  # noqa: E402
from veon_tpu_torch import entry  # noqa: E402
from veon_tpu_torch.configs import presets  # noqa: E402
from veon_tpu_torch.utils import tracing  # noqa: E402

SEED = 3141592653
REQUESTS = 3
CLIP_BLOCKS_PARENTS = ("model.clip", "model.rec_head", "model.rec_rerun")


def tiny_l(num_temporal=1):
    """VEON-L's shape at a miniature size (as `perfbench/tests`' `_tiny_l`)."""
    cfg = presets.veon_tiny_test(num_temporal)
    san = dataclasses.replace(cfg.san, clip_patch_size=14, clip_pretrain_grid=(3, 3),
                              clip_layers=5, feature_last_layer_idx=3)
    hsa = dataclasses.replace(cfg.hsa, fusion_map=((0, 1, 2), (1, 2, 3)), manip_attn_layers=2)
    return dataclasses.replace(cfg, san=san, hsa=hsa)


MINIATURES = {"veon_tiny_l": tiny_l, "veon_tiny_test": presets.veon_tiny_test}


def as_file(cfg, dtype):
    """`cfg` as a benchmark configuration file holds it."""
    sizes = harness._as_lists(dataclasses.asdict(cfg))
    sizes.pop("num_temporal")
    sizes.pop("compute_dtype")
    return {"name": "tiny", "preset": "tiny", "compute_dtype": dtype, "sizes": sizes}


def token_layers(cfg) -> int:
    """The CLIP token rows times layers of one served frame: the trunk's
    pixel tokens and cls through `feature_last_layer_idx` layers, the rec
    head's deep layers over those and the `num_queries` sos rows, and the
    rerun of the deep layers over the pixel tokens and cls, each camera."""
    s = cfg.san
    h, w = (n // 2 // s.clip_patch_size for n in cfg.data.input_size)
    rows, deep = h * w + 1, s.clip_layers - s.feature_last_layer_idx
    return cfg.data.num_cams * (rows * s.feature_last_layer_idx
                                + (rows + s.num_queries) * deep + rows * deep)


def serve(preset, dtype):
    """A T=2 `serve_entry` handler of the miniature in `dtype` with the
    benchmark's weights; returns (cfg, handler, conf)."""
    cfg = dataclasses.replace(MINIATURES[preset](2), compute_dtype=dtype)
    conf = as_file(cfg, dtype)
    skel = harness.make_weights(harness.config_from_file(ref_base, conf, 2, "float32"), SEED,
                                torch.device("cpu"))
    model = entry.build_model(cfg, torch.device("cpu"), 0, None)
    model.load_state_dict(skel.state_dict(), strict=True)
    handler, *_ = entry.serve_entry(cfg, torch.device("cpu"), raw_uint8=True, model=model)
    return cfg, handler, conf


def frames(cfg, count):
    """`count` raw uint8 frames in time order with a seeded drive's poses."""
    gen = harness.rng(SEED, "test frames")
    N, (H, W) = cfg.data.num_cams, cfg.data.input_size
    dh, dw = harness.depth_tower_hw(cfg)
    poses = harness.drive_poses(count, gen)
    return [{"imgs": gen.integers(0, 256, (1, 1, N, H, W, 3), dtype=np.uint8),
             "depth_imgs": gen.integers(0, 256, (1, 1, N, dh, dw, 3), dtype=np.uint8),
             "lidarego2global": poses[k:k + 1]} for k in range(count)]


def served_requests(preset, dtype):
    """Three T=2 requests of the miniature in `dtype` through the handler:
    per request the session's cached voxels of the frame, the raw outputs
    (kept by wrapping the session's `infer`) and the served grid."""
    cfg, handler, conf = serve(preset, dtype)
    session, kept = handler.session, {}
    infer = session.infer

    def keep(*a, **k):
        out = infer(*a, **k)
        kept.update(bin_occ=out["bin_occ"], sem_occ_raw=out["sem_occ_raw"])
        return out

    session.infer = keep
    fr = frames(cfg, REQUESTS)
    got = []
    for f in fr:
        pred = handler(**f)["pred"]
        got.append(dict(kept, vox=session.state()[0][:, 0], pred=torch.from_numpy(pred)))
    return cfg, conf, fr, got


def reference_requests(ref, fr):
    """The reference's steps on the same frames, each fed its own previous
    voxels: zero voxels at an identity pose before the first, as the
    session starts."""
    prev_frame = {"lidarego2global": np.eye(4, dtype=np.float32)[None]}
    prev = torch.zeros((1,) + ref.vox_shape)
    want = []
    for f in fr:
        out = ref.step(f, prev_frame, prev)
        prev, prev_frame = out["early_vox"], f
        want.append(dict(out, vox=out["early_vox"]))
    return want


@pytest.fixture(scope="module")
def streamed():
    """Per (preset, dtype): the served requests, the reference's, the
    reference and the frames, built once."""
    cache = {}

    def get(preset, dtype):
        if (preset, dtype) not in cache:
            _cfg, conf, fr, got = served_requests(preset, dtype)
            ref = judge.RefServing(conf, 2, SEED, "cpu")
            cache[preset, dtype] = (got, reference_requests(ref, fr), ref, fr)
        return cache[preset, dtype]

    return get


def relerr(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


# fp32 on both sides: the two differ in summation order alone (fused against
# plain attention, kernel #1's plain version against `index_add_`, other
# reduction splits), a few fp32 ulps through the towers, the lift and the
# 3D head; 1e-5 relative leaves that room and catches any real difference
FP32_RTOL, FP32_ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("k", range(REQUESTS))
def test_fp32_session_equals_the_reference(k, streamed):
    """Request k of the fp32 session: its cached voxels, `bin_occ` and
    `sem_occ_raw` at the reference's within fp32 rounding, the served grid
    equal to the reference's; from the second request on, the session's
    cache feeds the temporal fusion."""
    got, want, _ref, _fr = streamed("veon_tiny_l", "float32")
    for name in ("vox", "bin_occ", "sem_occ_raw"):
        torch.testing.assert_close(got[k][name].float(), want[k][name].float(),
                                   rtol=FP32_RTOL, atol=FP32_ATOL, msg=name)
    np.testing.assert_array_equal(got[k]["pred"].numpy(), want[k]["pred"].numpy())


# bf16 against the fp32 reference, judged as the benchmark judges a served
# request (`perfbench/judge.py`): the session's voxels by their per-channel
# means over the grid and over 3x3 ground tiles, since the two-hot lift turns
# bf16 rounding of the depth into mass moved between neighbouring cells; the
# reference's warp, fusion and 3D head run on the session's own voxels against
# its raw outputs; the served grid against the merge and fusion rule of its own
# outputs, exactly. bf16 keeps 8 significant bits (2^-9 relative rounding) in
# each of the ~20 product layers; at this size the open-vocabulary logits are
# 16-term dot products with an N(0, 1) vocabulary matrix, whose cancellation
# magnifies that rounding. Four weight seeds read at most 0.018 / 0.045 /
# 0.013 / 0.143 and pred_mismatch 0; the limits leave 1.7-3.8x room, and the
# faults `perfbench/tests` plants at this miniature read above them (voxels
# scaled 1.25x: `vox_relerr` 0.25; a mirrored lift: `vox_tile_relerr` 0.091).
BF16_LIMITS = {"vox_relerr": 0.05, "vox_tile_relerr": 0.08, "occ_relerr": 0.05,
               "sem_relerr": 0.25, "pred_mismatch": 0.0}


@pytest.mark.parametrize("k", range(1, REQUESTS))
def test_bf16_session_against_the_fp32_reference(k, streamed):
    """Request k of the bf16 session (each fusing the cached voxels of the
    request before) against the fp32 reference: its outputs finite, in
    fp32 and in the reference's shapes, and within bf16's limits."""
    got, want, ref, fr = streamed("veon_tiny_l", "bfloat16")
    for name in ("vox", "bin_occ", "sem_occ_raw", "pred"):
        g, w = got[k][name], want[k][name]
        assert g.numel() == w.numel() and bool(torch.isfinite(g.float()).all()), name
    for name in ("bin_occ", "sem_occ_raw"):
        assert got[k][name].dtype == torch.float32 and got[k][name].shape == want[k][name].shape
    kept = {k: {"vox": got[k]["vox"].float().numpy(), "prev_vox": got[k - 1]["vox"].float().numpy(),
                "bin_occ": got[k]["bin_occ"].numpy(), "sem_occ_raw": got[k]["sem_occ_raw"].numpy(),
                "pred": got[k]["pred"].numpy()}}
    nums = judge.serving_numbers(ref, fr, kept)
    assert all(nums[n] <= lim for n, lim in BF16_LIMITS.items()), nums


@pytest.fixture(scope="module")
def traced():
    """Per preset: a T=2 fp32 handler's second request, traced."""
    cache = {}

    def get(preset):
        if preset not in cache:
            cfg, handler, _conf = serve(preset, "float32")
            fr = frames(cfg, 2)
            handler(**fr[0])
            tracing.clear()
            tracing.enable()
            try:
                handler(**fr[1])
            finally:
                tracing.disable()
            cache[preset] = (cfg, tracing.requests()[-1], handler, fr)
            tracing.clear()
        return cache[preset]

    return get


@pytest.mark.parametrize("preset", sorted(MINIATURES))
def test_clip_blocks_spans_and_token_layers(preset, traced):
    """Three `clip.blocks` spans a request, one under each of `model.clip`,
    `model.rec_head` and `model.rec_rerun`; `clip_token_layers`, added in
    them alone, sums to the count worked out from the configuration."""
    cfg, rec, _handler, _fr = traced(preset)
    spans = rec["spans"]
    blocks = [s for s in spans if s["name"] == "clip.blocks"]
    assert sorted(spans[s["parent"]]["name"] for s in blocks) == sorted(CLIP_BLOCKS_PARENTS)
    s = cfg.san
    h, w = (n // 2 // s.clip_patch_size for n in cfg.data.input_size)
    deep = s.clip_layers - s.feature_last_layer_idx
    by_parent = {spans[b["parent"]]["name"]: b["counters"]["clip_token_layers"] for b in blocks}
    assert by_parent == {
        "model.clip": cfg.data.num_cams * (h * w + 1) * s.feature_last_layer_idx,
        "model.rec_head": cfg.data.num_cams * (h * w + 1 + s.num_queries) * deep,
        "model.rec_rerun": cfg.data.num_cams * (h * w + 1) * deep}
    assert rec["counters"]["clip_token_layers"] == token_layers(cfg)
    assert sum(x["counters"].get("clip_token_layers", 0) for x in spans) == token_layers(cfg)


@pytest.mark.parametrize("preset,want", [("veon_l", 165_780), ("veon_b", 65_250)])
def test_token_layers_of_the_published_models(preset, want):
    """The count a served VEON-L and VEON-B request reads on the card: six
    cameras of an 18x50 (16x44) token grid, 18 (9) trunk layers and 6 (3)
    deep layers run twice, the rec head's with its 100 sos rows."""
    assert token_layers(getattr(presets, preset)()) == want


@pytest.mark.parametrize("preset", sorted(MINIATURES))
def test_nothing_recorded_with_tracing_off(preset, traced, monkeypatch):
    """Tracing off and no profiler: a served request opens no span, makes
    no request record and counts nothing."""
    cfg, _rec, handler, fr = traced(preset)

    def boom(*a, **k):
        raise AssertionError("the tracer worked while off")

    monkeypatch.setattr(tracing, "_Span", boom)
    monkeypatch.setattr(tracing, "_add", boom)
    assert tracing.span("clip.blocks") is tracing._NOOP
    handler(**fr[0])
    assert tracing.requests() == []
