"""The streaming session's CUDA graphs (`veon_tpu_torch/utils/graphs.py`,
`serve/streaming.py` `TemporalSession.capture`) and the `graph_replays`
metric that reads them (`perfbench/metrics/graph_replays.py`).

On the CPU, at the tiny preset: a session runs every region of its step
eagerly and counts each in `graph_eager`, off the card, under a cam group
and while compiling; the step's prepared normalize constants and merge
indices give outputs bit-equal to the per-call uploads (at `veon_tiny_test`
and at the VEON-L-shaped miniature); the frame server, which has no
regions, serves as before; the reader on hand-made tracer records.

On the card (marked `cuda`, skipped without one; run there without the
JAX conftest, `python -m pytest --noconftest -m cuda
tests/test_torch_session_graphs.py`): the graphed session of
`serve_entry` against an eager session on the same weights over five
T=2 requests and a reset, at `veon_tiny_test` and at the published
`veon_b_zoe` sizes; the tensors it returns left alone by later requests;
hooks and wrappers placed after the capture firing once a request; and
the traced request's spans, counters and launches against the eager
session's."""

import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench.metrics import _spans  # noqa: E402
from veon_tpu_torch.collectives import CamGroup  # noqa: E402
from veon_tpu_torch.configs import presets  # noqa: E402
from veon_tpu_torch.data.transforms import (depth_tower_size, normalize_consts,  # noqa: E402
                                            normalize_in_graph)
from veon_tpu_torch.entry import ServeHandler, fused_classes, serve_entry  # noqa: E402
from veon_tpu_torch.serve.streaming import TemporalSession  # noqa: E402
from veon_tpu_torch.utils import graphs, tracing  # noqa: E402

torch.set_num_threads(1)

# the regions of a T=2 request, in the order its step calls them
REGIONS = ("depth", "warp", "clip.embed", "clip.blocks", "side_adapter", "rec_head.tokens",
           "rec_head.blocks", "rec_head.out", "hsa", "rec_rerun.blocks", "lift",
           "temporal_fusion", "alignnet.head")


def tiny_l(num_temporal=1):
    """VEON-L's shape at a miniature size (as `test_torch_veon_l.py`'s)."""
    cfg = presets.veon_tiny_test(num_temporal)
    san = dataclasses.replace(cfg.san, clip_patch_size=14, clip_pretrain_grid=(3, 3),
                              clip_layers=5, feature_last_layer_idx=3)
    hsa = dataclasses.replace(cfg.hsa, fusion_map=((0, 1, 2), (1, 2, 3)), manip_attn_layers=2)
    return dataclasses.replace(cfg, san=san, hsa=hsa)


MINIATURES = {"veon_tiny_test": presets.veon_tiny_test, "veon_tiny_l": tiny_l}


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def frame(cfg, k=0):
    """A raw uint8 request of `cfg`'s frame, with a pose to a session."""
    rng = np.random.default_rng(k)
    N, (H, W) = cfg.data.num_cams, cfg.data.input_size
    dh, dw = depth_tower_size(cfg.data)
    req = {"imgs": rng.integers(0, 256, (1, 1, N, H, W, 3), dtype=np.uint8),
           "depth_imgs": rng.integers(0, 256, (1, 1, N, dh, dw, 3), dtype=np.uint8)}
    if cfg.num_temporal > 1:
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3], pose[1, 3] = 2.0 * k, 0.5 * k
        req["lidarego2global"] = pose[None]
    return req


def on(device, req):
    """The request's frame as the handler hands it to the session."""
    t = {k: torch.from_numpy(v).to(device) for k, v in req.items()}
    return t["imgs"], t["depth_imgs"], {"lidarego2global": t["lidarego2global"]}


def traced(handler, req):
    """One request through the handler with tracing on: (response, record)."""
    tracing.enable()
    try:
        resp = handler(**req)
    finally:
        tracing.disable()
    return resp, tracing.requests()[-1]


@pytest.fixture
def called(monkeypatch):
    """The names of the regions each step calls, in order."""
    names = []
    call = graphs.StepGraphs.call

    def record(self, name, fn, args):
        names.append(name)
        return call(self, name, fn, args)

    monkeypatch.setattr(graphs.StepGraphs, "call", record)
    return names


@pytest.fixture(scope="module")
def cpu_t2():
    cfg = presets.veon_tiny_test(num_temporal=2)
    handler, *_ = serve_entry(cfg, device="cpu", raw_uint8=True)
    return cfg, handler


@pytest.fixture
def one_rank_group():
    """A cam group of one rank on the gloo backend, in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield CamGroup(dist.group.WORLD, 1, 0)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("why", ["cpu", "cam_group"])
def test_session_runs_eager_and_counts_it(why, cpu_t2, called, request):
    """Off the card and under a cam group the session captures nothing
    (computing nothing) and runs each region of its step eagerly, in the
    step's order, each counted in `graph_eager` where it runs; nothing
    replays."""
    cfg, handler = cpu_t2
    if why == "cam_group":
        cg = request.getfixturevalue("one_rank_group")
        handler, *_ = serve_entry(cfg, device="cpu", raw_uint8=True, cam_group=cg)
        called.clear()  # its warm-up's
    req = frame(cfg, 1)
    assert handler.capture(**req) is False and called == []
    assert handler.session.graphs.regions == {}
    _resp, rec = traced(handler, req)
    assert tuple(called) == REGIONS
    assert rec["counters"]["graph_eager"] == len(REGIONS)
    assert "graph_replays" not in rec["counters"]
    spans = rec["spans"]
    per_span = [s["name"] for s in spans for _ in range(s["counters"].get("graph_eager", 0))]
    assert per_span.count("clip.blocks") == 3 and per_span.count("model.rec_head") == 2
    assert all(n.startswith(("model.", "clip.")) for n in per_span), per_span


def test_session_while_compiling_enters_no_region(cpu_t2, called, monkeypatch):
    """While compiling, each region is the plain call (the step never
    enters the session's regions; the tracer records nothing), capture
    computes nothing, and the served grid is the eager one."""
    cfg, handler = cpu_t2
    session, req = handler.session, frame(cfg, 2)
    session.reset()
    want = session.infer(*on("cpu", req))
    session.reset()
    called.clear()
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert session.capture(*on("cpu", req)) is False
    tracing.enable()
    got = session.infer(*on("cpu", req))
    assert called == [] and tracing.requests() == []
    for k in ("pred", "bin_occ", "sem_occ_raw"):
        assert torch.equal(got[k], want[k]), k
    session.reset()


@pytest.mark.parametrize("preset", sorted(MINIATURES))
def test_prepared_constants_are_bit_equal(preset):
    """The step's normalize constants and merge indices, put on the device
    once by the session, give outputs bit-equal to those it uploads on each
    call, and the normalize and merge then upload nothing."""
    cfg = MINIATURES[preset](2)
    handler, *_ = serve_entry(cfg, device="cpu", raw_uint8=True)
    session = handler.session
    step = session.step
    imgs, depth_imgs, metas = on("cpu", frame(cfg, 3))
    args = (imgs, depth_imgs, dict(session.rig_metas, **metas), session.ov_weight,
            *session.state(), session._zero_embed)
    outs, uploads = [], []
    for prepared in (True, False):
        keep = step._norm, step._groups
        if not prepared:
            step._norm, step._groups = (None, None), None
        tracing.enable()
        try:
            with tracing.span("session.infer"):
                outs.append(step(*args))
        finally:
            tracing.disable()
            step._norm, step._groups = keep
        rec = tracing.requests()[-1]
        uploads.append(sum(s["counters"].get("h2d_copies", 0) for s in rec["spans"]
                           if s["name"] in ("session.normalize", "session.merge")))
    assert set(outs[0]) == set(outs[1])
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    per_call = sum(t is not None for norm in step._norm for t in norm)
    assert uploads == [0, per_call + len(session.membership)]


def test_frame_server_unchanged():
    """The single-frame server has no session step: its request's spans are
    the F=1 table's, with no graph counter, it uploads the normalize's
    constants and one merge index a class on each call, and its grid is
    the plain composition of the model's forward and the class merge."""
    from test_torch_tracing import _expected, _parents

    cfg = presets.veon_tiny_test()
    handler, *_ = serve_entry(cfg, device="cpu", raw_uint8=True)
    server, req = handler.server, frame(cfg, 4)
    assert handler.capture(**req) is False
    resp, rec = traced(handler, req)
    assert sorted(_parents(rec)) == _expected(False)
    assert not {"graph_replays", "graph_eager"} & set(rec["counters"])
    by_name = {s["name"]: s["counters"] for s in rec["spans"]}
    assert by_name["session.merge"]["h2d_copies"] == len(server.membership)
    consts = [normalize_consts(m, "cpu") for m in ("clipsan", cfg.data.depth_norm_method)]
    assert by_name["session.normalize"]["h2d_copies"] == sum(
        t is not None for c in consts for t in c)
    imgs, depth_imgs = (torch.from_numpy(req[k]) for k in ("imgs", "depth_imgs"))
    with torch.no_grad():
        out = server.model.full_forward(normalize_in_graph(imgs, "clipsan"),
                                        normalize_in_graph(depth_imgs,
                                                           cfg.data.depth_norm_method),
                                        server.metas, server.ov_weight)
        want = fused_classes(out, server.membership).to(torch.uint8)
    np.testing.assert_array_equal(resp["pred"], want.numpy())


# ---------------------------------------------------------------- the reader --

def reader():
    return harness.load_module(harness.BENCH / "metrics" / "graph_replays.py",
                               "test_metric_graph_replays").read


def record(replays):
    counters = {} if replays is None else {"graph_replays": replays}
    return {"id": 1, "spans": [], "counters": counters, "launches": {}}


@pytest.fixture
def fake_tracer(monkeypatch):
    fake = types.SimpleNamespace(reqs=[])
    fake.requests = lambda: list(fake.reqs)
    monkeypatch.setattr(_spans, "tracer", lambda: fake)
    return fake


@pytest.mark.parametrize("counts,want", [([13, 13, 13], 13.0), ([99, 13, 12], 12.5),
                                         ([13, None, None], 0.0)])
def test_reader_mean_per_request(counts, want, fake_tracer):
    """The mean of the stretch's requests (the last `items`), a request
    without the counter reading 0, as the frame server's do."""
    fake_tracer.reqs = [record(c) for c in counts]
    assert reader()({"profile": {"items": 2}}) == pytest.approx(want)


def test_reader_reads_nothing_without_tracer_stretch_or_graphs(fake_tracer, monkeypatch):
    fake_tracer.reqs = [record(13)]
    read = reader()
    assert read({}) is None
    assert read({"profile": {"items": 2}}) is None
    monkeypatch.setattr(_spans, "tracer", lambda: None)
    assert read({"profile": {"items": 1}}) is None
    monkeypatch.setattr(_spans, "tracer", lambda: fake_tracer)
    assert read({"profile": {"items": 1}}) == 13
    import importlib.util

    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None)
    assert read({"profile": {"items": 1}}) is None


# ------------------------------------------------------------------ the card --

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_CONFIGS = {
    "veon_tiny_test": lambda: presets.veon_tiny_test(num_temporal=2),
    "veon_b_zoe": lambda: presets.veon_b_zoe(num_temporal=2, compute_dtype="bfloat16"),
}


@pytest.fixture(scope="module")
def graphed(card):
    """Per preset: (cfg, the graphed handler of `serve_entry`, an eager
    session on the same weights)."""
    cache = {}

    def get(preset):
        if preset not in cache:
            cache.clear()
            torch.cuda.empty_cache()
            cfg = CARD_CONFIGS[preset]()
            handler, *_ = serve_entry(cfg, device=card, raw_uint8=True)
            s = handler.session
            eager = TemporalSession(s.model, s.ov_weight, s.membership, rig_metas=s.rig_metas,
                                    normalize=s.step.normalize)
            cache[preset] = cfg, handler, eager
        return cache[preset]

    return get


VIEWS = ("bin_occ", "sem_occ_raw", "pred")


@pytest.mark.cuda
@pytest.mark.parametrize("preset", sorted(CARD_CONFIGS))
def test_graphed_session_equals_eager(preset, graphed, card):
    """Five T=2 requests and, after a reset of both, one more: the graphed
    session's cached voxels, raw outputs and grid equal the eager
    session's bit for bit, every region replaying."""
    cfg, handler, eager = graphed(preset)
    session = handler.session
    assert sorted(k for k, _ in session.graphs.regions) == sorted(REGIONS)
    session.reset()
    eager.reset()
    for k in range(6):
        if k == 5:
            session.reset()
            eager.reset()
        req = frame(cfg, 10 + k)
        got, want = session.infer(*on(card, req)), eager.infer(*on(card, req))
        pairs = [("vox", session.state()[0], eager.state()[0])]
        pairs += [(v, got[v], want[v]) for v in VIEWS]
        for name, a, b in pairs:
            diff = (a.float() - b.float()).abs().max().item()
            assert torch.equal(a, b), f"request {k}: {name} differs by {diff}"
    session.reset()


@pytest.mark.cuda
def test_returned_tensors_stay(graphed, card):
    """What `state()` and `infer` return after request k is the caller's:
    three more requests leave it as it was."""
    cfg, handler, _eager = graphed("veon_tiny_test")
    session = handler.session
    session.reset()
    held = None
    for k in range(5):
        out = session.infer(*on(card, frame(cfg, 20 + k)))
        if k == 1:
            vox, l2g = session.state()
            held = [vox, l2g] + [out[v] for v in VIEWS] + [out["feat_occ"]]
            copies = [t.clone() for t in held]
    for a, b in zip(held, copies):
        assert torch.equal(a, b)
    session.reset()


@pytest.mark.cuda
def test_hooks_placed_after_capture_fire(graphed, card):
    """A forward pre-hook on `alignnet` and a wrapper on `align_to_prev`,
    placed after the capture, fire once a request while every region
    replays; a hook on a module inside a region runs that region eagerly
    (and fires) until it is removed."""
    cfg, handler, _eager = graphed("veon_tiny_test")
    model = handler.session.model
    seen = {"alignnet": 0, "warp": 0, "inner": 0}
    pre = model.alignnet.register_forward_pre_hook(
        lambda m, a: seen.__setitem__("alignnet", seen["alignnet"] + 1))
    warp = model.align_to_prev

    def wrapped(*a, **k):
        seen["warp"] += 1
        return warp(*a, **k)

    model.align_to_prev = wrapped
    try:
        for k in range(2):
            _resp, rec = traced(handler, frame(cfg, 30 + k))
            assert rec["counters"].get("graph_replays") == len(REGIONS)
            assert "graph_eager" not in rec["counters"]
        assert seen == {"alignnet": 2, "warp": 2, "inner": 0}
        inner = model.alignnet.res3d[0]["block"].register_forward_hook(
            lambda m, a, o: seen.__setitem__("inner", seen["inner"] + 1))
        _resp, rec = traced(handler, frame(cfg, 32))
        inner.remove()
        assert seen["inner"] == 1
        assert rec["counters"]["graph_eager"] == 1
        assert rec["counters"]["graph_replays"] == len(REGIONS) - 1
        _resp, rec = traced(handler, frame(cfg, 33))
        assert rec["counters"]["graph_replays"] == len(REGIONS)
    finally:
        pre.remove()
        del model.align_to_prev
    assert seen["alignnet"] == 4 and seen["warp"] == 4


@pytest.mark.cuda
def test_traced_request_against_eager(graphed, card):
    """A traced request of the graphed handler has the eager handler's
    spans under the same parents, its `clip_token_layers` and its kernel
    launches (#1 once, #5 twice), and waits for the card only at the
    handler's three uploads and its readback."""
    cfg, handler, eager = graphed("veon_tiny_test")
    plain = ServeHandler(cfg, handler.text_tower, session=eager, raw_uint8=True)
    req = frame(cfg, 40)
    recs = []
    for h in (handler, plain):
        h.session.reset()
        recs.append(traced(h, req)[1])
    g, e = recs

    def pairs(rec):
        spans = rec["spans"]
        return sorted((s["name"], None if s["parent"] is None else spans[s["parent"]]["name"])
                      for s in spans)

    assert pairs(g) == pairs(e)
    assert g["counters"]["clip_token_layers"] == e["counters"]["clip_token_layers"]
    assert g["launches"] == e["launches"]
    assert g["launches"]["bev_pool_pooled"] == 1 and g["launches"]["deform_stencil"] == 2
    assert g["counters"]["host_syncs"] == 4 and g["counters"]["h2d_copies"] == 3
    assert g["counters"]["graph_replays"] == len(REGIONS)
    assert e["counters"]["graph_eager"] == len(REGIONS)
    assert all(s["device_ms"] is not None for s in g["spans"])
    handler.session.reset()
