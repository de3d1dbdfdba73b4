"""The port's tracer (`veon_tpu_torch/utils/tracing.py`) on the CPU at the
tiny preset: nothing recorded while it is off, the named spans of F=1 and
T=2 requests with their parents, the upload counters against the
request's bytes, a request traced because a profiler records, the spans'
host clock against the profiler's own events, the host waits counted from
the sync debug mode's warnings, the set-up spans, the ring's bound, and
`torch.export` of the streaming step, which holds no span."""

import warnings

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one thread)

from veon_tpu_torch.configs import presets
from veon_tpu_torch.data.transforms import depth_tower_size
from veon_tpu_torch.entry import serve_entry
from veon_tpu_torch.utils import export as t_export
from veon_tpu_torch.utils import tracing

# each span of a served request and its parent's name
PARENTS = {
    "serve.request": None, "serve.check": "serve.request", "serve.upload": "serve.request",
    "serve.compute": "serve.request", "serve.readback": "serve.request",
    "session.infer": "serve.compute", "session.normalize": "session.infer",
    "session.merge": "session.infer", "session.cache": "session.infer",
    "model.depth": "session.infer", "model.clip": "session.infer",
    "model.side_adapter": "session.infer", "model.rec_head": "session.infer",
    "model.hsa": "session.infer", "model.rec_rerun": "session.infer",
    "model.lift": "session.infer", "model.warp": "session.infer",
    "model.alignnet": "session.infer", "model.temporal_fusion": "model.alignnet",
    "model.output": "session.infer",
}
TEMPORAL_ONLY = {"session.cache", "model.warp", "model.temporal_fusion"}
# the span that each run of CLIP blocks opens, once under each of these
CLIP_BLOCKS_PARENTS = ("model.clip", "model.rec_head", "model.rec_rerun")


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _handler(num_temporal):
    cfg = presets.veon_tiny_test(num_temporal=num_temporal)
    handler, *_ = serve_entry(cfg, device="cpu", raw_uint8=True)
    return cfg, handler


@pytest.fixture(scope="module")
def f1():
    return _handler(1)


@pytest.fixture(scope="module")
def t2():
    return _handler(2)


def _request(cfg, k=0):
    rng = np.random.default_rng(k)
    N, (H, W) = cfg.data.num_cams, cfg.data.input_size
    dh, dw = depth_tower_size(cfg.data)
    req = {"imgs": rng.integers(0, 256, (1, 1, N, H, W, 3), dtype=np.uint8),
           "depth_imgs": rng.integers(0, 256, (1, 1, N, dh, dw, 3), dtype=np.uint8)}
    if cfg.num_temporal > 1:
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 2.0 * k
        req["lidarego2global"] = pose[None]
    return req


def _parents(rec):
    spans = rec["spans"]
    return [(s["name"], None if s["parent"] is None else spans[s["parent"]]["name"])
            for s in spans]


def _expected(temporal):
    """The sorted (name, parent's name) pairs of a served request."""
    pairs = [(n, p) for n, p in PARENTS.items() if temporal or n not in TEMPORAL_ONLY]
    return sorted(pairs + [("clip.blocks", p) for p in CLIP_BLOCKS_PARENTS])


def test_off_records_nothing_and_reads_no_clock(f1, monkeypatch):
    """Off, with no profiler recording: `span` gives the shared no-op, and a
    served request builds no span or request, reads no clock and makes no
    CUDA event."""
    cfg, handler = f1

    def boom(*a, **k):
        raise AssertionError("the tracer worked while off")

    class NoClock:
        time_ns = staticmethod(boom)

    assert tracing.span("model.lift") is tracing._NOOP
    assert tracing.request() is tracing._NOOP and tracing.attach(None) is tracing._NOOP
    monkeypatch.setattr(tracing, "time", NoClock)
    monkeypatch.setattr(tracing, "_Span", boom)
    monkeypatch.setattr(tracing, "_Request", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert handler(**_request(cfg))["pred"].dtype == np.uint8
    assert tracing.requests() == []


def test_f1_request_spans(f1):
    """One F=1 request: one request id, each span of the table but the
    temporal ones, each under its parent and inside its parent's host
    interval."""
    cfg, handler = f1
    tracing.enable()
    handler(**_request(cfg))
    (rec,) = tracing.requests()
    pairs = _parents(rec)
    assert sorted(pairs) == _expected(False), pairs
    spans = rec["spans"]
    for s in spans:
        assert s["t1_ns"] >= s["t0_ns"] and s["device_ms"] is None
        if s["parent"] is not None:
            up = spans[s["parent"]]
            assert up["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= up["t1_ns"], s["name"]
    assert spans[0]["thread"] != spans[1]["thread"]  # the caller's and the worker's
    assert set(rec["launches"]) == {"bev_pool_pooled", "bev_pool_sorted", "bev_pool_sorted2",
                                    "ln_dense", "deform_stencil"}


def test_t2_requests_spans(t2):
    """Two T=2 requests: two request ids, each with every span of the table
    under its parent, the warp and the fusion once."""
    cfg, handler = t2
    tracing.enable()
    handler(**_request(cfg, 1))
    handler(**_request(cfg, 2))
    recs = tracing.requests()
    assert len(recs) == 2 and recs[0]["id"] != recs[1]["id"]
    for rec in recs:
        pairs = _parents(rec)
        assert sorted(pairs) == _expected(True), pairs


@pytest.mark.parametrize("mode", ["f1", "t2"])
def test_upload_counters_hold_the_request_bytes(mode, request):
    """`h2d_bytes` of the uploads equals the request's tensor bytes, one
    copy per tensor; `d2h_bytes` is the served grid's; the request's totals
    are the sums of its spans' counters."""
    cfg, handler = request.getfixturevalue(mode)
    req = _request(cfg, 3)
    tracing.enable()
    pred = handler(**req)["pred"]
    (rec,) = tracing.requests()
    up = [s["counters"] for s in rec["spans"] if s["name"] == "serve.upload"]
    assert sum(c["h2d_bytes"] for c in up) == sum(v.nbytes for v in req.values())
    assert sum(c["h2d_copies"] for c in up) == len(req)
    assert rec["counters"]["d2h_bytes"] == pred.nbytes
    for key, total in rec["counters"].items():
        assert total == sum(s["counters"].get(key, 0) for s in rec["spans"]), key
    merge = next(s for s in rec["spans"] if s["name"] == "session.merge")
    # the frame server's merge uploads one index tensor a class on each call;
    # a session's indices live on the device from its construction
    want = 0 if handler.session is not None else len(handler.server.membership)
    assert merge["counters"].get("h2d_copies", 0) == want


def test_request_under_a_profiler_is_traced(t2):
    """With tracing not enabled, the request served while `torch.profiler`
    records is traced, the next one not; `serve.request`'s host start and
    end lie within 1 ms of its own `record_function` event in the
    profiler's results, on the same clock."""
    cfg, handler = t2
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        handler(**_request(cfg, 4))
    handler(**_request(cfg, 5))
    (rec,) = tracing.requests()
    assert {s["name"] for s in rec["spans"]} == set(PARENTS) | {"clip.blocks"}
    root = rec["spans"][0]
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "serve.request"]
    assert abs(ev.start_ns() - root["t0_ns"]) < 1_000_000
    assert abs(ev.end_ns() - root["t1_ns"]) < 1_000_000
    assert not tracing._on


def test_host_waits_counted_where_they_happen():
    """A sync warning counts in the innermost span and its request and is
    not shown; another warning is shown once the request is done; a span
    opened outside any request is a request of its own."""
    tracing.enable()
    with pytest.warns(UserWarning, match="another warning"):
        with tracing.span("session.infer"):
            with tracing.span("session.merge"):
                warnings.warn(tracing.SYNC_WARNING)
                warnings.warn("another warning")
            warnings.warn(tracing.SYNC_WARNING + " (Triggered internally)")
            tracing.count("h2d_bytes", 8)
    (rec,) = tracing.requests()
    infer, merge = rec["spans"]
    assert merge["counters"] == {"host_syncs": 1} and merge["parent"] == 0
    assert infer["counters"] == {"host_syncs": 1, "h2d_bytes": 8}
    assert rec["counters"] == {"host_syncs": 2, "h2d_bytes": 8}
    assert tracing._capture is None


def test_setup_spans(t2):
    """serve_entry's set-up spans: the model, the presort and the warm-up
    under `setup.serve_entry`, the model's build under its step."""
    by_id = {s["id"]: s for s in tracing.setup()}
    entry_span = [s for s in by_id.values() if s["name"] == "setup.serve_entry"][-1]
    kids = {s["name"]: s for s in by_id.values() if s["parent"] == entry_span["id"]}
    assert set(kids) == {"setup.serving_model", "setup.presort", "setup.warm"}
    assert any(s["name"] == "setup.build_model" and s["parent"] == kids["setup.serving_model"]["id"]
               for s in by_id.values())
    total = sum(k["host_s"] for k in kids.values())
    assert 0 < total <= entry_span["host_s"]


def test_ring_keeps_the_last_requests():
    tracing.enable()
    for _ in range(tracing.RING + 3):
        with tracing.span("model.lift"):
            pass
    recs = tracing.requests()
    assert len(recs) == tracing.RING and recs[-1]["id"] - recs[0]["id"] == tracing.RING - 1


def test_export_of_the_streaming_step_holds_no_span(t2):
    """`torch.export` of the tiny served streaming step gives the same graph
    with tracing on as off, and records nothing."""
    cfg, handler = t2
    session = handler.session
    req = _request(cfg, 6)
    metas = dict(session.rig_metas, lidarego2global=torch.from_numpy(req["lidarego2global"]))
    args = (torch.from_numpy(req["imgs"]), torch.from_numpy(req["depth_imgs"]), metas,
            session.ov_weight, *session.state(), torch.zeros(cfg.propagation.clip_proj_dim))
    off = [str(n.target) for n in t_export.export_program(session.step, args).graph.nodes]
    tracing.enable()
    on = [str(n.target) for n in t_export.export_program(session.step, args).graph.nodes]
    assert on == off and tracing.requests() == []
    assert not any("profiler" in t for t in on)
