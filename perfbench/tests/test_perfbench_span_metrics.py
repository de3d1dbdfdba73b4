"""The readers of the `.span` metrics (`metrics/<name>.span.py`) on
hand-made records of the program's tracer: each value from the spans and
counters it names, the profiled stretch taken as the tracer's last
`items` requests, and nothing to read without a tracer, without a
profiled stretch, with fewer traced requests than the stretch holds, or
without the spans a reader needs."""

import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench.metrics import _spans  # noqa: E402

NAMES = ("handler_ms.span", "h2d_mb.span", "host_syncs.span", "session_ms.span",
         "dispatch_ms.span", "depth_ms.span", "towers2d_ms.span", "hsa_ms.span",
         "lift_ms.span", "fusion_ms.span", "head3d_ms.span", "serve_entry_s.span")


def reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               "test_metric_" + name.replace(".", "_")).read


def request(scale=1.0, temporal=True, device=True, syncs=31):
    """A served request as `tracing.requests()` gives it: (name, parent's
    name, host ms, device ms, counters) per span, the clocks times
    `scale`; without `temporal` a single frame's, with no warp, fusion or
    cache."""
    rows = [("serve.request", None, 130, None, {"d2h_bytes": 640000}),
            ("serve.check", "serve.request", 0.1, 0.0, {}),
            ("serve.upload", "serve.request", 4.0, 3.9,
             {"h2d_bytes": 16151392, "h2d_copies": 3, "host_syncs": 3}),
            ("serve.compute", "serve.request", 120, 118, {}),
            ("session.infer", "serve.compute", 119.9, 117, {}),
            ("session.normalize", "session.infer", 0.2, 0.5, {"h2d_bytes": 52, "host_syncs": 5}),
            ("model.depth", "session.infer", 10, 28, {}),
            ("model.warp", "session.infer", 0.3, 1.0, {}),
            ("model.clip", "session.infer", 3, 10, {}),
            ("model.side_adapter", "session.infer", 2, 5, {}),
            ("model.rec_head", "session.infer", 1, 3, {}),
            ("model.hsa", "session.infer", 4, 10, {}),
            ("model.rec_rerun", "session.infer", 0.5, 2, {}),
            ("model.lift", "session.infer", 0.6, 2.5, {}),
            ("model.alignnet", "session.infer", 5, 45, {}),
            ("model.temporal_fusion", "model.alignnet", 3, 37, {"h2d_bytes": 48, "host_syncs": 4}),
            ("model.output", "session.infer", 0.4, 9, {}),
            ("session.merge", "session.infer", 60, 1.5,
             {"h2d_bytes": 2000, "host_syncs": syncs - 13}),
            ("session.cache", "session.infer", 0.1, 0.2, {}),
            ("serve.readback", "serve.request", 0.6, 0.5, {"host_syncs": 1})]
    if not temporal:
        rows = [r for r in rows if r[0] not in ("model.warp", "model.temporal_fusion",
                                                "session.cache")]
    index = {r[0]: k for k, r in enumerate(rows)}
    spans, counters = [], {}
    for name, parent, host, dev, cnt in rows:
        spans.append({"name": name, "parent": index.get(parent), "thread": "t", "t0_ns": 0,
                      "t1_ns": int(host * scale * 1e6), "host_ms": host * scale,
                      "device_ms": dev * scale if device and dev is not None else None,
                      "counters": dict(cnt)})
        for k, v in cnt.items():
            counters[k] = counters.get(k, 0) + v
    return {"id": 1, "spans": spans, "counters": counters, "launches": {"bev_pool_pooled": 1}}


@pytest.fixture
def tracer(monkeypatch):
    """A stand-in for the program's tracer holding the requests and set-up
    spans a test gives it."""
    fake = types.SimpleNamespace(reqs=[], setups=[])
    fake.requests = lambda: list(fake.reqs)
    fake.setup = lambda: list(fake.setups)
    monkeypatch.setattr(_spans, "tracer", lambda: fake)
    return fake


def profiled(items=2):
    return {"profile": {"items": items}}


# each reader's value on request() (its device and host ms, its counters)
WANT = {"handler_ms.span": 10.0, "h2d_mb.span": 16.153492, "host_syncs.span": 31,
        "session_ms.span": 117 - (28 + 1 + 10 + 5 + 3 + 10 + 2 + 2.5 + 45 + 9),
        "dispatch_ms.span": 10 + 0.3 + 3 + 2 + 1 + 4 + 0.5 + 0.6 + 5 + 0.4,
        "depth_ms.span": 28.0, "towers2d_ms.span": 18.0, "hsa_ms.span": 10.0,
        "lift_ms.span": 2.5, "fusion_ms.span": 38.0, "head3d_ms.span": 8.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_values_and_stretch(name, tracer):
    """The mean over the last `items` requests; the older ones, read by no
    metric, are left out."""
    tracer.reqs = [request(scale=5.0, syncs=90), request(), request()]
    assert reader(name)(profiled(2)) == pytest.approx(WANT[name])
    tracer.reqs[-1] = request(scale=3.0, syncs=41)
    if name == "h2d_mb.span":
        assert reader(name)(profiled(2)) == pytest.approx(WANT[name])
    elif name == "host_syncs.span":
        assert reader(name)(profiled(2)) == pytest.approx(36)
    else:
        assert reader(name)(profiled(2)) == pytest.approx(2 * WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_to_read(name, tracer, monkeypatch):
    """None without a profiled stretch, with fewer traced requests than it
    holds, and without a tracer in the program."""
    tracer.reqs = [request()]
    assert reader(name)({}) is None
    assert reader(name)(profiled(2)) is None
    monkeypatch.setattr(_spans, "tracer", lambda: None)
    assert reader(name)(profiled(1)) is None


def test_without_device_clock_or_temporal_fusion(tracer):
    """Spans with no device ms (a CPU run) leave the device readers
    nothing to read; a single-frame request leaves the fusion nothing and
    its 3D head is the whole `model.alignnet`."""
    tracer.reqs = [request(device=False)]
    for name in ("session_ms.span", "depth_ms.span", "towers2d_ms.span", "hsa_ms.span",
                 "lift_ms.span", "fusion_ms.span", "head3d_ms.span"):
        assert reader(name)(profiled(1)) is None, name
    assert reader("handler_ms.span")(profiled(1)) == pytest.approx(10.0)
    tracer.reqs = [request(temporal=False)]
    assert reader("fusion_ms.span")(profiled(1)) is None
    assert reader("head3d_ms.span")(profiled(1)) == pytest.approx(45.0)
    assert reader("session_ms.span")(profiled(1)) == pytest.approx(117 - 114.5)


def test_without_the_program_tracer(monkeypatch):
    """The parent's program, which has no `utils/tracing.py`: nothing to read."""
    import veon_tpu_torch.utils

    monkeypatch.delattr(veon_tpu_torch.utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "veon_tpu_torch.utils.tracing", None)
    assert _spans.tracer() is None
    assert reader("serve_entry_s.span")(profiled(1)) is None
    assert reader("depth_ms.span")(profiled(1)) is None


def test_serve_entry_seconds(tracer):
    """The last `setup.serve_entry` span's seconds; none, nothing."""
    assert reader("serve_entry_s.span")({}) is None
    tracer.setups = [{"name": "setup.serve_entry", "id": 1, "parent": None, "host_s": 9.0},
                     {"name": "setup.build_model", "id": 2, "parent": None, "host_s": 4.0},
                     {"name": "setup.serve_entry", "id": 3, "parent": None, "host_s": 7.5},
                     {"name": "setup.warm", "id": 4, "parent": 3, "host_s": 2.0}]
    assert reader("serve_entry_s.span")({}) == 7.5


def test_every_span_metric_has_a_reader_here():
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    span_metrics = {m["name"] for m in bench["per_layer"] if m["name"].endswith(".span")}
    assert span_metrics == set(NAMES) == set(WANT) | {"serve_entry_s.span"}
