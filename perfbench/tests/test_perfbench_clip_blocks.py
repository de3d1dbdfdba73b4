"""The reader of `clip_blocks_ms` (`metrics/clip_blocks_ms.py`) on hand-made
records of the program's tracer: the summed device ms of a request's
`clip.blocks` spans, mean per request of the profiled stretch (the
tracer's last `items` requests), and nothing to read without a tracer,
without a profiled stretch, with fewer traced requests than it holds, or
without the span."""

import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench.metrics import _spans  # noqa: E402


def reader():
    return harness.load_module(harness.BENCH / "metrics" / "clip_blocks_ms.py",
                               "test_metric_clip_blocks_ms").read


def request(blocks=(4.0, 2.5, 1.5), device=True):
    """A served request as `tracing.requests()` gives it, with a
    `clip.blocks` span of each device ms in `blocks` under `model.clip`,
    `model.rec_head` and `model.rec_rerun` in turn."""
    rows = [("session.infer", None, 100.0), ("model.clip", 0, 9.0),
            ("model.side_adapter", 0, 5.0), ("model.rec_head", 0, 4.0),
            ("model.hsa", 0, 10.0), ("model.rec_rerun", 0, 2.0)]
    spans = [{"name": n, "parent": p, "host_ms": 1.0, "device_ms": d if device else None,
              "counters": {}} for n, p, d in rows]
    for parent, ms in zip((1, 3, 5), blocks):
        spans.append({"name": "clip.blocks", "parent": parent, "host_ms": 0.5,
                      "device_ms": ms if device else None,
                      "counters": {"clip_token_layers": 1000}})
    return {"id": 1, "spans": spans, "counters": {"clip_token_layers": 1000 * len(blocks)},
            "launches": {}}


@pytest.fixture
def tracer(monkeypatch):
    fake = types.SimpleNamespace(reqs=[])
    fake.requests = lambda: list(fake.reqs)
    monkeypatch.setattr(_spans, "tracer", lambda: fake)
    return fake


def profiled(items):
    return {"profile": {"items": items}}


def test_sum_per_request_mean_over_the_stretch(tracer):
    """Each request's three spans summed, the mean over the last `items`
    requests; an older request is left out."""
    tracer.reqs = [request((40.0, 40.0, 40.0)), request(), request((6.0, 3.0, 1.0))]
    assert reader()(profiled(2)) == pytest.approx(((4.0 + 2.5 + 1.5) + 10.0) / 2)
    assert reader()(profiled(1)) == pytest.approx(10.0)
    assert reader()(profiled(3)) == pytest.approx((120.0 + 8.0 + 10.0) / 3)


@pytest.mark.parametrize("case", ["no_tracer", "no_stretch", "short_stretch", "no_span",
                                  "no_device_clock"])
def test_nothing_to_read(case, tracer, monkeypatch):
    """None without the program's tracer, without a profiled stretch, with
    fewer traced requests than the stretch holds, without the span (a
    program that has none) or without device ms (a CPU run)."""
    tracer.reqs = [request(), request()]
    records = profiled(2)
    if case == "no_tracer":
        monkeypatch.setattr(_spans, "tracer", lambda: None)
    elif case == "no_stretch":
        records = {}
    elif case == "short_stretch":
        records = profiled(3)
    elif case == "no_span":
        tracer.reqs = [request(blocks=()), request(blocks=())]
    else:
        tracer.reqs = [request(device=False), request(device=False)]
    assert reader()(records) is None


def test_in_the_manifest():
    """Listed as a per-layer metric of the CLIP and SAN towers, read from
    the program's spans, moving `ms_per_frame` in the four serving cells."""
    m = next(m for m in harness.manifest()["per_layer"] if m["name"] == "clip_blocks_ms")
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "ms", "lower", "program_span", "CLIP and SAN towers", "ms_per_frame")
    assert m["workloads"] == ["veon_b.stream_t2", "veon_b_zoe.stream_t2", "veon_b.frame_f1",
                              "veon_l.stream_t2"]
