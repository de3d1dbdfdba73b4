"""The port's profiling tools (`veon_tpu_torch/utils/profiling.py`) on the
CPU: `flops` of a Dense against its analytic count, `fps_harness`'s
protocol, `trace` writing a Chrome trace that parses and holds a worker
thread's spans, and the lift microbench's inputs at the JAX microbench's
shapes."""

import json
import os

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one thread)

from veon_tpu_torch.utils import profiling


def test_flops_of_a_linear_layer_is_analytic():
    """2 x M x K x N for a (M, K) @ (K, N) product plus bias; elementwise ops
    count nothing (FlopCounterMode counts the products)."""
    lin = torch.nn.Linear(64, 32)
    x = torch.randn(8, 5, 64)
    got = profiling.flops(lambda t: torch.relu(lin(t)) * 2.0, x)
    assert got["flops"] == 2 * 8 * 5 * 64 * 32
    assert sum(got["by_op"].values()) == got["flops"] and len(got["by_op"]) == 1


def test_flops_counts_a_convolution():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    got = profiling.flops(conv, torch.randn(1, 3, 10, 12))
    assert got["flops"] == 2 * (10 * 12) * 8 * 3 * 9


def test_fps_harness_protocol():
    """warmup + n_iters calls, fps the reciprocal of the mean time per call."""
    calls = []
    out = profiling.fps_harness(lambda: calls.append(1), n_iters=7, warmup=2, device="cpu")
    assert len(calls) == 9
    assert out["ms_per_iter"] > 0 and np.isclose(out["fps"] * out["ms_per_iter"], 1e3)


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d, device="cpu") as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert path == os.path.join(d, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_records_every_thread(tmp_path):
    """A span of `utils/tracing.py` opened on a worker thread, and the ops
    under it, are in the written trace: the serve worker computes on a
    thread of its own."""
    from concurrent.futures import ThreadPoolExecutor

    from veon_tpu_torch.utils import tracing

    def work():
        with tracing.span("model.lift"):
            return torch.ones(16, 16) @ torch.ones(16, 16)

    worker = ThreadPoolExecutor(max_workers=1)
    try:
        worker.submit(torch.ones, 1).result()  # the thread exists before the trace
        tracing.enable()
        with profiling.trace(str(tmp_path), device="cpu") as path:
            worker.submit(work).result()
    finally:
        tracing.disable()
        tracing.clear()
        worker.shutdown()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = [e for e in events if e.get("name") == "model.lift"]
    assert len(span) == 1
    assert any(e.get("name") == "aten::mm" and e.get("tid") == span[0]["tid"] for e in events)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.fps_harness(lambda: None, n_iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace():
            pass


def test_lift_inputs_match_the_jax_microbench():
    """The microbench's lift and inputs: VEON-B's production lift (512x1408
    input, /16, 200x200x16 grid, 88 bins, [2, 2, 2] pool) and the JAX
    tool's seeded arrays."""
    lift, feat, metric, metas = profiling.lift_inputs(device="cpu")
    assert lift.input_size == (512, 1408) and lift.downsample == 16
    assert lift.grid.size == (200, 200, 16) and lift.grid.num_depth_bins == 88
    assert tuple(lift.ds_feat) == (2, 2, 2)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(feat.numpy(), rng.standard_normal((1, 6, 32, 88, 256))
                                  .astype(np.float32))
    np.testing.assert_array_equal(metric.numpy(), rng.uniform(1, 44, size=(1, 6, 32, 88))
                                  .astype(np.float32))
    assert [tuple(m.shape) for m in metas] == [(1, 6, 4, 4), (1, 6, 3, 3), (1, 6, 3, 3),
                                               (1, 6, 3), (1, 3, 3)]
    assert metas[1][0, 0, 0, 0] == 780.0 and metas[1][0, 0, 0, 2] == 704.0
