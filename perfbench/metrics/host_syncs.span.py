"""Session: the calls per request that made the host wait for the card
(`cudaStreamSynchronize` behind a pageable copy, a readback), the
program's `host_syncs` counter from PyTorch's sync debug mode, counted in
the span where each happens. Mean per request of the profiled
stretch."""

from perfbench.metrics import _spans


def read(records):
    return _spans.mean(r["counters"].get("host_syncs", 0) for r in _spans.stretch(records))
