"""Request handler: MB copied from the host to the card per request, the
program's `h2d_bytes` counter over its upload sites (the request's
frames and pose, the on-card normalize's constants, the class merge's
index tensors, the temporal fusion's constants) / 1e6. Mean per request
of the profiled stretch."""

from perfbench.metrics import _spans


def read(records):
    return _spans.mean(r["counters"].get("h2d_bytes", 0) / 1e6 for r in _spans.stretch(records))
