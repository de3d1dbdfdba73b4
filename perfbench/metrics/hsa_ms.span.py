"""HSA (`nn/hsa.py`): device ms of the program's `model.hsa` span, mean
per request of the profiled stretch; twin of `hsa_ms.serve`."""

from perfbench.metrics import _spans


def read(records):
    return _spans.mean(_spans.ms(r, ("model.hsa",)) for r in _spans.stretch(records))
