"""Depth tower (`nn/dpt.py` DA-V2, `nn/zoedepth.py` ZoeDepth-NK): device ms
of the program's `model.depth` span (`VeonModel.estimate_depth`, the
resize to half the input included), mean per request of the profiled
stretch; twin of `depth_ms.serve`."""

from perfbench.metrics import _spans


def read(records):
    return _spans.mean(_spans.ms(r, ("model.depth",)) for r in _spans.stretch(records))
