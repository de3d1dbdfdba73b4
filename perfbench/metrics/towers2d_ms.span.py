"""CLIP and SAN towers (`nn/vit.py`, `nn/san.py`): device ms of the
program's `model.clip` (the CLIP trunk with its input resize),
`model.side_adapter` and `model.rec_head` spans, summed per request, mean
per request of the profiled stretch; twin of `towers2d_ms.serve`."""

from perfbench.metrics import _spans


def read(records):
    return _spans.mean(_spans.ms(r, ("model.clip", "model.side_adapter", "model.rec_head"))
                       for r in _spans.stretch(records))
