"""Temporal fusion and warp (`nn/alignnet.py` `TemporalFusion`,
`model/veon.py` `align_to_prev`): device ms of the program's
`model.temporal_fusion` and `model.warp` spans, summed per request, mean
per request of the profiled stretch; nothing to read without a temporal
fusion. Twin of `fusion_ms.serve`."""

from perfbench.metrics import _spans


def read(records):
    return _spans.mean(_spans.ms(r, ("model.temporal_fusion", "model.warp"))
                       for r in _spans.stretch(records))
