"""Session (`serve/streaming.py` `TemporalSession.infer`, `StreamingStep`;
`entry.py` `FrameServer.infer`): device ms of `session.infer` less its
`model.*` stages: the on-card normalize, the class merge and fusion
rule, the retrieval map and the cache roll. Mean per request of the
profiled stretch."""

from perfbench.metrics import _spans


def read(records):
    return _spans.mean(_spans.minus(_spans.ms(r, ("session.infer",)),
                                    _spans.model_children(r, "device_ms"))
                       for r in _spans.stretch(records))
