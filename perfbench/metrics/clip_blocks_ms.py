"""CLIP transformer blocks (`nn/vit.py`): device ms of the program's
`clip.blocks` spans, one around each run of CLIP blocks (the trunk's
segments under `model.clip`, the deep layers under `model.rec_head`, their
rerun under `model.rec_rerun`), summed per request, mean per request of
the profiled stretch. A program without the span leaves nothing to read."""

from perfbench.metrics import _spans


def read(records):
    return _spans.mean(_spans.ms(r, ("clip.blocks",)) for r in _spans.stretch(records))
