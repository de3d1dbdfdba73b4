"""Session: the worker's host ms inside the model's stages, summed over
the `model.*` spans right under `session.infer`: the time the host takes
to issue them, or to wait where a stage makes it wait. Beside the stages'
device ms it says whether the host or the card sets the pace. Mean per
request of the profiled stretch."""

from perfbench.metrics import _spans


def read(records):
    return _spans.mean(_spans.model_children(r, "host_ms") for r in _spans.stretch(records))
