"""Lift (`lift/lss.py`, `ops/bev_pool.py` kernel #1): device ms of the
program's `model.lift` span (the lift fusion's input projection, the
min-pooled depth, the two-hot weights and the presorted lift), mean per
request of the profiled stretch."""

from perfbench.metrics import _spans


def read(records):
    return _spans.mean(_spans.ms(r, ("model.lift",)) for r in _spans.stretch(records))
