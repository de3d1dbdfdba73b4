"""Depth tower (`nn/dpt.py` DA-V2, `nn/zoedepth.py` ZoeDepth-NK): ms of CUDA
events around `model.depth`'s forward, mean per traced request."""


def read(records):
    items = records.get("stages_ms") or []
    vals = [d.get("depth") for d in items]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
