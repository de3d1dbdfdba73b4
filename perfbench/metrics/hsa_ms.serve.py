"""HSA (`nn/hsa.py`): ms of CUDA events around `model.hsa`'s forward, mean per
traced request."""


def read(records):
    items = records.get("stages_ms") or []
    vals = [d.get("hsa") for d in items]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
