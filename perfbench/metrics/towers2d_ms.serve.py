"""CLIP and SAN towers (`nn/vit.py`, `nn/san.py`): ms of CUDA events around
`clip_visual`, `side_adapter` and `rec_head`'s forwards, summed per request,
mean per traced request."""


def read(records):
    items = records.get("stages_ms") or []
    vals = [sum(d[k] for k in ("clip_visual", "side_adapter", "rec_head")) if "clip_visual" in d else None for d in items]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
