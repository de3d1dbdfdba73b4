"""Temporal fusion and warp (`nn/alignnet.py` `TemporalFusion`, `model/veon.py`
`align_to_prev`, wrapped on the instance): ms of CUDA events, summed per
request, mean per traced request. Nothing to read without a temporal
fusion."""


def read(records):
    items = records.get("stages_ms") or []
    vals = [(d["temporal_fusion"] + d.get("warp", 0.0)) if "temporal_fusion" in d else None for d in items]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
