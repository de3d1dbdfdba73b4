"""3D head (`nn/alignnet.py` `AlignNet3D` without its temporal fusion): ms of
CUDA events around `model.alignnet`'s forward less those around its
`temporal_fusion`, mean per traced request."""


def read(records):
    items = records.get("stages_ms") or []
    vals = [(d["alignnet"] - d.get("temporal_fusion", 0.0)) if "alignnet" in d else None for d in items]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
