"""What the `.span` metrics share: the program's own traced requests of
the run's profiled stretch (`veon_tpu_torch/utils/tracing.py`, which
traces each request served while a profiler records) and sums over their
spans. A program without the tracer, or a run that traced fewer requests
than the stretch holds, leaves nothing to read."""

from typing import Dict, Iterable, List, Optional


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from veon_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def stretch(records: Dict) -> List[Dict]:
    """The tracer's last `records["profile"]["items"]` requests: those of
    the profiled stretch; [] when there are fewer."""
    n = (records.get("profile") or {}).get("items") or 0
    tracing = tracer()
    if not n or tracing is None:
        return []
    reqs = tracing.requests()
    return reqs[-n:] if len(reqs) >= n else []


def ms(req: Dict, names: Iterable[str], clock: str = "device_ms") -> Optional[float]:
    """The summed `clock` (device_ms or host_ms) of the request's spans
    named in `names`; None when it has none of them or no such clock."""
    vals = [s[clock] for s in req["spans"] if s["name"] in names]
    if not vals or any(v is None for v in vals):
        return None
    return float(sum(vals))


def model_children(req: Dict, clock: str) -> Optional[float]:
    """The summed `clock` of the `model.*` spans right under
    `session.infer`, the model's stages as the session calls them."""
    spans = req["spans"]
    vals = [s[clock] for s in spans if s["name"].startswith("model.")
            and s["parent"] is not None and spans[s["parent"]]["name"] == "session.infer"]
    if not vals or any(v is None for v in vals):
        return None
    return float(sum(vals))


def minus(a: Optional[float], b: Optional[float]) -> Optional[float]:
    """a - b, or None when either is None."""
    return None if a is None or b is None else a - b


def mean(values: Iterable[Optional[float]]) -> Optional[float]:
    """The mean of the values that are not None, or None."""
    vals = [v for v in values if v is not None]
    return sum(vals) / len(vals) if vals else None
