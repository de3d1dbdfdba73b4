"""Structured metric logging (counterpart of `veon_tpu/utils/logging.py`):
a JSONL scalar stream that tooling can tail, one object per `write`, plus
a TensorBoard event writer when `torch.utils.tensorboard` can be imported
(never required).

    {"step": 120, "time": 1723800000.0, "epoch": 1, "loss_binocc": 0.41, ...}
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricWriter:
    """Append-only scalar logger writing `<work_dir>/<filename>`."""

    def __init__(self, work_dir: str, filename: str = "train.log.jsonl",
                 tensorboard: bool = False):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, filename)
        self._fh = open(self.path, "a", buffering=1)
        self._tb = None
        if tensorboard:
            try:  # optional: JSONL only where the package is absent
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(work_dir, "tb"))
            except Exception:
                self._tb = None

    def write(self, scalars: Dict[str, float], step: int, epoch: Optional[int] = None) -> None:
        rec = {"step": int(step), "time": time.time()}
        if epoch is not None:
            rec["epoch"] = int(epoch)
        for k, v in scalars.items():
            rec[k] = float(v)
        self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def summarize_log(path: str) -> Dict[str, object]:
    """A JSONL training log in brief: the record count, each scalar's
    first / last / min value, and the mean sec_per_iter."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    out: Dict[str, object] = {"num_records": len(recs)}
    if not recs:
        return out
    for k in (k for k in recs[-1] if k not in ("step", "time", "epoch")):
        vals = [r[k] for r in recs if k in r]
        out[k] = {"first": vals[0], "last": vals[-1], "min": min(vals)}
    if "sec_per_iter" in recs[-1]:
        secs = [r["sec_per_iter"] for r in recs if "sec_per_iter" in r]
        out["avg_sec_per_iter"] = sum(secs) / max(len(secs), 1)
    return out
