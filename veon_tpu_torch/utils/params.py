"""Parameter auditing (counterpart of `veon_tpu/utils/params.py`): the
per-subsystem parameter counts with their trainable part."""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
from torch import nn


def _leaves(params, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], int]]:
    """(path, size) of every param: of a model, the path is its name's
    components; of a nested dict tree (a flax-named variables tree), its keys."""
    if isinstance(params, nn.Module):
        for name, p in params.named_parameters():
            yield tuple(name.split(".")), p.numel()
        return
    for k, v in params.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), int(np.prod(np.shape(v)))


def count_parameters(params) -> int:
    return sum(n for _, n in _leaves(params))


def param_table(params, trainable_pred: Optional[Callable[[Tuple[str, ...]], bool]] = None
                ) -> str:
    """The per-top-level-module table (params and trainable params) of a
    model or a params tree, in the JAX package's format."""
    rows: Dict[str, Dict[str, int]] = {}
    for path, n in _leaves(params):
        row = rows.setdefault(path[0], {"total": 0, "trainable": 0})
        row["total"] += n
        if trainable_pred is not None and trainable_pred(path):
            row["trainable"] += n
    lines = [f"{'module':<24}{'params':>14}{'trainable':>14}"]
    tot = {"total": 0, "trainable": 0}
    for name in sorted(rows):
        r = rows[name]
        tot["total"] += r["total"]
        tot["trainable"] += r["trainable"]
        lines.append(f"{name:<24}{r['total']:>14,}{r['trainable']:>14,}")
    lines.append(f"{'TOTAL':<24}{tot['total']:>14,}{tot['trainable']:>14,}")
    return "\n".join(lines)
