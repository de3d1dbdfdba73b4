"""Input-geometry helpers (counterpart of `veon_tpu/data/transforms.py`)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def dav2_size(h: int, w: int, target: int = 252) -> Tuple[int, int]:
    """DA-V2 lower-bound keep-aspect resize to a multiple of 14: scale so the
    smaller relative side reaches `target`, round each side to a multiple
    of 14 (ceiling where rounding would fall below `target`)."""

    def constrain(x: float) -> int:
        y = int(np.round(x / 14) * 14)
        if y < target:
            y = int(np.ceil(x / 14) * 14)
        return y

    scale = max(target / h, target / w)
    return constrain(scale * h), constrain(scale * w)
