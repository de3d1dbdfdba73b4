"""Weights-day activation parity (counterpart of `veon_tpu/parity`).

The dump half is the JAX package's `parity/dump_reference.py`: standalone
torch code run inside the reference environment (mmcv/mmdet3d and the
released checkpoints), which hooks the reference model at its module
boundaries and writes npz dumps; it needs nothing of either package, so
the port keeps no copy. `compare.py` is the port's half: it replays a dump
through the port's converted-weight model and checks every boundary
within its tolerance, as `python -m veon_tpu_torch.cli.main parity --dumps
<dir>`.
"""

from .compare import BOUNDARIES, compare_dumps  # noqa: F401
