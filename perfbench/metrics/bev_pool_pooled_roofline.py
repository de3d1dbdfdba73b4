"""Lift (`lift/lss.py`, `ops/bev_pool.py` kernel #1, the pooled presorted
lift): the kernel's least time, its least bytes per launch over the HBM
rate (3.35 TB/s, NVIDIA H100 SXM data sheet), over its device time per
launch in the profiler trace (`bev_pool_pooled_kernel` and its
`find_long_cells` pass), in %. The bytes (`drivers/stream.py`
`pooled_kernel_bytes`) count each in-grid point's order, rank and weight,
each feature row, the CSR starts and the output once."""

from perfbench.harness import PEAK_HBM_BYTES_PER_S
from perfbench.trace import kernel_seconds_per_launch


def read(records):
    p, nbytes = records.get("profile"), records.get("pooled_bytes")
    if not p or not nbytes:
        return None
    secs, _n = kernel_seconds_per_launch(
        p["kernels"], lambda k: "bev_pool_pooled_kernel" in k or "find_long_cells" in k)
    launches = sum(v[1] for k, v in p["kernels"].items() if "bev_pool_pooled_kernel" in k)
    if not launches or secs <= 0:
        return None
    return 100.0 * (nbytes / PEAK_HBM_BYTES_PER_S) / (secs / launches)
