"""Whole request: the share of the card's bf16 peak (989 TFLOP/s,
NVIDIA H100 SXM data sheet) that the benchmark's analytic FLOPs per request
(`flops.py`) reach at the traced run's ms per request, in %. The ms per
request come from the traced run's requests that ran before any instrument was
placed, so the profiler's cost stays out of it."""

from perfbench.harness import PEAK_BF16_FLOPS


def read(records):
    ms, fl = records.get("ms_per_item"), records.get("flops_per_item")
    if not ms or not fl:
        return None
    return 100.0 * fl / (ms * 1e-3 * PEAK_BF16_FLOPS)
