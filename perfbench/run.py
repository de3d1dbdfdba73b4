#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch port (`veon_tpu_torch`)
once, on the card(s) of this machine:

    python3 perfbench/run.py --workload veon_b.stream_t2 --seed 7 --seconds 35 --trace 0

from the root of a checkout. It prints, as the last line of its standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1), `device` (with busy_s and window_s when traced), with
--trace 1 `breakdown`, and last `checks`, each number the reference check
compared beside its limit; the same checks are the last lines of its
standard error. It exits non-zero, printing no result, without a card
(or with fewer than the cell asks for), without the port beside it, or
when a JAX module was loaded in the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout's root, not this folder, leads imports


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, program_hook=None) -> dict:
    """One run of `cell` on `device`: the driver's result plus `correct`
    and the metrics the manifest lists for the cell. `program_hook` (tests)
    is handed the program's handler before any request."""
    from perfbench import flops, harness
    from perfbench.reference.configs import base as ref_base

    nt = cell.traffic.get("num_temporal", 1)
    cfg = harness.config_from_file(ref_base, cell.config, nt)
    ctx = {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace, "device": device,
           "t_start": t_start, "program_hook": program_hook,
           "flops_per_item": flops.per_item(cfg, cell.traffic)}
    res = harness.driver(cell.traffic).run(ctx)
    if trace:
        res["metrics"] = harness.read_metrics(cell, res["records"])
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        res["metrics"] = {k: {"value": float(v), "unit": units[k]}
                          for k, v in res["metrics"].items() if k in units}
    res["correct"] = harness.judge(res["numbers"], cell.limits)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness

    harness.set_cache_dirs()
    if not (ROOT / "veon_tpu_torch").is_dir():
        print("the port (veon_tpu_torch) is not beside the benchmark", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"modules that may not be loaded in a measured process: {bad}", file=sys.stderr)
        return 4
    device = harness.device_info(torch, cell.chips, res["memory_peak_bytes"])
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": device}
    if args.trace:
        prof = res["records"]["profile"]
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    out["check_s"] = res["check_s"]
    out["readings"] = {k: v for k, v in res["numbers"].items() if k not in cell.limits}
    out["checks"] = {k: {"value": res["numbers"].get(k), "limit": lim}
                     for k, lim in sorted(cell.limits.items())}
    print("set-up, s since process start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["records"]["setup_parts"].items()), file=sys.stderr)
    print(f"readings: {out['readings']}; reference check {res['check_s']:.3f} s", file=sys.stderr)
    for line in harness.checks_text(res["numbers"], cell.limits):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
