#!/usr/bin/env python3
"""The readings that a cell's limits are set from, several seeds in one
process, on the card:

    python3 perfbench/control.py --workload veon_b.stream_t2 --seeds 11 12 13 \
        [--program --seconds 8] [--control] [--requests 250]

--program runs the port as a benchmark run does (a short window, then the
reference's check) and prints its numbers: the lower readings. --control
puts the reference computed in the configuration's bf16 with fp8 product
operands (`judge.fake_quant`) in the program's place, on the requests that a run of `--requests` timed
requests with that seed would judge, judged the same way: the upper
readings. One JSON line per seed and side.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def control_numbers(cell, seed: int, requests: int, device) -> dict:
    import torch
    from perfbench import harness, judge

    tr = cell.traffic
    stream = harness.driver(tr)
    nt = tr["num_temporal"]
    ref = judge.RefServing(cell.config, nt, seed, device)
    ctl = judge.RefServing(cell.config, nt, seed, device, cell.config["compute_dtype"])
    first = tr["warmup_requests"]
    frames = stream.make_frames(torch, ref.cfg, tr, seed, first + requests, device)
    sample = first + int(harness.rng(seed, "check").integers(0, tr["check_within"]))
    return judge.control_serving_numbers(ref, ctl, frames,
                                         sorted({sample, first + requests - 1}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--requests", type=int, default=250)
    args = ap.parse_args(argv)
    from perfbench import harness

    harness.set_cache_dirs()
    import torch
    from perfbench.run import run_cell

    cell = harness.find_cell(args.workload)
    dev = torch.device("cuda")
    for seed in args.seeds:
        if args.program:
            t0 = time.perf_counter()
            res = run_cell(cell, seed, args.seconds, False, "cuda", t0)
            print(json.dumps({"side": "program", "seed": seed, "numbers": res["numbers"],
                              "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                              "attempted": res["attempted"], "check_s": res["check_s"]}),
                  flush=True)
            del res
            gc.collect()
            torch.cuda.empty_cache()
        if args.control:
            t0 = time.perf_counter()
            nums = control_numbers(cell, seed, args.requests, dev)
            print(json.dumps({"side": "control", "seed": seed, "numbers": nums,
                              "s": time.perf_counter() - t0}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
