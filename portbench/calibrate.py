"""Readings for a cell's correctness limit, on the card, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 11,12,... --control 3 --seconds <s>

Runs the cell once a seed, at its own sizes and load, with a window long
enough to finish the mix's longest requests, and prints one JSON line a
seed: the program's widest logit gap on the sampled requests (the lower
reading) and its verdict. For the first ``--control`` seeds the control,
the reference in float8, stands in the program's place on the same
requests: its gap (the upper reading) goes through the harness's checks,
and its verdict, which has to come out false, is the line's ``correct``.
The limit is set between the two (PERF.md says from which). The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    from portbench.bench import Bench
    from portbench.cell import run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    bench = Bench()
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        r = run_cell(bench, args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                     time.perf_counter(), control=i < args.control)
        gap = r["checks"]["logit_gap"]["value"]
        control = "program_gap" in r
        print(json.dumps({"seed": seed, "gap": r["program_gap"] if control else gap,
                          "control_gap": gap if control else None,
                          "tokens": r["checks"]["tokens_compared"]["value"],
                          "correct": r["correct"], "attempted": r["attempted"],
                          "failed": r["failed"], "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
