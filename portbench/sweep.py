"""Find a serving mix's knee once, on the card: the highest arrival rate the
batcher sustains, whose backlog does not grow over the window.

    python3 -m portbench.sweep --workload <cell> --seed <n> --seconds <s> --rates 1,2,3

One process, one engine; for each rate a fresh batcher at the mix's sizes
runs the mix's open loop at that rate (its ramp, then ``--seconds``). Each
rate prints one JSON line: the offered and completed rates, the first
tokens' times, and the backlog (requests due in the window with no first
token at its end). A rate is sustained when its backlog at the window's end
is under one second of arrivals and the requests due in the window's last
third waited at most twice as long (median) as those of its first third.
The cell's rate, a share of the knee that PERF.md gives with its reason, is
written into the mix's file.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)

    from portbench.bench import Bench
    from portbench.endtoend import compute
    from portbench.stats import percentile
    from portbench.traffic import generate

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    bench = Bench()
    cell = bench.cell(args.workload)
    if cell.mix["entry"] != "paged_batcher":
        print("sweep: the cell's mix is not an open loop", file=sys.stderr)
        return 2
    family = cell.family
    dims = family.dims(cell.config)
    rates = [float(r) for r in args.rates.split(",")]
    entry = None
    for rate in rates:
        mix = copy.deepcopy(cell.mix)
        mix["arrivals"]["rate_per_s"] = rate
        traffic = generate(mix, args.seed, args.seconds, dims.vocab)
        if entry is None:
            weights = family.weights(dims, args.seed, dev)
            entry = bench.entry("paged_batcher")(mix, family, dims, cell.config_path, dev)
            entry.setup(weights, traffic)
        else:
            entry.mix = mix
            entry.new_batcher(traffic)
        rec = entry.run(traffic, args.seconds, None)
        w0, w1 = rec.window
        due = [s for s in rec.served if w0 <= s.start < w1]
        backlog = sum(1 for s in due if s.first is None or s.first > w1)
        third = (w1 - w0) / 3

        def waits(lo, hi):
            xs = [(s.first - s.start) * 1e3 for s in due
                  if lo <= s.start < hi and s.first is not None]
            return percentile(xs, 50) if xs else None

        early, late = waits(w0, w0 + third), waits(w1 - third, w1)
        e2e = compute(rec, entry.gave_up_at, 0.0)
        sustained = (backlog < max(1.0, rate) and early is not None and late is not None
                     and late <= 2 * early)
        print(json.dumps({"rate_per_s": rate, "due": len(due), "backlog_at_end": backlog,
                          "ttft_p50_first_third_ms": early, "ttft_p50_last_third_ms": late,
                          "output_tok_s": e2e["output_tok_s"], "itl_p95_ms": e2e["itl_p95_ms"],
                          "ttft_p95_ms": e2e["ttft_p95_ms"],
                          "completed_per_s": sum(1 for s in rec.served if s.finished
                                                 and s.times[-1] <= w1) / (w1 - w0),
                          "sustained": sustained, "card": torch.cuda.get_device_name(dev)}),
              flush=True)
        time.sleep(1.0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
