"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It runs on the machine it is started on, on
``cuda:0``, and exits with another code than 0, printing no result, when
there is no card (or fewer than the cell asks for), when the program it
would measure is not this checkout's, or when the process has loaded JAX,
Flax or the JAX package by the time the window has closed. Otherwise its
last line on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, traced, ``breakdown``; the numbers
compared for ``correct`` come last, under ``checks``, and again as the last
lines on standard error.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the run, at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
          "TRITON_CACHE_DIR": "build/portbench/triton",
          "CUDA_CACHE_PATH": "build/portbench/cuda_cache"}
FORBIDDEN = ("jax", "jaxlib", "flax", "llama_nuts_and_bolts_tpu")
PORT = "llama_nuts_and_bolts_tpu_torch"


def process_start_perf() -> float:
    """This process's start on the ``time.perf_counter()`` clock."""
    now = time.perf_counter()
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return now - max(0.0, uptime - start / ticks)
    except (OSError, ValueError, IndexError):
        return now


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = process_start_perf()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    # a library that loads JAX by itself (transformers) is kept from it
    os.environ["USE_FLAX"] = "0"

    import importlib.util

    spec = importlib.util.find_spec(PORT)
    if spec is None or not Path(spec.origin).resolve().is_relative_to(ROOT):
        print(f"portbench: the program ({PORT}) is not in this checkout ({ROOT})",
              file=sys.stderr)
        return 2

    import torch

    from portbench.bench import Bench
    from portbench.cell import log, run_cell

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    found = []

    def look() -> None:
        found.extend(forbidden_modules())

    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start, before_reference=look)
    look()
    if found:
        print(f"portbench: the process loaded {sorted(set(found))}: the benchmark "
              "measures the port alone", file=sys.stderr)
        return 4
    import json

    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} against the limit {c['limit']!r}")
    log(f"correct: {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
