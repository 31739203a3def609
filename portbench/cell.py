"""One run of one cell: set-up, the measured window, the checks, the result.

:func:`run_cell` is the whole run but the look for a card: the tests call it
on the CPU at a small size. ``python -m portbench.run`` adds that look and
the checks of the process (``portbench/run.py``).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, Optional

import torch

from portbench import correct
from portbench.bench import Bench
from portbench.endtoend import attempted, compute
from portbench.stats import covered
from portbench.trace import Stretch
from portbench.traffic import generate
from portbench.weights import checksum

# the gap a run reads when it finished no request to compare
NOTHING_SERVED = 1e9


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _number(v):
    return v if isinstance(v, int) else float(v)


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, process_start: float,
             before_reference: Optional[Callable[[], None]] = None,
             control: bool = False) -> Dict:
    """Run cell ``name`` once and return its result line (a dict).
    ``process_start`` is the ``time.perf_counter()`` reading of the
    process's start; ``before_reference`` runs once the window has closed
    and the peak memory is read (the process's checks). ``control`` puts
    the control in the program's place for the comparison (calibration
    only): ``correct`` is then the control's verdict, and the program's
    own gap is kept beside it as ``program_gap``. The cell's model family
    gives its shapes, weights, program and reference."""
    cell = bench.cell(name)
    family = cell.family
    dims = family.dims(cell.config)
    mix = cell.mix
    traffic = generate(mix, seed, seconds, dims.vocab)
    weights = family.weights(dims, seed, device)
    fingerprint = checksum(weights)
    entry = bench.entry(mix["entry"])(mix, family, dims, cell.config_path, device)
    entry.setup(weights, traffic)
    if entry.copies_weights:
        weights = None                   # made again for the reference
    stretch = None
    if trace:
        t = mix["trace"]
        stretch = Stretch(t["start_s"], t["seconds"], device, seconds)
        stretch.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"cell {name}, seed {seed}: set-up done, window of {seconds} s")
    rec = entry.run(traffic, seconds, stretch)
    setup_s = rec.window[0] - process_start
    # the peak on the fullest of the cell's cards
    peak = (max(torch.cuda.max_memory_allocated(i) for i in range(cell.chips))
            if device.type == "cuda" else 0)
    if before_reference is not None:
        before_reference()
    if stretch is not None and stretch.t1 is not None:
        rec.trace = stretch.reduce(entry.context_name)
    gave_up_at = entry.gave_up_at
    entry.close()

    # the checks: the reference over a sample of what the window served
    t_ref = time.perf_counter()
    reqs = correct.sample(rec.served, mix["sample"], seed)
    if weights is None:
        weights = family.weights(dims, seed, device)
        if checksum(weights) != fingerprint:
            raise RuntimeError("the weights made again from the seed differ")
    if reqs:
        if control:
            gap, program_gap = correct.control_gap(family.Reference, weights, cell.config,
                                                   reqs)
        else:
            gap = correct.served_gap(family.Reference, weights, cell.config, reqs)
    else:
        gap = program_gap = NOTHING_SERVED
    n_tok = sum(len(s.tokens) for s in reqs)
    checks = correct.checks(gap, n_tok, cell.limits)
    ok = correct.passed(checks)
    log(f"reference over {len(reqs)} requests, {n_tok} tokens: "
        f"{time.perf_counter() - t_ref:.1f} s")

    tried = attempted(rec)
    failed = sum(1 for s in tried if s.error is not None or s.first is None or s.ended_early)
    result: Dict = {"correct": ok, "attempted": len(tried), "failed": failed}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if not trace:
        values = compute(rec, gave_up_at, setup_s)
        result["metrics"] = {m.name: {"value": _number(values[m.name]), "unit": m.unit}
                             for m in cell.end_to_end if values.get(m.name) is not None}
    else:
        metrics = {}
        for m in cell.per_layer:
            v = bench.reader(m.name)(rec)
            if v is not None:
                metrics[m.name] = {"value": _number(v), "unit": m.unit}
        result["metrics"] = metrics
        if rec.trace is not None:
            device_info["busy_s"] = covered(rec.trace.busy)
            device_info["window_s"] = rec.trace.seconds
            result["breakdown"] = {"device_ops": [list(x) for x in rec.trace.top_ops],
                                   "idle_gaps": [list(x) for x in rec.trace.idle_gaps]}
    result["device"] = device_info
    if control:
        result["program_gap"] = program_gap
    result["checks"] = {k: {"value": _number(v["value"]), "limit": _number(v["limit"])}
                        for k, v in checks.items()}
    return result
