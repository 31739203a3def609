"""The end-to-end metrics, from the host clock's stamps of a run.

  * ``output_tok_s``: output tokens stamped inside the window over its
    seconds;
  * ``itl_p95_ms``: the 95th percentile of the gaps between consecutive
    tokens of a request, pooled over every request, for gaps that end
    inside the window;
  * ``ttft_p95_ms`` (open loop): the 95th percentile over every request
    due inside the window of its first token's time less the time it was
    due; a request that never got one is counted at its wait when the run
    gave up on it;
  * ``ttft_p50_ms`` (closed loop): the median over the requests of every
    whole pass through the mix's pool sent inside the window. Every pass
    holds the same prompts in another order, so the median of whole passes
    is the pool's, wherever the window cuts the last pass (which is left
    out);
  * ``setup_s``: process start to the window's start, measured by the
    harness itself.
"""

from __future__ import annotations

from typing import Dict, Optional

from portbench.record import Record
from portbench.stats import percentile


def attempted(rec: Record):
    w0, w1 = rec.window
    return [s for s in rec.served if w0 <= s.start < w1]


def ttft_values(rec: Record, gave_up_at: float, whole_passes: bool = False):
    reqs = attempted(rec)
    if whole_passes:
        pool = rec.mix["arrivals"]["pool"]
        reqs = [s for s in reqs if sum(1 for x in reqs if x.cycle == s.cycle) == pool]
    return [((s.first if s.first is not None else gave_up_at) - s.start) * 1e3
            for s in reqs]


def compute(rec: Record, gave_up_at: float, setup_s: float) -> Dict[str, Optional[float]]:
    w0, w1 = rec.window
    gaps = [(s.times[i] - s.times[i - 1]) * 1e3 for s in rec.served
            for i in range(1, len(s.times)) if w0 <= s.times[i] <= w1]
    n_out = sum(1 for s in rec.served for t in s.times if w0 <= t <= w1)
    ttft = ttft_values(rec, gave_up_at)
    passes = (ttft_values(rec, gave_up_at, whole_passes=True)
              if rec.mix["arrivals"]["loop"] == "closed" else ttft)
    return {
        "output_tok_s": n_out / rec.seconds,
        "itl_p95_ms": percentile(gaps, 95) if gaps else None,
        "ttft_p95_ms": percentile(ttft, 95) if ttft else None,
        "ttft_p50_ms": percentile(passes, 50) if passes else None,
        "setup_s": setup_s,
    }
