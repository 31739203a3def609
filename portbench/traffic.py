"""The one traffic generator: a mix file's parameters and a seed in, the
requests of one run out.

Every seed gets the same set of requests and the same set of arrival gaps,
in an order of its own. The sizes are the quantiles of the mix's length
distributions at evenly spaced points (prompt and output paired by a
permutation fixed for the mix); an open loop's gaps are the quantiles of
the exponential at its rate. Sorted, the sizes fall into ``SPREAD`` strata
(octiles), and so do the gaps: every block of ``SPREAD`` consecutive
requests takes one size of each stratum, in the fixed ``PATTERN`` of
strata, and the seed draws which size of each stratum goes to which block
(the gaps likewise). The seed so draws the order and the tokens, while the
load over any few seconds stays the mix's: no seed sends its long prompts,
or its short gaps, together. A free shuffle moved a 95th percentile of TTFT
2.6x from seed to seed near the knee, and a shuffle within blocks 29%
(PERF.md); so the cell's schedule is steadier than Poisson arrivals, and
a burst is a mix of its own.

Distributions (``dist``): ``lognormal`` (``median``, ``sigma``) and
``loguniform``, each clipped to ``[min, max]``. Arrivals:
``{"loop": "open", "rate_per_s", "ramp_s"}`` (the ramp runs before the
measured window, and its requests and the window's each take a whole set
of sizes) or ``{"loop": "closed", "pool"}`` (one user sends the next
request when the last has finished, in passes through ``pool`` sizes).
``shared``, when given: ``prompts`` system prompts of ``length`` tokens,
picked by Zipf(``zipf``), each followed by a unique user turn whose length
is ``prompt``'s.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

# the pairing of prompt and output lengths is the mix's; the order the seed's
PAIRING_SEED = 20261017
SPREAD = 8              # requests (or gaps) a block, one from each stratum
PATTERN = (0, 4, 2, 6, 1, 5, 3, 7)    # the strata's order in a block: small and large


@dataclass
class Planned:
    """One request as the generator plans it."""

    index: int
    prompt: List[int]
    max_new: int
    due: float = 0.0              # seconds after the traffic's start (open loop)
    system: Optional[int] = None  # the shared system prompt, if any
    shared_len: int = 0           # tokens of the shared system prompt
    cycle: int = 0                # the pass through the pool (closed loop)


@dataclass
class Traffic:
    requests: List[Planned]
    system_prompts: List[List[int]] = field(default_factory=list)
    ramp_s: float = 0.0


def quantile(spec: Dict, u: float) -> int:
    """The ``u``-quantile of a length distribution, clipped and rounded."""
    lo, hi = spec["min"], spec["max"]
    kind = spec["dist"]
    if kind == "lognormal":
        x = spec["median"] * math.exp(spec["sigma"] * NormalDist().inv_cdf(u))
    elif kind == "loguniform":
        x = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return int(min(hi, max(lo, round(x))))


def _points(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _zipf_pick(n_choices: int, s: float, u: float) -> int:
    w = np.array([1.0 / (k + 1) ** s for k in range(n_choices)])
    return int(min(np.searchsorted(np.cumsum(w / w.sum()), u), n_choices - 1))


def _sizes(mix: Dict, n: int) -> List[tuple]:
    """``n`` planned sizes ``(prompt_len, max_new, system)``: the quantiles
    at evenly spaced points, paired by the mix's fixed permutation."""
    fixed = np.random.default_rng(PAIRING_SEED)
    u = _points(n)
    out_u = u[fixed.permutation(n)]
    sys_u = u[fixed.permutation(n)]
    shared = mix.get("shared")
    sizes = []
    for i in range(n):
        system = (_zipf_pick(shared["prompts"], shared["zipf"], sys_u[i])
                  if shared else None)
        plen = quantile(mix["prompt"], u[i])
        new = quantile(mix["output"], out_u[i])
        if "max_total" in mix:
            new = min(new, mix["max_total"] - plen - (shared["length"] if shared else 0))
        sizes.append((plen, new, system))
    return sizes


def spread_order(n: int, rng: np.random.Generator) -> np.ndarray:
    """A permutation of ``range(n)`` (indices of values sorted ascending):
    index ``i`` is of stratum ``i * SPREAD // n``; every whole block of
    ``SPREAD`` places takes one index of each stratum, in the strata's
    order ``PATTERN``, and the seed draws which index of each stratum goes
    to which block. What is left over makes a last, shorter block."""
    strata = [rng.permutation([i for i in range(n) if i * SPREAD // n == k])
              for k in range(SPREAD)]
    whole = n // SPREAD
    blocks = [[strata[k][b] for k in PATTERN] for b in range(whole)]
    blocks.append([strata[k][whole] for k in PATTERN if len(strata[k]) > whole])
    return np.array([i for blk in blocks for i in blk], dtype=int)


def arrival_times(start: float, length: float, rate: float,
                  rng: np.random.Generator) -> List[float]:
    """The open loop's due times in ``[start, start + length)``: ``rate x
    length`` arrivals (rounded), the first at ``start``, their gaps the
    quantiles of the exponential at ``rate`` (Poisson gaps at evenly spaced
    points) scaled to fill the stretch, in the seed's spread order."""
    n = max(1, round(rate * length))
    gaps = -np.log(1.0 - _points(n)) / rate
    gaps *= length / gaps.sum()
    steps = gaps[spread_order(n, rng)]
    return [float(start + t) for t in np.concatenate(([0.0], np.cumsum(steps[:-1])))]


def generate(mix: Dict, seed: int, seconds: float, vocab_size: int,
             cycles: int = 16) -> Traffic:
    """The requests of one run of ``mix`` at ``seed`` with a window of
    ``seconds``. A closed loop gets ``cycles`` passes through its pool (more
    than a window completes); an open loop its arrivals from the ramp's
    start to the window's end, the ramp and the window each with the count
    its length and the rate give."""
    rng = np.random.default_rng(seed)
    order = np.random.default_rng([seed, 1])
    arr = mix["arrivals"]
    shared = mix.get("shared")
    systems = ([rng.integers(0, vocab_size, shared["length"]).tolist()
                for _ in range(shared["prompts"])] if shared else [])
    if arr["loop"] == "closed":
        pool = _sizes(mix, arr["pool"])
        plan = [(0.0, pool[i], k) for k in range(cycles)
                for i in order.permutation(len(pool))]
    else:
        ramp_s = arr.get("ramp_s", 0.0)
        phases = [(0.0, ramp_s)] if ramp_s > 0 else []
        plan = []
        for start, length in phases + [(ramp_s, seconds)]:
            phase = arrival_times(start, length, arr["rate_per_s"], order)
            pool = _sizes(mix, len(phase))
            plan += [(t, pool[i], 0) for t, i in zip(phase, spread_order(len(phase), order))]
    reqs: List[Planned] = []
    for idx, (due, (plen, new, system), cycle) in enumerate(plan):
        head = systems[system] if system is not None else []
        prompt = head + rng.integers(0, vocab_size, plen).tolist()
        reqs.append(Planned(index=idx, prompt=prompt, max_new=new, due=due,
                            system=system, shared_len=len(head), cycle=cycle))
    return Traffic(requests=reqs, system_prompts=systems,
                   ramp_s=arr.get("ramp_s", 0.0) if arr["loop"] == "open" else 0.0)
