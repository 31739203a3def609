"""What one run leaves for the metrics: its requests with the host clock's
stamps, the benchmark's spans around the program's calls with the
program's counters beside them, and the reduced device trace.

Times are ``time.perf_counter()`` seconds. A request's token ``i`` (from 0)
is produced at position ``prompt_len + i - 1`` for ``i >= 1`` (the decode
step fed the token before it) and sees ``prompt_len + i`` keys; token 0
comes from the prefill.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from portbench import yardstick as ys


@dataclass
class Served:
    prompt: List[int]
    max_new: int
    start: float                     # when it was due (open loop) or sent (closed)
    shared_len: int = 0              # tokens of a shared system prompt
    system: Optional[int] = None     # which shared system prompt
    cache_len: int = 0               # the cache the request decoded in (engine)
    cycle: int = 0                   # its pass through the pool (closed loop)
    times: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    error: Optional[str] = None
    ended_early: bool = False        # the program ended it before ``max_new`` tokens

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def first(self) -> Optional[float]:
        return self.times[0] if self.times else None

    @property
    def finished(self) -> bool:
        return len(self.tokens) >= self.max_new

    def decode_tokens(self, lo: float, hi: float) -> List[int]:
        """Indices ``i >= 1`` of the tokens stamped in ``[lo, hi]``."""
        return [i for i in range(1, len(self.times)) if lo <= self.times[i] <= hi]


@dataclass
class Span:
    """One call into the program, and its counters before and after."""

    t0: float
    t1: float
    before: Dict[str, int] = field(default_factory=dict)
    after: Dict[str, int] = field(default_factory=dict)


@dataclass
class Trace:
    """The device trace of one bounded stretch, reduced."""

    t0: float
    t1: float
    busy: List[Tuple[float, float]]               # merged device intervals
    by_class: Dict[str, float]                     # device seconds by kernel class
    top_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class Record:
    entry: str                       # "engine" or "paged_batcher"
    dims: Any                        # the cell's family's ``dims(cfg)``
    mix: Dict
    window: Tuple[float, float]
    served: List[Served]
    spans: List[Span] = field(default_factory=list)
    trace: Optional[Trace] = None
    block_size: int = 32

    @property
    def seconds(self) -> float:
        return self.window[1] - self.window[0]

    def spans_in(self, lo: float, hi: float) -> List[Span]:
        return [s for s in self.spans if s.t0 >= lo and s.t1 <= hi]

    def counter_delta(self, spans: List[Span], name: str) -> int:
        if not spans:
            return 0
        return spans[-1].after.get(name, 0) - spans[0].before.get(name, 0)

    def cached(self, s: Served) -> int:
        """Prompt tokens a request took from the prefix cache: its shared
        system prompt's whole blocks (set-up made them resident)."""
        bs = self.block_size
        return min(s.shared_len // bs, (s.prompt_len - 1) // bs) * bs

    def prefill_flops(self, s: Served) -> float:
        c = self.cached(s)
        n = s.prompt_len - c
        return ys.model_flops(self.dims, n, ys.attention_keys(c, n), 1)

    def decode_flops(self, s: Served, idx: List[int]) -> float:
        keys = sum(s.prompt_len + i for i in idx)
        return ys.model_flops(self.dims, len(idx), keys, len(idx))

    def prefilled_in(self, lo: float, hi: float) -> List[Served]:
        """Requests whose first token was stamped in ``[lo, hi]``."""
        return [s for s in self.served if s.first is not None and lo <= s.first <= hi]

    def steps_in(self, lo: float, hi: float, apart: float = 0.005) -> List[List[tuple]]:
        """The decode tokens stamped in ``[lo, hi]`` as ``(served, i)``,
        grouped by the batched step that delivered them: one step puts every
        row's token at once, and steps lie tens of ms apart."""
        toks = sorted((s.times[i], k, i) for k, s in enumerate(self.served)
                      for i in s.decode_tokens(lo, hi))
        steps: List[List[tuple]] = []
        last = None
        for t, k, i in toks:
            if last is None or t - last > apart:
                steps.append([])
            steps[-1].append((self.served[k], i))
            last = t
        return steps

    def flops_in(self, lo: float, hi: float) -> float:
        """Model FLOPs of the prefills and decode tokens stamped in ``[lo, hi]``."""
        return (sum(self.prefill_flops(s) for s in self.prefilled_in(lo, hi))
                + sum(self.decode_flops(s, s.decode_tokens(lo, hi)) for s in self.served))
