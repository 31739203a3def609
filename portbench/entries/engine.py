"""``engine``: the CLI's chat. ``InferenceEngine.generate_tokens`` on the
fused bf16 layout (the CLI's single-device default), K1 prefill and the
captured decode graphs. A closed loop: one user sends the next request
when the last has finished."""

from __future__ import annotations

import time
from typing import List, Optional

from portbench.entries import Entry, sync
from portbench.record import Record, Served
from portbench.trace import Stretch
from portbench.traffic import Traffic


class EngineEntry(Entry):
    copies_weights = True                # the CLI's fused layout

    def setup(self, weights: Dict, traffic: Traffic) -> None:
        from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

        mix = self.mix
        self.model = self.family.program(weights, self.cfg_path, mix["context"],
                                         self.device, fused=True)
        self.engine = InferenceEngine(
            self.model, InferenceArgs(sequence_length=mix["context"]), device=self.device)
        self._warm(traffic)

    def _shape(self, prompt_len: int, max_new: int):
        from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

        cache = self.engine.cache_bucket(prompt_len, max_new)
        return prefill_bucket(prompt_len, cache), cache

    def _warm(self, traffic: Traffic) -> None:
        """One short request for every (prefill bucket, cache bucket) the
        traffic uses: K1 at each prefill shape, each bucket's decode graph
        captured, cuBLAS at each shape."""
        seen = set()
        for r in traffic.requests:
            shape = self._shape(len(r.prompt), r.max_new)
            if shape in seen:
                continue
            seen.add(shape)
            # the fewest new tokens that keep the cache bucket, and two steps
            new = next(n for n in range(2, r.max_new + 1)
                       if self._shape(len(r.prompt), n) == shape)
            for _ in self.engine.generate_tokens(r.prompt, new):
                pass
        sync(self.device)

    def run(self, traffic: Traffic, seconds: float, stretch: Optional[Stretch]) -> Record:
        served: List[Served] = []
        w0 = time.perf_counter()
        w1 = w0 + seconds
        for plan in traffic.requests:
            now = time.perf_counter()
            if now >= w1:
                break
            if stretch is not None and stretch.due(now, w0):
                stretch.start()
            s = Served(prompt=plan.prompt, max_new=plan.max_new, start=time.perf_counter(),
                       cache_len=self._shape(len(plan.prompt), plan.max_new)[1],
                       cycle=plan.cycle)
            served.append(s)
            gen = self.engine.generate_tokens(plan.prompt, plan.max_new)
            try:
                for _state, tok in gen:
                    t = time.perf_counter()
                    s.times.append(t)
                    s.tokens.append(tok)
                    if t >= w1:
                        break                # the window is over: the user stops reading
                else:
                    s.ended_early = not s.finished
            except Exception as e:           # noqa: BLE001 -- a failed request is counted
                s.error = repr(e)
            finally:
                gen.close()
            if stretch is not None and (stretch.over(time.perf_counter())
                                        or (stretch.active and time.perf_counter() >= w1)):
                stretch.stop()
        if stretch is not None and stretch.active:
            stretch.stop()
        self.gave_up_at = time.perf_counter()
        self._requests = served
        return Record(entry="engine", dims=self.dims, mix=self.mix, window=(w0, w1),
                      served=served)

    def context_name(self, t: float) -> str:
        for s in getattr(self, "_requests", []):
            if s.start <= t <= (s.times[-1] if s.times else s.start):
                return "in a request (prefill)" if not s.times or t < s.times[0] \
                    else "in a request (decode)"
        return "between requests"


ENTRY = EngineEntry
