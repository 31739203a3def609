"""``paged_batcher``: the server's paged continuous batcher
(``PagedBatcher`` on the split layout, stepping in its own
``serve_forever_in_thread``). An open loop: a client thread submits each
request when it is due, whatever the backlog."""

from __future__ import annotations

import gc
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench.entries import DRAIN_S, Entry, Stamped, sync
from portbench.record import Record, Served, Span
from portbench.trace import Stretch
from portbench.traffic import Traffic


class PagedEntry(Entry):
    def setup(self, weights: Dict, traffic: Traffic) -> None:
        from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
        from llama_nuts_and_bolts_tpu_torch.runtime.types import GenerationState

        self._in_progress = GenerationState.IN_PROGRESS
        mix = self.mix
        self.model = self.family.program(weights, self.cfg_path, mix["context"],
                                         self.device, fused=False)
        self.engine = InferenceEngine(
            self.model, InferenceArgs(sequence_length=mix["context"]), device=self.device)
        self.new_batcher(traffic)

    def new_batcher(self, traffic: Traffic) -> None:
        """A fresh batcher (the pool at its default size) over the engine,
        warmed up for ``traffic``."""
        from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher

        self.batcher = None
        gc.collect()
        self.batcher = PagedBatcher(self.engine, n_slots=self.mix["slots"])
        self._warm(traffic)

    def _warm(self, traffic: Traffic) -> None:
        """Set-up as a server that has been up would have it: the shared
        system prompts resident in the prefix cache, then one short request
        at every prefill length the traffic takes (a prefix hit's suffix
        where it shares), so every shape has run once."""
        from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

        b = self.batcher
        bs = b.block_size
        gen = torch.Generator().manual_seed(0)
        for system in traffic.system_prompts:
            b.submit(system, max_new_tokens=2)
        b.run_until_idle()
        seen = set()
        for r in traffic.requests:
            suffix = len(r.prompt) - (r.shared_len // bs) * bs
            bucket = -(-prefill_bucket(suffix, b.seq_len) // bs) * bs
            if bucket in seen:
                continue
            seen.add(bucket)
            fresh = torch.randint(0, self.dims.vocab, (len(r.prompt) - r.shared_len,),
                                  generator=gen).tolist()
            head = traffic.system_prompts[r.system] if r.system is not None else []
            b.submit(head + fresh, max_new_tokens=3)
        b.run_until_idle()
        sync(self.device)

    def _counters(self) -> Dict[str, int]:
        b = self.batcher
        st = b.allocator.stats
        return {"decode_steps": b.decode_steps, "prefix_lookups": st["prefix_lookups"],
                "prefix_hits": st["prefix_hits"]}

    def run(self, traffic: Traffic, seconds: float, stretch: Optional[Stretch]) -> Record:
        """The open loop. The profiler is started and stopped on this
        thread (its owner), at a boundary between two of the batcher's
        steps: the batcher thread asks and waits (outside its spans)."""
        b = self.batcher
        spans: List[Span] = []
        step = b.step
        asks: "queue.Queue[tuple]" = queue.Queue()
        t_start = time.perf_counter()
        w0 = t_start + traffic.ramp_s
        w1 = w0 + seconds

        def ask(what: Callable[[], None]) -> None:
            done = threading.Event()
            asks.put((what, done))
            done.wait()

        def timed_step() -> None:
            if stretch is not None and stretch.due(time.perf_counter(), w0):
                ask(stretch.start)
            before = self._counters()
            t0 = time.perf_counter()
            step()
            spans.append(Span(t0=t0, t1=time.perf_counter(), before=before,
                              after=self._counters()))
            if stretch is not None and stretch.over(time.perf_counter()):
                ask(stretch.stop)

        def serve_asks(until: float) -> None:
            """Sleep until ``until``, doing what the batcher thread asks."""
            while True:
                left = until - time.perf_counter()
                if left <= 0:
                    return
                try:
                    what, done = asks.get(timeout=left)
                except queue.Empty:
                    return
                what()
                done.set()

        b.step = timed_step
        thread = b.serve_forever_in_thread()
        served: List[Served] = []
        streams: List[Stamped] = []
        try:
            for plan in traffic.requests:
                due = t_start + plan.due
                if due >= w1:
                    break
                serve_asks(due)
                req = b.submit(plan.prompt, max_new_tokens=plan.max_new)
                out, req.out = req.out, Stamped()
                while not out.empty():       # anything put before the swap
                    req.out.put(out.get_nowait())
                served.append(Served(prompt=plan.prompt, max_new=plan.max_new, start=due,
                                     shared_len=plan.shared_len, system=plan.system))
                streams.append(req.out)
            serve_asks(w1)
            # late is not missing: wait for every due request's first token,
            # and for the traced stretch to end
            limit = time.perf_counter() + DRAIN_S
            while time.perf_counter() < limit and thread.is_alive() and (
                    any(not out.entries for s, out in zip(served, streams) if s.start < w1)
                    or (stretch is not None and stretch.active)):
                serve_asks(time.perf_counter() + 0.01)
        finally:
            self.gave_up_at = time.perf_counter()
            b.stop()
            while thread.is_alive() and time.perf_counter() < self.gave_up_at + DRAIN_S:
                serve_asks(time.perf_counter() + 0.01)
            b.step = step
        if stretch is not None and stretch.active:
            stretch.stop()
        for s, out in zip(served, streams):
            for t, (state, tok) in out.entries:
                if tok >= 0:
                    s.times.append(t)
                    s.tokens.append(tok)
                if state is not self._in_progress:
                    s.ended_early = not s.finished
        self._spans = spans
        return Record(entry="paged_batcher", dims=self.dims, mix=self.mix,
                      window=(w0, w1), served=served, spans=spans,
                      block_size=b.block_size)

    def context_name(self, t: float) -> str:
        for s in getattr(self, "_spans", []):
            if s.t0 <= t <= s.t1:
                return "in step()"
        return "between step() calls"


ENTRY = PagedEntry
