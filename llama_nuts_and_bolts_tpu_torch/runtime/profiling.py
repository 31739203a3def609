"""Tracing and profiling: the program's spans, device traces and the
narrated forward pass.

Port of ``llama_nuts_and_bolts_tpu/runtime/profiling.py``, with a span
recorder of the port's own:

  * :data:`SPANS` -- the process's :class:`SpanRecorder`, always recording:
    the batchers, the engine and the decode graphs stamp a span at each
    layer boundary (a request's queue wait, a step's launches and read-back,
    a prefill, a graph's capture) into a bounded ring that a reader takes
    after the fact (:meth:`SpanRecorder.between`);
  * :func:`device_trace` -- a context manager around ``torch.profiler``
    that writes a Chrome trace (``chrome://tracing``, Perfetto) of the host,
    every thread of it, and, on a card, the device timeline into a
    directory; the program's spans show in it by name (in no other
    profiler's trace);
  * :func:`narrated_forward` -- the forward pass a layer at a time, with each
    layer's wall-clock time and the shapes through ``log_fn``: the
    reference's "Transformer block layer i / L was run, took X sec(s)"
    lines. It runs ``models/llama/model.py``'s own three parts
    (``prepare_forward``, ``decoder_block``, ``output_head``), so it runs
    the served code (the kernels, an int8 cache, quantized weights) and, on
    a card, gives the logits of ``forward`` at the same ``attn_impl`` bit
    for bit; it only synchronises between them. For inspection, not serving.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import time
from typing import Callable, List, Optional, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama.model import (
    KVCache,
    LlamaParams,
    decoder_block,
    layer_weights,
    output_head,
    prepare_forward,
)
from llama_nuts_and_bolts_tpu_torch.utils.logging import get_logger


SPAN_RING = 1 << 17            # spans kept: tens of minutes of serving
_clock = time.perf_counter_ns
_new_span = object.__new__
# open device_trace blocks: only inside one does a span become a range too
_tracing = 0


class _Span:
    """One span being timed: the handle of ``with SPANS.span(...) as s``.
    ``s.id`` is the parent of the spans inside, ``s.t0`` its start;
    ``s.counts`` may be added to until the block ends, and later through the
    same dict, which the recorded span holds when it is not empty (a
    batcher adds a step's routing counts when its tokens are read back). Made by
    :meth:`SpanRecorder.span` without an ``__init__`` call, and entered and
    left with two clock reads: the hot path makes several a step."""

    __slots__ = ("_append", "name", "id", "parent", "counts", "t0", "_range")

    def __enter__(self) -> "_Span":
        self.t0 = _clock()
        return self

    def __exit__(self, et, ev, tb) -> None:
        self._append((self.name, self.t0, _clock(), self.id, self.parent,
                      self.counts or None))


class _ProfiledSpan(_Span):
    """A span made inside :func:`device_trace`: also a ``record_function``
    range of its name, which the trace shows."""

    __slots__ = ()

    def __enter__(self) -> "_Span":
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, et, ev, tb) -> None:
        _Span.__exit__(self, et, ev, tb)
        self._range.__exit__(et, ev, tb)


class SpanRecorder:
    """A bounded ring of spans, each a plain tuple ``(name, t0_ns, t1_ns, id,
    parent_id, counts)`` on the ``time.perf_counter_ns()`` clock; ``counts``
    is ``None`` or a small dict of ints (rows, tokens: the work the span
    did). Recording costs two clock reads and a tuple: no device operation,
    no synchronisation, no switch to turn it on. ``deque.append`` is atomic
    under the GIL, so any thread records. Inside :func:`device_trace` a
    :meth:`span` also enters ``torch.profiler.record_function`` under its
    name, so the trace shows it; under any other profiler it does not: a
    range's copy on the device's timeline (a GPU user annotation) covers
    the card's idle gaps between its kernels, and a reader of device
    intervals would count them busy (entering a range also costs
    microseconds).

    Ids come from one counter: a span's own unless given. A batched
    request's spans carry its ``Request.rid``; an engine call's spans name
    the id the call drew as their parent. Both come from :meth:`new_id`, so
    no two things share an id within a process."""

    def __init__(self, maxlen: int = SPAN_RING) -> None:
        self._ring: "collections.deque[tuple]" = collections.deque(maxlen=maxlen)
        self._append = self._ring.append
        self._ids = itertools.count()

    def new_id(self) -> int:
        return next(self._ids)

    def span(self, name: str, id: Optional[int] = None, parent: Optional[int] = None,
             **counts: int) -> _Span:
        """``with SPANS.span(name) as s:`` records a span around the block."""
        s = _new_span(_ProfiledSpan if _tracing else _Span)
        s._append = self._append
        s.name = name
        s.id = next(self._ids) if id is None else id
        s.parent = parent
        s.counts = counts
        return s

    def add(self, name: str, t0_ns: int, t1_ns: int, id: Optional[int] = None,
            parent: Optional[int] = None, **counts: int) -> None:
        """Record a span whose start was stamped earlier (a request's queue
        wait, from its submit)."""
        self._append((name, t0_ns, t1_ns, next(self._ids) if id is None else id, parent,
                      counts or None))

    def between(self, lo_ns: int, hi_ns: int) -> List[tuple]:
        """The recorded spans that start in ``[lo_ns, hi_ns)``, in the order
        they ended."""
        return [s for s in self._ring.copy() if lo_ns <= s[1] < hi_ns]


SPANS = SpanRecorder()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``with device_trace("/tmp/trace") as prof:`` traces the block with
    ``torch.profiler`` (host activity on every thread, a server's batcher
    thread included, and the card's where there is one) and on exit writes a
    Chrome trace ``trace_*.json`` of its own into ``log_dir``.
    ``prof.key_averages()`` gives the times by name after the block."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    global _tracing
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    # a profiler records the operators of the thread that started it and of
    # threads started later, not of a thread already running, unless asked
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        _tracing += 1
        try:
            yield prof
            if cuda:
                torch.cuda.synchronize()
        finally:
            _tracing -= 1
    fd, path = tempfile.mkstemp(prefix="trace_", suffix=".json", dir=log_dir)
    os.close(fd)
    prof.export_chrome_trace(path)


def narrated_forward(
    params: LlamaParams,
    cfg: ModelArgs,
    tokens: torch.Tensor,
    start_pos: int,
    cache: KVCache,
    log_fn: Optional[Callable[[str], None]] = None,
    attn_impl: str = "plain",
    logits_at: Optional[int] = None,
    mesh=None,
) -> Tuple[torch.Tensor, KVCache]:
    """``forward`` with per-layer wall-clock and shape narration: one line
    for the embeddings, one a layer, one for the output norm and head
    (``cfg.n_layers + 2`` lines). On a card each time ends on a
    synchronisation, so it is the layer's device time plus its launches.
    Under ``mesh`` it runs this rank's shards, as ``forward`` does."""
    log = log_fn or (lambda msg: get_logger().info("%s", msg))
    on_card = tokens.device.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(tokens.device)

    t0 = time.perf_counter()
    x, inp = prepare_forward(params, cfg, tokens, start_pos, cache, attn_impl, mesh)
    sync()
    log(f"embeddings: shape{tuple(x.shape)} dtype={str(x.dtype).replace('torch.', '')} "
        f"took {time.perf_counter() - t0:.4f} sec(s)")
    for li in range(cfg.n_layers):
        t0 = time.perf_counter()
        x = decoder_block(layer_weights(params, li), li, x, inp)
        sync()
        log(f"Transformer block layer {li + 1} / {cfg.n_layers} was run, "
            f"took {time.perf_counter() - t0:.4f} sec(s)")
    t0 = time.perf_counter()
    logits = output_head(params, cfg, x, logits_at, mesh)
    sync()
    log(f"output norm+projection: logits{tuple(logits.shape)} "
        f"took {time.perf_counter() - t0:.4f} sec(s)")
    return logits, cache
