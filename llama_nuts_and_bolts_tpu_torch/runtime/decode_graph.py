"""Decode steps captured as CUDA graphs and replayed.

The port's counterpart of the JAX engine's jitted decode step (``_fwd``) and
of the k-step ``lax.scan``s it keeps in ``_chunk_fns`` (``decode_chunk``):
an eager decode step issues each of its kernels from Python (~1,700 at 32
layers); a captured one replays them all with one call.

  * :class:`DecodeSlot` holds the static device state of B rows decoding
    over one cache bucket: the token feed ``[B, 1]``, the positions ``[B]``,
    the bucket's :class:`KVCache`, the sampling temperature, the stop ids
    with a stop mask and a count ``[B]``, and the last step's logits. A
    graph keeps these addresses, so a request prefills into its slot's
    cache, and a slot serves one request at a time (``leased``).
  * :class:`DecodeGraph` runs k steps over a slot. A step is ``forward`` at
    S=1 at the per-row positions, a greedy argmax or a draw from the
    engine's generator (``ops.sampling.draw_token``); its token goes into
    ``out[j]`` and into the feed, and the positions advance. With ``stops``
    a row that has stopped repeats its stop token and its count stops
    (``device_loop.decode_block``). Nothing inside reads the host.
  * On a card the first replay warms up one step of the body on the
    capture stream, which makes every kernel library, split workspace,
    constant and cuBLAS workspace that the k steps touch; it then puts the
    slot's state and the generator back and captures the body. The
    warm-up's launches ran, so they count; the capture's did not, so
    :func:`uncounted` takes them back, and each replay adds them
    (:func:`add_launches`). A capture or replay
    that fails raises: nothing falls back to the eager step. On the CPU the
    same body runs eagerly on the same buffers.
  * :meth:`DecodeGraph.fetch` copies ``out`` to pinned host memory behind
    an event (two buffers in turn), so a second chunk can be queued before
    the first's tokens are read: the engine's pipelining.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.attention import flash_gqa_attention
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
    flash_decode_attention,
    flash_decode_attention_int8_mxu,
    flash_decode_attention_q8,
    flash_decode_attention_whole_head,
)
from llama_nuts_and_bolts_tpu_torch.kernels.paged_attention import (
    paged_flash_decode,
    paged_flash_decode_int8,
    paged_flash_decode_per_head,
)
from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import q4_matmul
from llama_nuts_and_bolts_tpu_torch.models.llama.model import forward
from llama_nuts_and_bolts_tpu_torch.ops.sampling import (
    draw_token,
    exponential_noise,
    greedy,
)

MAX_STOP_IDS = 8
# every kernel wrapper with a ``launches`` counter (K1..K8, K6's int8 mode)
KERNEL_WRAPPERS = (flash_gqa_attention, flash_decode_attention, flash_decode_attention_q8,
                   flash_decode_attention_int8_mxu, flash_decode_attention_whole_head,
                   paged_flash_decode, paged_flash_decode_int8,
                   paged_flash_decode_per_head, q4_matmul)


def launch_counts() -> Tuple[int, ...]:
    return tuple(fn.launches for fn in KERNEL_WRAPPERS)


def add_launches(delta: Sequence[int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the wrappers' counters (in
    :data:`KERNEL_WRAPPERS`' order)."""
    for fn, d in zip(KERNEL_WRAPPERS, delta):
        fn.launches += d * times


@contextlib.contextmanager
def uncounted():
    """Launches counted inside are taken back on exit, and the yielded list
    receives them, one entry per wrapper: a capture counts launches that do
    not run then, and each replay of the graph adds them."""
    before = launch_counts()
    delta: List[int] = []
    try:
        yield delta
    finally:
        delta.extend(a - b for a, b in zip(launch_counts(), before))
        add_launches(delta, -1)


_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every graph on ``device`` warms up and is captured on
    (a kernel's split workspace is made per stream)."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class DecodeSlot:
    """The static state of ``batch`` rows decoding over a ``cache_len``
    cache (see the module docstring)."""

    def __init__(self, engine, batch: int, cache_len: int, index: int) -> None:
        dev = engine.device
        self.batch, self.cache_len, self.index, self.device = batch, cache_len, index, dev
        self.cache = engine.new_cache(batch, cache_len)
        self.feed = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.temperature = torch.ones((), dtype=torch.float32, device=dev)
        self.stop_ids = torch.full((MAX_STOP_IDS,), -1, dtype=torch.int32, device=dev)
        self.stopped = torch.zeros((batch,), dtype=torch.bool, device=dev)
        self.count = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.logits = torch.zeros((batch, engine.model.cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
        self.leased = False
        cuda = dev.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        # host staging of feed and positions, copied in without a sync
        self._staging = torch.zeros((2, batch), dtype=torch.int32, pin_memory=cuda)
        self._staged = torch.cuda.Event() if cuda else None

    def set(self, tokens: Sequence[int], positions: Sequence[int]) -> None:
        """The next step's feed and positions, from the host."""
        if self._staged is not None:
            self._staged.synchronize()          # the last copy out of staging
        self._staging[0] = torch.tensor(tokens, dtype=torch.int32)
        self._staging[1] = torch.tensor(positions, dtype=torch.int32)
        self.feed.copy_(self._staging[0, :, None], non_blocking=True)
        self.pos.copy_(self._staging[1], non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    def begin_block(self, first: torch.Tensor, start_pos: int,
                    stop_ids: Sequence[int]) -> None:
        """Start a stop-tracking run (``stops``): feed ``first [B, 1]`` at
        ``start_pos``; a row whose first token is a stop id has stopped,
        and every count is 1 (the first token)."""
        if len(stop_ids) > MAX_STOP_IDS:
            raise ValueError(f"at most {MAX_STOP_IDS} stop ids, got {len(stop_ids)}")
        self.feed.copy_(first)
        self.pos.fill_(start_pos)
        self.stop_ids.fill_(-1)
        self.stop_ids[:len(stop_ids)] = torch.tensor(list(stop_ids), dtype=torch.int32)
        self.stopped.copy_(self.is_stop(first[:, 0]))
        self.count.fill_(1)

    def is_stop(self, tokens: torch.Tensor) -> torch.Tensor:
        return (tokens[:, None] == self.stop_ids).any(-1)


class DecodeGraph:
    """``k`` decode steps over ``slot``: greedy, sampled with the engine's
    generator and ``top_k``/``top_p`` (its temperature is the slot's), or
    greedy with stop tracking (``stops``)."""

    def __init__(self, engine, slot: DecodeSlot, k: int, sampled: bool = False,
                 stops: bool = False) -> None:
        # the model and generator, not the engine: an engine holds its
        # graphs, and a cycle would leave a dropped engine's graphs to the
        # cyclic collector, which may run during another graph's capture
        self.model, self.generator = engine.model, engine._generator
        self.slot, self.k = slot, k
        self.sampled, self.stops = sampled, stops
        self.top_k, self.top_p = engine.args.top_k, engine.args.top_p
        self.impl = engine._attn_impl(1, slot.cache_len)
        cuda = slot.device.type == "cuda"
        self.out = torch.zeros((k, slot.batch), dtype=torch.int32, device=slot.device)
        self._host = [torch.zeros((k, slot.batch), dtype=torch.int32, pin_memory=cuda)
                      for _ in range(2)]
        self._turn = 0
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.launches: Tuple[int, ...] = ()     # counted per replay
        self.replays = 0
        self.warmup_steps = 0
        # the warm-up and capture's host seconds, and the device memory they
        # keep reserved (the graph's pool, the capture stream's workspaces)
        self.capture_s, self.capture_bytes = 0.0, 0

    # ------------------------------------------------------------ the body

    def _step(self) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.slot
        logits, _ = forward(self.model.params, self.model.cfg, s.feed, s.pos, s.cache,
                            attn_impl=self.impl)
        row = logits[:, -1]
        if self.sampled:
            nxt = draw_token(row, self.generator, s.temperature, self.top_k, self.top_p)
        else:
            nxt = greedy(row)
        if self.stops:
            # rows already stopped repeat their stop token
            nxt = torch.where(s.stopped, s.feed[:, 0], nxt)
            s.count.add_((~s.stopped).to(torch.int32))
            s.stopped.logical_or_(s.is_stop(nxt))
        return nxt, row

    def _advance(self, nxt: torch.Tensor) -> None:
        self.slot.feed.copy_(nxt[:, None])
        self.slot.pos.add_(1)

    def _body(self) -> None:
        for j in range(self.k):
            nxt, row = self._step()
            self.out[j].copy_(nxt)
            self._advance(nxt)
        self.slot.logits.copy_(row)

    # ---------------------------------------------------------- capture, replay

    def _capture(self) -> None:
        s, gen = self.slot, self.generator
        # the capture empties the allocator's cache: so does the baseline
        torch.cuda.synchronize(s.device)
        torch.cuda.empty_cache()
        t0, reserved = time.perf_counter(), torch.cuda.memory_reserved(s.device)
        state = (s.feed, s.pos, s.stopped, s.count)
        saved = [t.clone() for t in state]
        rng = gen.get_state() if self.sampled else None
        stream = capture_stream(s.device)
        stream.wait_stream(torch.cuda.current_stream(s.device))
        with torch.cuda.stream(stream):
            # the warm-up step runs at a position the request has not
            # reached: the step that feeds the real token there writes it
            # again first
            self._advance(self._step()[0])
        torch.cuda.current_stream(s.device).wait_stream(stream)
        self.warmup_steps += 1
        for t, v in zip(state, saved):
            t.copy_(v)
        graph = torch.cuda.CUDAGraph()
        if self.sampled:
            gen.set_state(rng)
            graph.register_generator_state(gen)
        # no collection during the capture: freeing another graph there (its
        # reset) is an operation a capturing stream does not permit
        collecting = gc.isenabled()
        gc.disable()
        try:
            with uncounted() as delta:
                with torch.cuda.graph(graph, pool=s.pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self._body()
        finally:
            if collecting:
                gc.enable()
        self.launches = tuple(delta)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        self.capture_bytes = torch.cuda.memory_reserved(s.device) - reserved

    def replay(self) -> None:
        """Run the k steps: on a card the captured graph (captured at the
        first call), on the CPU the body itself."""
        if self.slot.device.type == "cuda":
            if self.graph is None:
                self._capture()
            self.graph.replay()
            add_launches(self.launches)
        else:
            self._body()
        self.replays += 1

    def fetch(self):
        """Queue the copy of the last replay's ``out`` to the host; pass the
        handle to :meth:`tokens`."""
        host = self._host[self._turn]
        self._turn ^= 1
        host.copy_(self.out, non_blocking=True)
        event = None
        if self.slot.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return host, event

    @staticmethod
    def tokens(handle) -> List[List[int]]:
        """``[k][B]`` tokens of a fetched replay (waits for its copy only)."""
        host, event = handle
        if event is not None:
            event.synchronize()
        return host.tolist()

    def rewind_rng(self, state: torch.Tensor, steps: int) -> None:
        """Set the generator to ``state`` moved on by ``steps`` draws, as
        ``steps`` sampled decode steps from ``state`` would leave it."""
        self.generator.set_state(state)
        for _ in range(steps):
            exponential_noise(self.slot.logits, self.generator)
