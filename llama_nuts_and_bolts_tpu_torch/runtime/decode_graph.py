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
    same body runs eagerly on the same buffers. Under the engine's mesh the
    body's collectives (two all-reduces a layer, the logits all-gather) are
    captured with it: the warm-up's eager collectives make the NCCL
    communicator first, which a capture cannot.
  * :meth:`DecodeGraph.fetch` copies ``out`` to pinned host memory behind
    an event (two buffers in turn), so a second chunk can be queued before
    the first's tokens are read: the engine's pipelining.
  * :class:`VerifyGraph` is speculative decoding's verify step over a
    one-row slot, the counterpart of the JAX engine's jitted S=k+1
    ``forward``: ``forward`` at S = k+1 over a static ``[1, k+1]`` feed
    (the emitted token and k drafts) from the slot's position, on the plain
    attention path (the JAX package's ``"xla"``), and the greedy argmax of
    every row into ``out [k+1]``. It shares the slot's cache and position
    with the slot's one-step :class:`DecodeGraph`; the host sets the
    position before each replay of either (:meth:`VerifyGraph.set`,
    :meth:`DecodeSlot.set`), and rejected rows past it stay unseen until
    the real tokens overwrite them. Warm-up, capture, counting and "a
    failed capture raises" are :class:`DecodeGraph`'s.
  * :class:`StepGraph` is a continuous batcher's plain decode step
    (``runtime/continuous.py``): its body is the batcher's step function
    (``paged_decode_step``, or ``forward`` at S=1 over the dense cache) over
    the static inputs of :class:`StepBuffers` -- feed ``[n_slots, 1]``,
    positions ``[n_slots]`` and, for the paged pool, block tables
    ``[n_slots, max_blocks]`` -- into static ``[n_slots, vocab]`` fp32
    logits. The batcher writes the inputs in stream order before each
    replay and samples the logits eagerly after it. Warm-up, capture,
    counting and "a failed capture raises" are :class:`DecodeGraph`'s; its
    warm-up is one run of the body, whose cache rows the replay after it
    writes again.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
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
from llama_nuts_and_bolts_tpu_torch.ops.moe import IDS_DTYPE
from llama_nuts_and_bolts_tpu_torch.ops.sampling import (
    draw_token,
    exponential_noise,
    greedy,
)
from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS

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


class _SlotGraph:
    """A body over ``slot`` (a :class:`DecodeSlot` or :class:`StepBuffers`:
    its ``device`` and graph ``pool``) whose tokens land in ``out`` (none
    without ``out_shape``): captured at the first :meth:`replay` on a card
    (one warm-up run first), run eagerly on the CPU. Subclasses give
    ``_warm_up`` and ``_body``."""

    def __init__(self, engine, slot, out_shape: Optional[Tuple[int, ...]]) -> None:
        # the model, not the engine: an engine holds its graphs, and a cycle
        # would leave a dropped engine's graphs to the cyclic collector,
        # which may run during another graph's capture
        self.model, self.slot, self.mesh = engine.model, slot, engine.mesh
        cuda = slot.device.type == "cuda"
        self.out, self._host = None, []
        if out_shape is not None:
            self.out = torch.zeros(out_shape, dtype=torch.int32, device=slot.device)
            self._host = [torch.zeros(out_shape, dtype=torch.int32, pin_memory=cuda)
                          for _ in range(2)]
        self._turn = 0
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.launches: Tuple[int, ...] = ()     # counted per replay
        self.replays = 0
        self.warmup_steps = 0
        # the warm-up and capture's host seconds, and the device memory they
        # keep reserved (the graph's pool, the capture stream's workspaces)
        self.capture_s, self.capture_bytes = 0.0, 0

    def _warm_up(self) -> None:
        """Run the body once, outside the graph, leaving the slot's state as
        it found it (on the capture stream)."""
        raise NotImplementedError

    def _body(self) -> None:
        raise NotImplementedError

    def _register(self, graph: "torch.cuda.CUDAGraph") -> None:
        """Ready the graph before its capture (a sampled body registers the
        generator)."""

    def _capture(self) -> None:
        """Warm up and capture; recorded as an ``engine.graph_capture`` span
        that counts the ``bytes`` the graph keeps reserved."""
        s = self.slot
        # the capture empties the allocator's cache: so does the baseline
        torch.cuda.synchronize(s.device)
        torch.cuda.empty_cache()
        t0, reserved = time.perf_counter_ns(), torch.cuda.memory_reserved(s.device)
        stream = capture_stream(s.device)
        stream.wait_stream(torch.cuda.current_stream(s.device))
        with torch.cuda.stream(stream):
            self._warm_up()
        torch.cuda.current_stream(s.device).wait_stream(stream)
        self.warmup_steps += 1
        graph = torch.cuda.CUDAGraph()
        self._register(graph)
        # no collection during the capture: freeing another graph there (its
        # reset) is an operation a capturing stream does not permit
        collecting = gc.isenabled()
        gc.disable()
        try:
            with uncounted() as delta:
                # thread_local: a call another thread makes during the capture
                # (the NCCL watchdog's event queries under a mesh) does not
                # invalidate it
                with torch.cuda.graph(graph, pool=s.pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self._body()
        finally:
            if collecting:
                gc.enable()
        self.launches = tuple(delta)
        self.graph = graph
        t1 = time.perf_counter_ns()
        self.capture_s = (t1 - t0) / 1e9
        self.capture_bytes = torch.cuda.memory_reserved(s.device) - reserved
        SPANS.add("engine.graph_capture", t0, t1, bytes=self.capture_bytes)

    def replay(self) -> None:
        """Run the body: on a card the captured graph (captured at the first
        call), on the CPU the body itself."""
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
    def tokens(handle) -> list:
        """The tokens of a fetched replay, as a list (waits for its copy
        only)."""
        host, event = handle
        if event is not None:
            event.synchronize()
        return host.tolist()


class DecodeGraph(_SlotGraph):
    """``k`` decode steps over ``slot``: greedy, sampled with the engine's
    generator and ``top_k``/``top_p`` (its temperature is the slot's), or
    greedy with stop tracking (``stops``). :meth:`tokens` gives ``[k][B]``."""

    def __init__(self, engine, slot: DecodeSlot, k: int, sampled: bool = False,
                 stops: bool = False, impl: Optional[str] = None) -> None:
        super().__init__(engine, slot, (k, slot.batch))
        self.generator = engine._generator
        self.k = k
        self.sampled, self.stops = sampled, stops
        self.top_k, self.top_p = engine.args.top_k, engine.args.top_p
        # the attention path: the engine's for the bucket unless given (the
        # engine's probe times each candidate's graph)
        self.impl = impl or engine._attn_impl(1, slot.cache_len)
        self._rng = None

    # ------------------------------------------------------------ the body

    def _step(self) -> Tuple[torch.Tensor, torch.Tensor]:
        s = self.slot
        logits, _ = forward(self.model.params, self.model.cfg, s.feed, s.pos, s.cache,
                            attn_impl=self.impl, mesh=self.mesh)
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

    # ---------------------------------------------------------- capture

    def _warm_up(self) -> None:
        # one step, at a position the request has not reached: the step that
        # feeds the real token there writes it again first. The slot's state
        # and the generator are put back for the capture.
        s = self.slot
        state = (s.feed, s.pos, s.stopped, s.count)
        saved = [t.clone() for t in state]
        self._rng = self.generator.get_state() if self.sampled else None
        self._advance(self._step()[0])
        for t, v in zip(state, saved):
            t.copy_(v)

    def _register(self, graph) -> None:
        if self.sampled:
            self.generator.set_state(self._rng)
            graph.register_generator_state(self.generator)

    def rewind_rng(self, state: torch.Tensor, steps: int) -> None:
        """Set the generator to ``state`` moved on by ``steps`` draws, as
        ``steps`` sampled decode steps from ``state`` would leave it."""
        self.generator.set_state(state)
        for _ in range(steps):
            exponential_noise(self.slot.logits, self.generator)


class VerifyGraph(_SlotGraph):
    """Speculative decoding's verify step over a one-row ``slot``: the emitted
    token and ``k`` drafts through one ``forward`` at S = k+1, the argmax of
    every row into ``out [k+1]`` (see the module docstring). The caller keeps
    ``position + k + 1`` within the slot's cache."""

    def __init__(self, engine, slot: DecodeSlot, k: int) -> None:
        if slot.batch != 1:
            raise ValueError(f"a verify step runs over a one-row slot, got {slot.batch} rows")
        super().__init__(engine, slot, (k + 1,))
        self.k = k
        cuda = slot.device.type == "cuda"
        self.feed = torch.zeros((1, k + 1), dtype=torch.int32, device=slot.device)
        # host staging of the feed and the position, copied in without a sync
        self._staging = torch.zeros((k + 2,), dtype=torch.int32, pin_memory=cuda)
        self._staged = torch.cuda.Event() if cuda else None

    def set(self, tokens: Sequence[int], position: int) -> None:
        """The next verify's ``k+1`` tokens, the first at ``position`` (the
        slot's position)."""
        if self._staged is not None:
            self._staged.synchronize()          # the last copy out of staging
        self._staging[:-1] = torch.tensor(tokens, dtype=torch.int32)
        self._staging[-1] = position
        self.feed.copy_(self._staging[None, :-1], non_blocking=True)
        self.slot.pos.copy_(self._staging[-1:], non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    def _body(self) -> None:
        s = self.slot
        logits, _ = forward(self.model.params, self.model.cfg, self.feed, s.pos, s.cache,
                            attn_impl="plain", mesh=self.mesh)
        self.out.copy_(greedy(logits[0]))

    def _warm_up(self) -> None:
        # the rows the replay after it writes again; nothing else moves
        self._body()


class StepBuffers:
    """The static device state of a batcher's plain decode step (see the
    module docstring): ``feed [n_slots, 1]``, ``pos [n_slots]``, ``tables
    [n_slots, max_blocks]`` (None for the dense cache), ``logits
    [n_slots, vocab]`` and, for a model with experts, the routing ``ids``
    ``routing_shape = [L, n_slots, k]`` the step writes, allocated once.
    :meth:`stage` takes a quantum's host inputs through pinned memory,
    ``depth`` buffers in turn, each written again only once an event says
    its last copy has run."""

    def __init__(self, device: torch.device, n_slots: int, vocab: int, quantum: int,
                 max_blocks: int = 0, depth: int = 3,
                 routing_shape: Optional[Tuple[int, int, int]] = None) -> None:
        cuda = device.type == "cuda"
        self.device = device
        self.feed = torch.zeros((n_slots, 1), dtype=torch.int32, device=device)
        self.pos = torch.zeros((n_slots,), dtype=torch.int32, device=device)
        self.tables = (torch.zeros((n_slots, max_blocks), dtype=torch.int32, device=device)
                       if max_blocks else None)
        self.logits = torch.zeros((n_slots, vocab), dtype=torch.float32, device=device)
        # a model with experts: the experts each row chose, a layer
        self.ids = (torch.zeros(routing_shape, dtype=IDS_DTYPE, device=device)
                    if routing_shape else None)
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        # the quantum's positions, a row a step, which set_positions copies
        # into ``pos`` before the step's replay
        self._positions = torch.zeros((quantum, n_slots), dtype=torch.int32, device=device)
        # host staging: [feed | positions | tables]
        width = n_slots * (1 + quantum + max_blocks)
        self._staging = [torch.zeros(width, dtype=torch.int32, pin_memory=cuda)
                         for _ in range(depth)]
        self._staged: List[Optional[torch.cuda.Event]] = [
            torch.cuda.Event() if cuda else None for _ in range(depth)]
        self._turn = 0

    def stage(self, positions: np.ndarray, tables: Optional[np.ndarray] = None,
              feed: Optional[np.ndarray] = None) -> None:
        """Queue the copies of a quantum's host inputs: its steps' positions
        ``[quantum, n_slots]``, the block tables and, when the host holds
        it, the feed ``[n_slots]``."""
        i = self._turn
        self._turn = (i + 1) % len(self._staging)
        if self._staged[i] is not None:
            self._staged[i].synchronize()       # the last copy out of this buffer
        host, n = self._staging[i], self.pos.shape[0]
        view, p1 = host.numpy(), n + self._positions.numel()
        view[n:p1] = positions.reshape(-1)
        self._positions.copy_(host[n:p1].view(self._positions.shape), non_blocking=True)
        if tables is not None:
            view[p1:] = tables.reshape(-1)
            self.tables.copy_(host[p1:].view(self.tables.shape), non_blocking=True)
        if feed is not None:
            view[:n] = feed
            self.feed.copy_(host[:n, None], non_blocking=True)
        if self._staged[i] is not None:
            self._staged[i].record()

    def set_positions(self, step: int) -> None:
        """The positions of the quantum's step ``step``, into ``pos``."""
        self.pos.copy_(self._positions[step])


class StepGraph(_SlotGraph):
    """A batcher's plain decode step over ``bufs`` (see the module
    docstring): ``step(feed, pos, tables)`` gives ``[n_slots, vocab]`` fp32
    logits, copied into ``bufs.logits``. ``step`` holds the model, the cache
    and the mesh, never the batcher, which holds the graph."""

    def __init__(self, engine, bufs: StepBuffers,
                 step: Callable[..., torch.Tensor]) -> None:
        super().__init__(engine, bufs, None)
        self.step = step

    def _body(self) -> None:
        b = self.slot
        b.logits.copy_(self.step(b.feed, b.pos, b.tables))

    def _warm_up(self) -> None:
        # the cache rows the replay after it writes again; nothing else moves
        self._body()
