"""Continuous batching: requests join and leave a shared decode loop.

Port of ``llama_nuts_and_bolts_tpu/runtime/continuous.py``. B cache SLOTS
advance through one batched decode step per iteration, each row at its own
position (``forward``'s ``[B]`` ``start_pos``), so a request admitted
mid-flight shares the step's weight reads with the requests already
decoding.

  * Prefill targets one slot: it runs on a view of the slot's cache rows and
    writes them in place (the plain attention path, as in the JAX package).
  * Free and finished slots keep stepping with a pad token; their cache
    writes are harmless -- a slot's garbage at position p is overwritten by
    the step that consumes the real token at p before any query row >= p
    runs.
  * Per-request sampling: each slot carries its own (temperature, top-k,
    top-p, seed); a row's token depends only on its seed, prompt and
    position, never on its batch neighbours (``ops/sampling.py``).
    Temperature 0 rows take the argmax.
  * The plain decode step is one replay of a CUDA graph
    (``runtime/decode_graph.py::StepGraph``), captured at the batcher's
    first dispatch on a card over static device buffers of the step's
    inputs, allocated once at the batcher's fixed shape
    (:class:`~llama_nuts_and_bolts_tpu_torch.runtime.decode_graph.StepBuffers`):
    the feed ``[n_slots, 1]``, the positions ``[n_slots]`` and, for the
    paged batcher, the block tables ``[n_slots, max_blocks]``. Free slots
    step with a pad token, so the shape never changes. Each dispatch writes
    them in place, in stream order: the previous step's sampled tokens,
    just-admitted rows' first tokens spliced in on the device, the host's
    positions and the tables as the quantum's block growth left them (host
    values through pinned staging buffers behind events). The graph holds
    the forward (``paged_decode_step``; here ``forward`` at S=1 over the
    dense cache) and writes static ``[n_slots, vocab]`` fp32 logits;
    sampling runs eagerly on them after each replay (``ops/sampling.py``),
    so a sampled row's draws are its ``row_seed(seed, position)``'s. On the
    CPU the same body runs eagerly on the same buffers. A capture that
    fails raises: nothing falls back to an eager step. ``graph_steps``
    counts the steps replayed from a captured graph.
  * Pipelining: PyTorch queues a step's replay and sample and returns, so up
    to ``PIPELINE_DEPTH`` quanta stay in flight; each feeds the previous
    step's sampled tokens on the device. A quantum's tokens (an admission's
    first token) are copied to pinned host memory behind an event when they
    are queued, and the host reads them back (the only synchronisation,
    which waits for those copies alone) while the next quanta run.
    Positions are the host's: they advance when a step is dispatched, so a
    step never waits for a read-back. Occupancy changes never flush: every
    entry carries a slots snapshot, and delivery drops rows whose slot
    changed hands.
  * ``step_quantum`` k runs k decode steps back to back per iteration, k
    replays of the one graph, each sampled before the next; with k > 1
    admission and stops act every k tokens; the default is 1.
  * Speculation (``speculate_k`` K > 0): each greedy slot without logprobs
    drafts up to K tokens by n-gram prompt lookup, and every slot's feed
    token and drafts verify in one ``[B, K+1]`` forward at per-row
    positions (the plain attention path, eager: no graph); a speculating
    slot emits its accepted drafts and the model's own next token, the
    others their row-0 sample. Admission is synchronous (the proposer needs the first
    token), the quantum is 1, and the dense cache holds K rows past the
    context, where rejected draft rows may land.

Tensor parallelism (the engine's ``mesh``): every rank runs a batcher over
its shards -- the dense cache from ``engine.new_cache`` holds a rank's KV
heads, every forward passes the mesh (K2 and K4 through
``tp_flash_decode_attention`` on a card, K8 on a rank's int4 shards) -- and
every rank must make the same calls in the same order, or a collective
waits forever. JAX schedules every device from one thread; here each rank
is a process, and a batcher's decisions that depend on timing (which
requests arrived before a step, which were cancelled, whether to step at
all) are rank 0's alone. So they travel in a :class:`StepRecord`:

  * on rank 0, ``submit`` and ``Request.cancel`` touch nothing ``step()``
    reads: a request goes to an inbox, a cancellation is latched there;
  * at each step boundary rank 0 drains the inbox into one record (the
    arrivals in order with their prompts and sampling parameters, the ids
    of cancelled requests, a stop flag) and broadcasts it over the gloo
    control group (``parallel/launch.py``); every rank, rank 0 included,
    applies it to its ``pending`` queue and cancel flags, then runs the
    unchanged step. A follower's requests are shadows whose output is
    dropped (:meth:`ContinuousBatcher.follow`);
  * everything else a step does depends only on the batcher's state and on
    the all-gathered logits, the same on every rank: stop tokens and
    releases, the paged allocator and prefix cache, drafts and their
    clamping, the pipelined delivery, and sampled tokens (seeded by
    ``(seed, position)``);
  * an idle rank 0 broadcasts nothing, and the followers wait in the
    broadcast (a day, the control group's timeout); shutdown is a record
    with the stop flag set;
  * a step that fails on one rank ends that rank's process at once (rank
    0's thread through ``parallel/launch.py::abort``, a follower's
    :meth:`ContinuousBatcher.follow` by raising), and the watches of
    ``parallel/launch.py`` end the others: no rank waits on a record or a
    collective that a failed rank will not issue.

A mesh's dp and sp ranks are replicas of the batcher (``runtime/engine.py``):
each holds every slot, applies the same records and runs the same steps,
and its forwards meet only its own tp group.

Without a mesh nothing is broadcast and the batcher is as before.

Spans and counters (``runtime/profiling.py``'s ``SPANS``): a request's
``request.queued`` (submit to the start of the admission that seats it)
and ``request.first_token`` (that start to its first token's put), under
its id; each step's
``batcher.step`` with its children ``batcher.admit`` (one an admission
attempt, under the request's id), ``batcher.prepare`` (block growth, the static
inputs written), ``batcher.launch`` (the replays and samples, queued),
``batcher.readback`` (the host waits for the card) and ``batcher.deliver``
(the emit loop); a step's ``graphed`` counts its decode steps replayed from
a captured graph, and an admission's ``flash`` whether its prefill attended
on K1. The counters beside ``decode_steps`` (``graph_steps``,
``rows_stepped``, ``prefill_tokens``, ``prefill_padded_tokens``, ``prefill_cached_tokens``,
``prefill_flash``, ``admissions``, ``admission_stalls``, ``queue_wait_s``) are the
server's ``/metrics``.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
from llama_nuts_and_bolts_tpu_torch.ops.sampling import (
    greedy,
    sample_tokens_batched,
    top_logprobs_batched,
)
from llama_nuts_and_bolts_tpu_torch.runtime.decode_graph import StepBuffers, StepGraph
from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
from llama_nuts_and_bolts_tpu_torch.runtime.speculative import (
    NgramProposer,
    longest_accepted_prefix,
)
from llama_nuts_and_bolts_tpu_torch.runtime.types import GenerationState
from llama_nuts_and_bolts_tpu_torch.utils.logging import get_logger

LOGPROBS_K = 5   # OpenAI caps top_logprobs at 5 for completions
STOP_JOIN_S = 60.0   # how long stop() waits for rank 0's thread to send the stop record


def make_base_seed(seed: int) -> int:
    """A request's sampling seed as the unsigned 64-bit value its rows'
    generators are seeded from (``ops.sampling.row_seed``)."""
    return int(seed) & ((1 << 64) - 1)


@dataclass
class Request:
    """A submitted prompt and its streaming output queue."""

    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0                     # with temperature > 0: reproducible,
                                      # independent of batch neighbours
    want_logprobs: int = 0            # per-token top-N info (N <= 5)
    out: "queue.Queue[Tuple[GenerationState, int]]" = field(
        default_factory=queue.Queue)
    slot: Optional[int] = None
    produced: int = 0
    cancelled: bool = False
    # per emitted token, when want_logprobs > 0:
    # (token_id, chosen_logprob, [(top_id, top_logprob) x want_logprobs])
    logprobs: List[tuple] = field(default_factory=list)
    rid: int = -1                     # its id: the step records', its spans'
    finished: bool = False            # its last entry is on ``out``
    # perf_counter_ns of its submit and of the admission that seated it
    t_submit: int = 0
    t_admit: int = 0
    # under a mesh, rank 0's latch (the next step record carries the cancel)
    _latch: Optional[Callable[["Request"], None]] = field(default=None, repr=False)

    def cancel(self) -> None:
        """Stop generating for this request: its slot (and blocks) are
        released at the scheduler's next step, which also delivers a terminal
        CANCELLED sentinel so a consumer blocked in ``tokens()`` ends. Safe
        from any thread, at any time (a no-op after completion). Under a
        mesh the cancellation is latched for the next step record."""
        if self._latch is None:
            self.cancelled = True
        elif not self.finished:
            self._latch(self)

    def tokens(self, timeout: Optional[float] = None):
        """Iterate (state, token_id) until the request finishes. A cancelled
        request's stream ends (the sentinel is consumed here, never
        yielded)."""
        while True:
            state, tok = self.out.get(timeout=timeout)
            if state is GenerationState.CANCELLED:
                return
            yield state, tok
            if state != GenerationState.IN_PROGRESS:
                return


class _Dropped:
    """A follower's shadow request's output: rank 0 delivers the tokens."""

    @staticmethod
    def put(_item) -> None:
        pass


@dataclass
class StepRecord:
    """What rank 0 decided at one step boundary, for every rank to apply:
    the arrivals in submit order, each ``(rid, prompt, max_new_tokens,
    temperature, top_k, top_p, seed, logprobs)``, the ids of the requests
    cancelled since the last record, and the stop flag."""

    arrivals: List[tuple] = field(default_factory=list)
    cancels: List[int] = field(default_factory=list)
    stop: bool = False


class Lockstep:
    """A batcher's control group and rank 0's inbox (see the module
    docstring): ``submit`` and ``cancel`` on rank 0 land here, and each step
    boundary drains them into a :class:`StepRecord`."""

    def __init__(self, control) -> None:
        import torch.distributed as dist

        self.control = control
        self.leader = dist.get_rank(group=control) == 0
        self._lock = threading.Lock()
        self._arrivals: List[Request] = []
        self._cancels: List[int] = []

    def enqueue(self, req: Request) -> None:
        if not self.leader:
            raise RuntimeError("under a mesh only rank 0 submits; the followers "
                               "apply its step records (ContinuousBatcher.follow)")
        with self._lock:
            req.rid = SPANS.new_id()
            req._latch = self._latch
            self._arrivals.append(req)

    def _latch(self, req: Request) -> None:
        with self._lock:
            self._cancels.append(req.rid)

    @property
    def waiting(self) -> bool:
        """Rank 0 holds arrivals or cancellations for the next record."""
        return bool(self._arrivals or self._cancels)

    def exchange(self, stop: bool = False):
        """Rank 0: drain the inbox into a record and broadcast it; a
        follower: receive rank 0's. Returns (the record, its arrivals as
        this rank's requests)."""
        from llama_nuts_and_bolts_tpu_torch.parallel.launch import broadcast

        if self.leader:
            with self._lock:
                reqs, self._arrivals = self._arrivals, []
                cancels, self._cancels = self._cancels, []
            record = StepRecord(
                arrivals=[(r.rid, r.prompt, r.max_new_tokens, r.temperature, r.top_k,
                           r.top_p, r.seed, r.want_logprobs) for r in reqs],
                cancels=cancels, stop=stop)
            broadcast(record, self.control)
            return record, reqs
        record = broadcast(None, self.control)
        now = time.perf_counter_ns()
        return record, [Request(prompt=list(prompt), max_new_tokens=n, temperature=t,
                                top_k=k, top_p=p, seed=seed, want_logprobs=lp,
                                out=_Dropped(), rid=rid, t_submit=now)
                        for rid, prompt, n, t, k, p, seed, lp in record.arrivals]


class ContinuousBatcher:
    """Slot-based continuous batching over one ``InferenceEngine``'s model
    and a dense ``[L, n_slots, KV, seq_len, D]`` cache.

    ``step()`` admits waiting requests into free slots (one prefill each),
    then dispatches one quantum of batched decode steps for every slot, each
    a replay of the batcher's step graph (see the module docstring).
    Under the engine's mesh rank 0 steps and the followers :meth:`follow`;
    ``control`` is the gloo group the step records travel on
    (``parallel/launch.py::new_control_group``, made by every rank
    together)."""

    PIPELINE_DEPTH = 2

    def __init__(self, engine, n_slots: int = 8, speculate_k: int = 0,
                 step_quantum: Optional[int] = None, control=None):
        self._init_common(engine, n_slots, speculate_k, step_quantum, control)
        # speculating: rows [seq_len, seq_len + K) hold draft rows written
        # past the context, so a verify's K+1 rows always fit
        self.cache = engine.new_cache(n_slots, self.seq_len + speculate_k)
        # the engine's rule for a decode step into this cache: K2 on a card
        # (K4 for an int8 cache whose length is a multiple of 128), which
        # takes the [n_slots] positions. Under "probe" the auto rules, as in
        # the JAX batcher: the probe measures one row at one position, which
        # does not carry over to an [n_slots]-row step
        self._decode_impl = engine._auto_attn_impl(1, self.cache.max_seq)
        self._pos_cap = self.cache.max_seq - 1
        self._init_step_graph()

    def _init_common(self, engine, n_slots: int, speculate_k: int,
                     step_quantum: Optional[int], control=None) -> None:
        self.engine = engine
        self.mesh = engine.mesh
        self._lockstep: Optional[Lockstep] = None
        if self.mesh is not None:
            if control is None:
                raise ValueError("a batcher under a mesh needs the control group its step "
                                 "records travel on (parallel.launch.new_control_group)")
            self._lockstep = Lockstep(control)
        # every rank's live requests by id (the step records' cancels name them)
        self._live: Dict[int, Request] = {}
        self._thread: Optional[threading.Thread] = None
        self.cfg = engine.model.cfg
        self.vocab = engine.model.vocab
        self.device = engine.device
        self.n_slots = n_slots
        self.seq_len = engine.seq_len
        self.speculate_k = speculate_k
        # speculation steps one token (or one verified chain) at a time
        self.step_quantum = 1 if speculate_k else max(1, int(step_quantum or 1))
        self._proposers: List[Optional[NgramProposer]] = [None] * n_slots
        self.spec_stats = {"spec_steps": 0, "drafted": 0, "accepted": 0}
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.decode_steps = 0           # batched plain decode steps dispatched
        self.graph_steps = 0            # ... of them replayed from a captured graph
        self.verify_steps = 0           # batched speculative verify steps
        self.rows_stepped = 0           # live rows, summed over the decode steps
        self.prefill_tokens = 0         # prompt rows computed by admissions
        self.prefill_padded_tokens = 0  # their buckets' padding rows
        self.prefill_cached_tokens = 0  # prompt rows the prefix cache gave
        self.prefill_flash = 0          # admission prefills that attended on K1
        self.admissions = 0
        self.admission_stalls = 0       # admission attempts the pool turned back
        self.queue_wait_s = 0.0         # submit to admission, summed
        self._step = None               # the running step's ``batcher.step`` span
        # per-slot feed token and the position it is written at
        self._feed = np.zeros(n_slots, dtype=np.int32)
        self._pos = np.zeros(n_slots, dtype=np.int32)
        self._init_sampling_state(n_slots)
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self._lock = threading.Lock()
        # work in flight, oldest first, each with its host copies (_to_host):
        #   ("q", (tokens [k, B], logprob info?), force, epos, slots snapshot)
        #   ("admit", slot, req, (first token [1], logprob info?), position)
        self._inflight: list = []
        # the last dispatched step's sampled tokens [B, 1], on the device:
        # the next step's feed; None = feed from the host
        self._last_tok: Optional[torch.Tensor] = None
        # rows to feed anew at the next dispatch (just admitted), and their
        # first tokens, still on the device
        self._splice = np.zeros(n_slots, dtype=bool)
        self._first_dev: list = [None] * n_slots
        self._stop = threading.Event()

    # ------------------------------------------------------------- public

    def submit(self, prompt_tokens: Sequence[int],
               max_new_tokens: int = 1 << 30, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               logprobs: int = 0) -> Request:
        prompt = list(prompt_tokens)
        if not prompt or len(prompt) >= self.seq_len:
            raise ValueError("prompt must be non-empty and shorter than context")
        if not 0 <= logprobs <= LOGPROBS_K:
            raise ValueError(f"logprobs must be in [0, {LOGPROBS_K}]")
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed, want_logprobs=logprobs, t_submit=time.perf_counter_ns())
        if self._lockstep is not None:
            self._lockstep.enqueue(req)
        else:
            req.rid = SPANS.new_id()
            self.pending.put(req)
        return req

    @property
    def has_work(self) -> bool:
        return (any(r is not None for r in self.slots) or not self.pending.empty()
                or (self._lockstep is not None and self._lockstep.waiting))

    def spec_stats_snapshot(self) -> dict:
        """A copy of ``spec_stats`` taken under the step's lock, so the three
        counters come from one step."""
        with self._lock:
            return dict(self.spec_stats)

    def run_until_idle(self) -> None:
        while self.has_work:
            self.step()

    # ----------------------------------------------- per-slot sampling state

    def _init_sampling_state(self, n_slots: int) -> None:
        self._seed = [0] * n_slots
        self._temp = np.zeros(n_slots, dtype=np.float32)
        self._topk = np.zeros(n_slots, dtype=np.int32)
        self._topp = np.ones(n_slots, dtype=np.float32)

    def _set_sampling(self, slot: int, req: Request) -> None:
        self._seed[slot] = make_base_seed(req.seed)
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p

    def _clear_sampling(self, slot: int) -> None:
        self._seed[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 1.0

    def _sample(self, logits: torch.Tensor, rows: Sequence[int], positions):
        """Tokens and logprob info of ``logits [len(rows), vocab]`` with the
        sampling state of slots ``rows`` at ``positions``."""
        tok = sample_tokens_batched(
            logits, [self._seed[r] for r in rows], positions,
            self._temp[rows], self._topk[rows], self._topp[rows])
        return tok, top_logprobs_batched(logits, tok, LOGPROBS_K)

    # ----------------------------------------------------------- admission

    def _next_waiting(self) -> Optional[Request]:
        try:
            return self.pending.get_nowait()
        except queue.Empty:
            return None

    def _admit(self) -> None:
        """Seat waiting requests in free slots, in order, each attempt under
        a ``batcher.admit`` span; one that cannot be seated yet ends the
        pass (:meth:`_seat`)."""
        for slot in range(self.n_slots):
            if self.slots[slot] is not None:
                continue
            req = self._next_waiting()
            if req is None:
                return
            if req.cancelled:
                self._finish(req, GenerationState.CANCELLED)
                continue
            with SPANS.span("batcher.admit", id=req.rid, parent=self._step.id,
                            prompt=len(req.prompt)) as span:
                seated = self._seat(slot, req, span)
            if not seated:
                return

    def _seated(self, req: Request, span, cached: int, computed: int, bucket: int,
                flash: bool = False) -> None:
        """Count an admission that seats ``req`` (its prefill computes
        ``computed`` prompt rows in a ``bucket``, after ``cached`` rows from
        the prefix cache, attending on K1 when ``flash``): its queue wait
        ends where the admission began."""
        req.t_admit = span.t0
        SPANS.add("request.queued", req.t_submit, span.t0, id=req.rid)
        span.counts.update(cached=cached, computed=computed, padded=bucket - computed,
                           flash=int(flash))
        self.admissions += 1
        self.prefill_flash += int(flash)
        self.queue_wait_s += (span.t0 - req.t_submit) / 1e9
        self.prefill_tokens += computed
        self.prefill_padded_tokens += bucket - computed
        self.prefill_cached_tokens += cached

    def _seat(self, slot: int, req: Request, span) -> bool:
        """Prefill ``req`` into ``slot`` and seat it; always seats."""
        from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

        plen = len(req.prompt)
        bucket = prefill_bucket(plen, self.seq_len)
        self._seated(req, span, 0, plen, bucket)
        self._set_sampling(slot, req)
        first, lp = self._prefill_slot(slot, req, bucket)
        self._occupy(slot, req, first, lp)
        return True

    def _prefill_slot(self, slot: int, req: Request, bucket: int):
        """Prefill ``req`` into slot ``slot``'s rows of the shared cache (a
        view, written in place) in a ``bucket`` of rows; returns its first
        token and logprob info, on the device."""
        plen = len(req.prompt)
        padded = torch.zeros((1, bucket), dtype=torch.int32)
        padded[0, :plen] = torch.tensor(req.prompt, dtype=torch.int32)
        c = self.cache
        rows = slice(slot, slot + 1)
        view = KVCache(k=c.k[:, rows], v=c.v[:, rows],
                       k_scale=None if c.k_scale is None else c.k_scale[:, rows],
                       v_scale=None if c.v_scale is None else c.v_scale[:, rows])
        logits, _ = forward(self.engine.model.params, self.cfg, padded.to(self.device),
                            0, view, logits_at=plen - 1, mesh=self.mesh)
        return self._sample(logits[:, 0], [slot], [plen - 1])

    def _occupy(self, slot: int, req: Request, first, lp) -> None:
        """Seat an admitted request. Its first token stays on the device: the
        next dispatch feeds it, and its delivery rides the in-flight queue,
        so admission never waits for the prefill. Speculating, the first
        token is read and emitted now: its proposer needs it."""
        plen = len(req.prompt)
        req.slot = slot
        self.slots[slot] = req
        self._pos[slot] = plen
        self._splice[slot] = True
        if self.speculate_k:
            with SPANS.span("batcher.readback", parent=self._step.id):
                tok = int(first[0])
            self._feed[slot] = tok
            self._first_dev[slot] = None
            if self._speculates(req):
                self._proposers[slot] = NgramProposer(req.prompt + [tok])
            if req.want_logprobs:
                self._record_logprobs(slot, tok, self._host_lp(lp, True))
            self._emit(slot, tok, plen)
            return
        self._first_dev[slot] = first[0]
        self._inflight.append(("admit", slot, req,
                               self._to_host(first, *(lp if req.want_logprobs else ())),
                               plen))

    @staticmethod
    def _speculates(req: Request) -> bool:
        """Only greedy requests without logprobs draft (a sampled row cannot
        be verified by argmax; logprobs need one step a token)."""
        return req.temperature <= 0.0 and not req.want_logprobs

    # ------------------------------------------------------------ delivery

    def _record_logprobs(self, slot: int, tok: int, lp, row: int = 0) -> None:
        """Append (token, chosen logprob, top list) for the request in
        ``slot`` if it asked; ``lp`` = host (chosen [N], vals [N, K], ids
        [N, K]), ``row`` picks the slot's entry."""
        req = self.slots[slot]
        if req is None or not req.want_logprobs:
            return
        chosen, vals, ids = (a[row] for a in lp)
        n = req.want_logprobs
        req.logprobs.append((tok, float(chosen),
                             [(int(i), float(v)) for i, v in zip(ids[:n], vals[:n])]))

    def _emit(self, slot: int, tok: int, pos: int, force_finish: bool = False) -> None:
        """Classify and deliver one generated token for the request in
        ``slot`` (the sequential engine's stop rules); ``pos`` is the
        position the token is written at. ``force_finish`` ends the request
        after this token (the paged batcher's dry pool)."""
        req = self.slots[slot]
        req.produced += 1
        state = GenerationState.IN_PROGRESS
        if self.vocab.is_stop(tok):
            state = GenerationState.FINISHED_BY_REACHING_EOS
        elif pos + 1 >= self.seq_len or req.produced >= req.max_new_tokens or force_finish:
            state = GenerationState.FINISHED_BY_REACHING_SEQ_LEN
        if state == GenerationState.IN_PROGRESS:
            req.out.put((state, tok))
            put = time.perf_counter_ns()
        else:
            put = self._finish(req, state, tok)
            self._release_slot(slot)
        if req.produced == 1:
            SPANS.add("request.first_token", req.t_admit, put, id=req.rid)

    def _finish(self, req: Request, state: GenerationState, tok: int = -1) -> int:
        """Put a request's last entry on its queue; it leaves the live set.
        Returns the time of the put."""
        req.finished = True
        self._live.pop(req.rid, None)
        req.out.put((state, tok))
        return time.perf_counter_ns()

    def _release_slot(self, slot: int) -> None:
        """Free the slot; it keeps stepping with a pad token (see the module
        docstring)."""
        self.slots[slot] = None
        self._feed[slot] = 0
        self._clear_sampling(slot)
        self._proposers[slot] = None

    def _sweep_cancelled(self) -> None:
        for slot, r in enumerate(self.slots):
            if r is not None and r.cancelled:
                self._release_slot(slot)
                # after the release, in-flight rows of this slot are dropped,
                # so the sentinel is the queue's last entry
                self._finish(r, GenerationState.CANCELLED)

    @staticmethod
    def _host_lp(lp, wanted: bool):
        return tuple(t.cpu().numpy() for t in lp) if wanted else None

    def _to_host(self, *tensors):
        """Queue the copies of ``tensors`` to pinned host memory and an event
        after them: :meth:`_from_host` then waits for these copies alone, not
        for the steps queued later."""
        host = tuple(t.to("cpu", non_blocking=True) for t in tensors)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return host, event

    @staticmethod
    def _from_host(handle):
        """The numpy arrays of a :meth:`_to_host` handle, once copied."""
        host, event = handle
        if event is not None:
            event.synchronize()
        return [t.numpy() for t in host]

    def _process_entry(self, entry) -> None:
        """Read an in-flight entry's tokens back (``batcher.readback``: the
        host waits for the card) and deliver them (``batcher.deliver``)."""
        if entry[0] == "admit":
            _tag, slot, req, fetched, pos = entry
            if self.slots[slot] is not req:      # cancelled before its first token
                return
            with SPANS.span("batcher.readback", parent=self._step.id):
                first, *lp = self._from_host(fetched)
                tok = int(first[0])
                lp = tuple(lp) or None
            with SPANS.span("batcher.deliver", parent=self._step.id):
                self._feed[slot] = tok
                if lp is not None:
                    self._record_logprobs(slot, tok, lp)
                self._emit(slot, tok, pos)
            return
        _tag, fetched, force, epos, snapshot = entry
        with SPANS.span("batcher.readback", parent=self._step.id):
            toks, *lp = self._from_host(fetched)
            lp = tuple(lp) or None
        with SPANS.span("batcher.deliver", parent=self._step.id):
            for j in range(toks.shape[0]):
                for slot in range(self.n_slots):
                    # rows whose slot changed hands since dispatch belong to an
                    # ended request's garbage chain
                    if snapshot[slot] is None or snapshot[slot] is not self.slots[slot]:
                        continue
                    tok = int(toks[j, slot])
                    self._feed[slot] = tok
                    if lp is not None:
                        self._record_logprobs(slot, tok, tuple(a[j] for a in lp), row=slot)
                    self._emit(slot, tok, int(epos[j, slot]), force_finish=force[j][slot])

    def _quanta_in_flight(self) -> int:
        return sum(1 for e in self._inflight if e[0] == "q")

    def _flush_inflight(self) -> None:
        while self._inflight:
            self._process_entry(self._inflight.pop(0))
        self._last_tok = None

    # -------------------------------------------------------------- decode

    def _advance_quantum(self, k: int):
        """Advance every slot's position ``k`` steps (capped); returns the
        fed positions of each step ``[k, B]``, the emitted tokens' positions
        ``epos [k, B]`` and per-step force-finish flags (none here)."""
        fed = np.zeros((k, self.n_slots), np.int32)
        epos = np.zeros((k, self.n_slots), np.int32)
        for j in range(k):
            fed[j] = self._pos
            self._pos = np.minimum(self._pos + 1, self._pos_cap).astype(np.int32)
            epos[j] = self._pos
        return fed, epos, [[False] * self.n_slots for _ in range(k)]

    def _init_step_graph(self, max_blocks: int = 0) -> None:
        """The static buffers of the plain decode step and its graph: one a
        batcher, over its cache or pool, ``n_slots``, ``max_blocks`` and
        attention path, captured at the first dispatch on a card."""
        bufs = StepBuffers(self.device, self.n_slots, self.cfg.vocab_size, self.step_quantum,
                           max_blocks, depth=self.PIPELINE_DEPTH + 1)
        self._step_graph = StepGraph(self.engine, bufs, self._step_fn())

    def _step_fn(self):
        """The plain decode step as a function of the static buffers:
        ``(feed, positions, tables)`` to ``[B, vocab]`` fp32 logits. It holds
        the model, the cache and the mesh, not the batcher, which holds its
        graph."""
        params, cfg, cache = self.engine.model.params, self.cfg, self.cache
        impl, mesh = self._decode_impl, self.mesh

        def step(feed, positions, _tables):
            logits, _ = forward(params, cfg, feed, positions, cache, attn_impl=impl,
                                mesh=mesh)
            return logits[:, -1]

        return step

    def _host_tables(self) -> Optional[np.ndarray]:
        """The block tables the step reads (the paged batcher's)."""
        return None

    def _load_feed(self, feed: torch.Tensor) -> None:
        """Write the next step's ``[B, 1]`` feed in place: the last step's
        tokens on the device (the host's feed is staged when no step is in
        flight), with just-admitted rows' first tokens spliced in."""
        if self._last_tok is not None:
            feed.copy_(self._last_tok)
        for slot in np.nonzero(self._splice)[0]:
            fd = self._first_dev[slot]
            feed[slot, 0] = fd if fd is not None else int(self._feed[slot])
            self._first_dev[slot] = None
        self._splice[:] = False

    def _dispatch(self) -> None:
        """Queue one quantum of ``step_quantum`` decode steps, each a replay
        of the step graph over the static buffers and a sample of its
        logits; nothing waits for the device. The running step's span counts
        its steps, their live rows and the steps replayed from a captured
        graph (``graphed``)."""
        step = self._step
        k = self.step_quantum
        live = sum(r is not None for r in self.slots)
        graph = self._step_graph
        bufs = graph.slot
        with SPANS.span("batcher.prepare", parent=step.id):
            host_feed = self._feed if self._last_tok is None else None
            fed, epos, force = self._advance_quantum(k)
            # the tables as the quantum's growth left them
            bufs.stage(fed, self._host_tables(), host_feed)
            self._load_feed(bufs.feed)
        with SPANS.span("batcher.launch", parent=step.id):
            rows = list(range(self.n_slots))
            out_toks, out_lp = [], []
            for j in range(k):
                if j:
                    bufs.feed.copy_(tok[:, None])
                bufs.set_positions(j)
                graph.replay()
                tok, lp = self._sample(bufs.logits, rows, fed[j])
                out_toks.append(tok)
                out_lp.append(lp)
            wanted = any(r is not None and r.want_logprobs for r in self.slots)
            lp = tuple(torch.stack(parts) for parts in zip(*out_lp)) if wanted else ()
            fetched = self._to_host(torch.stack(out_toks), *lp)
        graphed = k if graph.graph is not None else 0
        self.decode_steps += k
        self.graph_steps += graphed
        self.rows_stepped += live * k
        step.counts["rows"] = live * k          # a step dispatches once
        step.counts["steps"] = k
        step.counts["graphed"] = graphed
        self._last_tok = tok[:, None]
        self._inflight.append(("q", fetched, force, epos, list(self.slots)))

    def step(self) -> None:
        """Admit, then dispatch one quantum while up to ``PIPELINE_DEPTH``
        earlier quanta are still in flight; deliver the oldest beyond that,
        and every admission's first token (its prefill is queued before the
        quantum, so this waits at most for the prefill). Speculating, one
        verify step (:meth:`_step_speculative`). Under a mesh (rank 0) the
        step record goes out first."""
        if self._lockstep is not None:
            if not self._lockstep.leader:
                raise RuntimeError("a follower's batcher steps in follow()")
            self._exchange()
        self._step_once()

    def follow(self) -> None:
        """A follower's loop under a mesh: apply each of rank 0's step
        records and step, until the record that stops."""
        while not self._exchange().stop:
            self._step_once()

    def _exchange(self, stop: bool = False) -> StepRecord:
        """Send (rank 0) or receive the step record and apply it: arrivals
        join ``pending`` in order, cancelled ids set their requests' flags."""
        record, reqs = self._lockstep.exchange(stop)
        for r in reqs:
            self._live[r.rid] = r
            self.pending.put(r)
        for rid in record.cancels:
            r = self._live.get(rid)
            if r is not None:
                r.cancelled = True
        return record

    def _step_once(self) -> None:
        """One step under a ``batcher.step`` span, which counts the decode
        steps it dispatched (``steps``), those replayed from a captured graph
        (``graphed``) and their live rows (``rows``), if it dispatched any."""
        with SPANS.span("batcher.step") as self._step:
            if self.speculate_k:
                self._step_speculative()
                return
            with self._lock:
                self._sweep_cancelled()
                self._admit()
                if not any(r is not None for r in self.slots):
                    self._flush_inflight()
                    return
                self._plain_step_locked()

    def _plain_step_locked(self) -> None:
        """Dispatch one quantum and deliver what :meth:`step` says; the
        caller holds the lock and has admitted."""
        self._dispatch()
        while self._quanta_in_flight() > self.PIPELINE_DEPTH:
            self._process_entry(self._inflight.pop(0))
        if any(e[0] == "admit" for e in self._inflight):
            keep = []
            for e in self._inflight:
                if e[0] == "admit":
                    self._process_entry(e)
                else:
                    keep.append(e)
            self._inflight = keep

    # --------------------------------------------------------- speculation

    def _verify_logits(self, toks: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """``[B, K+1, vocab]`` fp32 logits of one verify forward."""
        logits, _ = forward(self.engine.model.params, self.cfg, toks, positions,
                            self.cache, mesh=self.mesh)
        return logits

    def _verify(self, tokens: np.ndarray, positions: np.ndarray):
        """One batched verify step of ``tokens [B, K+1]`` at ``positions``:
        the greedy argmax of every row ``[B, K+1]`` (the verification chain),
        each slot's row-0 sample (for slots that do not speculate) and its
        logprob info, all on the host."""
        with SPANS.span("batcher.launch", parent=self._step.id):
            toks = torch.from_numpy(tokens.astype(np.int32)).to(self.device)
            pos = torch.from_numpy(positions.astype(np.int32)).to(self.device)
            logits = self._verify_logits(toks, pos)
            sampled0, lp = self._sample(logits[:, 0], list(range(self.n_slots)), positions)
            preds = greedy(logits)
        self.verify_steps += 1
        wanted = any(r is not None and r.want_logprobs for r in self.slots)
        with SPANS.span("batcher.readback", parent=self._step.id):
            return preds.cpu().numpy(), sampled0.cpu().numpy(), self._host_lp(lp, wanted)

    def _accepted_chain(self, slot: int, drafts, preds, sampled0) -> List[int]:
        """The tokens slot ``slot`` emits after a verify step: the accepted
        draft prefix plus the model's own continuation for speculating
        slots; the row-0 sample otherwise."""
        if self._proposers[slot] is None:
            return [int(sampled0[slot])]
        acc = longest_accepted_prefix(drafts, preds[slot, :len(drafts)].tolist())
        self.spec_stats["spec_steps"] += 1
        self.spec_stats["drafted"] += len(drafts)
        self.spec_stats["accepted"] += acc
        return drafts[:acc] + [int(preds[slot, acc])]

    def _replay_chain(self, slot: int, chain, p0: int, lp, end_hook=None) -> None:
        """Emit an accepted chain token by token: advance the position,
        update the feed, the proposer or the logprobs, and apply the stop
        rules, alike for both batchers. ``end_hook(slot)`` (paged) runs
        before the last token's emission and may return True to end the
        request (its next write position cannot be backed)."""
        for j, tok in enumerate(chain):
            if self.slots[slot] is None:
                break                      # a stop token ended it
            self._pos[slot] = min(p0 + j + 1, self._pos_cap)
            self._feed[slot] = tok
            if self._proposers[slot] is not None:
                self._proposers[slot].extend([tok])
            else:
                self._record_logprobs(slot, tok, lp, row=slot)
            force_finish = bool(end_hook(slot)) if (
                end_hook is not None and j + 1 == len(chain)) else False
            self._emit(slot, tok, int(self._pos[slot]), force_finish=force_finish)

    def _step_speculative(self) -> None:
        """One speculative iteration: every slot's feed token plus up to K
        n-gram drafts verify in one ``[B, K+1]`` forward at per-row
        positions; each greedy slot emits its accepted chain, sampled slots
        their row-0 sample."""
        K = self.speculate_k
        with self._lock:
            self._sweep_cancelled()
            self._admit()
            if not any(r is not None for r in self.slots):
                return
            step_tokens = np.tile(self._feed[:, None], (1, K + 1))
            draft_lists: List[List[int]] = [[] for _ in range(self.n_slots)]
            for slot in range(self.n_slots):
                prop = self._proposers[slot] if self.slots[slot] else None
                if prop is not None and int(self._pos[slot]) + 1 + K < self.seq_len:
                    drafts = prop.propose(K)
                    draft_lists[slot] = drafts
                    step_tokens[slot, 1:1 + len(drafts)] = drafts
            # a free slot's position climbs to the cache's end; its rows are
            # garbage wherever they land, so they land in the last K+1
            positions = np.minimum(self._pos, self.cache.max_seq - K - 1)
            preds, sampled0, lp = self._verify(step_tokens, positions)
            self._deliver_chains(draft_lists, preds, sampled0, lp)

    def _deliver_chains(self, draft_lists, preds, sampled0, lp, end_hook=None) -> None:
        """Emit every slot's tokens after a verify step (``batcher.deliver``);
        a free slot's position climbs by one."""
        with SPANS.span("batcher.deliver", parent=self._step.id):
            for slot in range(self.n_slots):
                p0 = int(self._pos[slot])
                if self.slots[slot] is None:
                    self._pos[slot] = min(p0 + 1, self._pos_cap)
                    continue
                chain = self._accepted_chain(slot, draft_lists[slot], preds, sampled0)
                self._replay_chain(slot, chain, p0, lp, end_hook=end_hook)

    # -------------------------------------------------------- serving glue

    def serve_forever_in_thread(self) -> threading.Thread:
        """Background scheduler thread for the HTTP server: steps whenever
        there is work, sleeps briefly when idle, ends on :meth:`stop` (under
        a mesh with the record that stops the followers)."""

        def loop():
            try:
                while not self._stop.is_set():
                    if self.has_work:
                        self.step()
                    else:
                        time.sleep(0.002)
                if self._lockstep is not None:
                    self._exchange(stop=True)
            except Exception:
                if self._lockstep is None:
                    get_logger().error("batcher thread failed; its requests time out:\n%s",
                                       traceback.format_exc())
                    raise
                # the followers wait for a record or a collective this rank
                # will not send: end every rank (their watch ends them)
                from llama_nuts_and_bolts_tpu_torch.parallel.launch import abort

                abort(f"rank 0's batcher failed:\n{traceback.format_exc()}")

        self._thread = threading.Thread(target=loop, daemon=True, name="batcher")
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        """End the thread of :meth:`serve_forever_in_thread` after its step.
        Under a mesh the followers' :meth:`follow` ends too: rank 0's thread
        sends the stop record as it ends (waited for up to ``STOP_JOIN_S``), or
        without a thread this call sends it; a second call sends nothing."""
        if self._stop.is_set():
            return
        self._stop.set()
        if self._lockstep is None or not self._lockstep.leader:
            return
        if self._thread is not None:
            self._thread.join(STOP_JOIN_S)
        else:
            self._exchange(stop=True)
