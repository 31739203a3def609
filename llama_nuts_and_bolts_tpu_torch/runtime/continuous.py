"""Continuous batching: requests join and leave a shared decode loop.

Port of ``llama_nuts_and_bolts_tpu/runtime/continuous.py`` (without
speculation, ROADMAP item 12). B cache SLOTS advance through one batched
decode step per iteration, each row at its own position (``forward``'s
``[B]`` ``start_pos``), so a request admitted mid-flight shares the step's
weight reads with the requests already decoding.

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
  * Pipelining: PyTorch queues a step's kernels and returns, so up to
    ``PIPELINE_DEPTH`` quanta stay in flight; each feeds the previous step's
    sampled tokens on the device, and the host reads a quantum's tokens back
    (the only synchronisation) while the next ones run. Positions are the
    host's: they advance when a step is dispatched, so a step never waits
    for a read-back. Occupancy changes never flush: every entry carries a
    slots snapshot, and delivery drops rows whose slot changed hands.
  * ``step_quantum`` k runs k decode steps back to back per iteration; with
    k > 1 admission and stops act every k tokens; the default is 1. The
    steps run eagerly: a captured batched step needs the block tables and
    slot positions in static buffers and a per-row generator drawn on the
    device (ROADMAP queue 1), where the sequential engine's decode replays
    graphs (``runtime/decode_graph.py``).
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
from llama_nuts_and_bolts_tpu_torch.ops.sampling import (
    sample_tokens_batched,
    top_logprobs_batched,
)
from llama_nuts_and_bolts_tpu_torch.runtime.types import GenerationState
from llama_nuts_and_bolts_tpu_torch.utils.logging import get_logger

LOGPROBS_K = 5   # OpenAI caps top_logprobs at 5 for completions


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

    def cancel(self) -> None:
        """Stop generating for this request: its slot (and blocks) are
        released at the scheduler's next step, which also delivers a terminal
        CANCELLED sentinel so a consumer blocked in ``tokens()`` ends. Safe
        from any thread, at any time (a no-op after completion)."""
        self.cancelled = True

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


class ContinuousBatcher:
    """Slot-based continuous batching over one ``InferenceEngine``'s model
    and a dense ``[L, n_slots, KV, seq_len, D]`` cache.

    ``step()`` admits waiting requests into free slots (one prefill each),
    then dispatches one quantum of batched decode steps for every slot."""

    PIPELINE_DEPTH = 2

    def __init__(self, engine, n_slots: int = 8, speculate_k: int = 0,
                 step_quantum: Optional[int] = None):
        self._init_common(engine, n_slots, speculate_k, step_quantum)
        self.cache = engine.new_cache(n_slots)
        # the engine's rule for a decode step into this cache: K2 on a card
        # (K4 for an int8 cache whose length is a multiple of 128), which
        # takes the [n_slots] positions
        self._decode_impl = engine._attn_impl(1, self.cache.max_seq)
        self._pos_cap = self.cache.max_seq - 1

    def _init_common(self, engine, n_slots: int, speculate_k: int,
                     step_quantum: Optional[int]) -> None:
        if speculate_k:
            raise NotImplementedError("speculative batching is ROADMAP item 12 "
                                      "(speculation), not ported yet")
        self.engine = engine
        self.cfg = engine.model.cfg
        self.vocab = engine.model.vocab
        self.device = engine.device
        self.n_slots = n_slots
        self.seq_len = engine.seq_len
        self.step_quantum = max(1, int(step_quantum or 1))
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.decode_steps = 0           # batched decode steps dispatched
        # per-slot feed token and the position it is written at
        self._feed = np.zeros(n_slots, dtype=np.int32)
        self._pos = np.zeros(n_slots, dtype=np.int32)
        self._init_sampling_state(n_slots)
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self._lock = threading.Lock()
        # work in flight, oldest first:
        #   ("q", tokens [k, B], logprob info, force, epos, slots snapshot)
        #   ("admit", slot, req, first token, logprob info, position)
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
                      seed=seed, want_logprobs=logprobs)
        self.pending.put(req)
        return req

    @property
    def has_work(self) -> bool:
        return any(r is not None for r in self.slots) or not self.pending.empty()

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

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slots[slot] is not None:
                continue
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                return
            if req.cancelled:
                req.out.put((GenerationState.CANCELLED, -1))
                continue
            self._set_sampling(slot, req)
            first, lp = self._prefill_slot(slot, req)
            self._occupy(slot, req, first, lp)

    def _prefill_slot(self, slot: int, req: Request):
        """Prefill ``req`` into slot ``slot``'s rows of the shared cache (a
        view, written in place); returns its first token and logprob info,
        on the device."""
        from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

        plen = len(req.prompt)
        padded = torch.zeros((1, prefill_bucket(plen, self.seq_len)), dtype=torch.int32)
        padded[0, :plen] = torch.tensor(req.prompt, dtype=torch.int32)
        c = self.cache
        rows = slice(slot, slot + 1)
        view = KVCache(k=c.k[:, rows], v=c.v[:, rows],
                       k_scale=None if c.k_scale is None else c.k_scale[:, rows],
                       v_scale=None if c.v_scale is None else c.v_scale[:, rows])
        logits, _ = forward(self.engine.model.params, self.cfg, padded.to(self.device),
                            0, view, logits_at=plen - 1)
        return self._sample(logits[:, 0], [slot], [plen - 1])

    def _occupy(self, slot: int, req: Request, first, lp) -> None:
        """Seat an admitted request. Its first token stays on the device: the
        next dispatch feeds it, and its delivery rides the in-flight queue,
        so admission never waits for the prefill."""
        plen = len(req.prompt)
        req.slot = slot
        self.slots[slot] = req
        self._pos[slot] = plen
        self._splice[slot] = True
        self._first_dev[slot] = first[0]
        self._inflight.append(("admit", slot, req, first[0], lp, plen))

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
        req.out.put((state, tok))
        if state != GenerationState.IN_PROGRESS:
            self._release_slot(slot)

    def _release_slot(self, slot: int) -> None:
        """Free the slot; it keeps stepping with a pad token (see the module
        docstring)."""
        self.slots[slot] = None
        self._feed[slot] = 0
        self._clear_sampling(slot)

    def _sweep_cancelled(self) -> None:
        for slot, r in enumerate(self.slots):
            if r is not None and r.cancelled:
                self._release_slot(slot)
                # after the release, in-flight rows of this slot are dropped,
                # so the sentinel is the queue's last entry
                r.out.put((GenerationState.CANCELLED, -1))

    @staticmethod
    def _host_lp(lp, wanted: bool):
        return tuple(t.cpu().numpy() for t in lp) if wanted else None

    def _process_entry(self, entry) -> None:
        if entry[0] == "admit":
            _tag, slot, req, first, lp, pos = entry
            if self.slots[slot] is not req:      # cancelled before its first token
                return
            tok = int(first)
            self._feed[slot] = tok
            if req.want_logprobs:
                self._record_logprobs(slot, tok, self._host_lp(lp, True))
            self._emit(slot, tok, pos)
            return
        _tag, toks, lp, force, epos, snapshot = entry
        toks = toks.cpu().numpy()
        lp = self._host_lp(lp, any(r is not None and r.want_logprobs for r in snapshot))
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

    def _step_logits(self, toks: torch.Tensor, positions: torch.Tensor,
                     quantum_state) -> torch.Tensor:
        """One batched decode step: ``[B, vocab]`` fp32 logits."""
        logits, _ = forward(self.engine.model.params, self.cfg, toks, positions,
                            self.cache, attn_impl=self._decode_impl)
        return logits[:, -1]

    def _quantum_state(self):
        """Per-quantum device inputs besides tokens and positions (the paged
        batcher's block tables)."""
        return None

    def _feed_tokens(self) -> torch.Tensor:
        """The next step's ``[B, 1]`` feed: the last step's tokens on the
        device, with just-admitted rows' first tokens spliced in."""
        if self._last_tok is None:
            toks = torch.from_numpy(self._feed[:, None].copy()).to(self.device)
        else:
            toks = self._last_tok.clone()
        for slot in np.nonzero(self._splice)[0]:
            fd = self._first_dev[slot]
            toks[slot, 0] = fd if fd is not None else int(self._feed[slot])
            self._first_dev[slot] = None
        self._splice[:] = False
        return toks

    def _dispatch(self) -> None:
        """Queue one quantum of ``step_quantum`` decode steps; nothing waits
        for the device."""
        k = self.step_quantum
        toks = self._feed_tokens()
        fed, epos, force = self._advance_quantum(k)
        state = self._quantum_state()        # after the quantum's block growth
        rows = list(range(self.n_slots))
        out_toks, out_lp = [], []
        for j in range(k):
            positions = torch.from_numpy(fed[j].copy()).to(self.device)
            tok, lp = self._sample(self._step_logits(toks, positions, state), rows, fed[j])
            out_toks.append(tok)
            out_lp.append(lp)
            toks = tok[:, None]
        self.decode_steps += k
        self._last_tok = toks
        lp = tuple(torch.stack(parts) for parts in zip(*out_lp))
        self._inflight.append(("q", torch.stack(out_toks), lp, force, epos,
                               list(self.slots)))

    def step(self) -> None:
        """Admit, then dispatch one quantum while up to ``PIPELINE_DEPTH``
        earlier quanta are still in flight; deliver the oldest beyond that,
        and every admission's first token (its prefill is queued before the
        quantum, so this waits at most for the prefill)."""
        with self._lock:
            self._sweep_cancelled()
            self._admit()
            if not any(r is not None for r in self.slots):
                self._flush_inflight()
                return
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

    # -------------------------------------------------------- serving glue

    def serve_forever_in_thread(self) -> threading.Thread:
        """Background scheduler thread for the HTTP server: steps whenever
        there is work, sleeps briefly when idle, ends on :meth:`stop`."""

        def loop():
            try:
                while not self._stop.is_set():
                    if self.has_work:
                        self.step()
                    else:
                        time.sleep(0.002)
            except Exception:
                get_logger().error("batcher thread failed; its requests time out:\n%s",
                                   traceback.format_exc())
                raise

        t = threading.Thread(target=loop, daemon=True, name="batcher")
        t.start()
        return t

    def stop(self) -> None:
        """End the thread of :meth:`serve_forever_in_thread` after its step."""
        self._stop.set()
