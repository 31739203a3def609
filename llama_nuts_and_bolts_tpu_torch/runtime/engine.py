"""Inference engine: bucketed prefill, captured decode steps, streaming.

Port of ``llama_nuts_and_bolts_tpu/runtime/engine.py``: power-of-two prefill
buckets (``prefill_chunk`` included), request cache buckets, the prefix
cache, a bf16 or int8 KV cache, greedy/sampled decode in chunks of
``decode_chunk`` steps, greedy speculative decoding (``speculate_k``, with
an n-gram or a draft-model proposer) and streaming detokenization. Prefill
runs eagerly; decode and the speculative verify step replay CUDA graphs
(``runtime/decode_graph.py``), the counterparts of the JAX engine's jitted
steps and chunk scans, kept per request cache bucket in ``_chunk_fns`` under
the same LRU rule.

``attn_impl="probe"`` measures the decode step's attention paths once per
cache bucket (:meth:`InferenceEngine.autotune_attn_impl`) and decodes that
bucket on the fastest; prefill keeps the ``auto`` rules.

``mesh`` (``parallel.make_mesh``) runs tensor parallelism: the model holds
this rank's shards, every cache the engine makes holds its KV heads, and
every forward (prefill, prefix-cache suffix, decode and verify graphs, the
probe's graphs) runs on the mesh. Every rank runs the same engine calls in
lockstep: the logits are all-gathered, so every rank picks the same tokens
(sampled ones from identically seeded generators), buckets and graphs; under
``probe`` the mesh's first rank's choice is every rank's. On a card the
group must be NCCL (gloo's collectives cannot be captured into the decode
graphs). The draft model is not sharded, as in the JAX package: each rank
runs all of it.

The mesh's other axes replicate the engine, as the JAX engine's calls
(which pass unsharded tokens) leave them: every sp rank runs the same whole
calls, whose graphs hold only the tp group's collectives, and gives the
tokens of the engine without a mesh. Under dp every rank keeps every row of
a cache (the batchers' step records need every row's token on every rank);
a cache whose rows dp does not divide is refused (:meth:`new_cache`), where
the JAX engine's ``shard_cache`` fails: so the sequential requests, a row
each, are refused under dp > 1, and the batchers, whose slots dp divides,
run as the JAX batchers do.

Spans (``runtime/profiling.py``'s ``SPANS``), each naming as its parent an
id the call draws: ``engine.prefill`` (the prefill and the first token's
read, with ``prompt``, ``reused`` rows from the prefix cache and the
bucket's ``padded`` rows), and per decode replay ``engine.decode.launch`` (set,
replay, fetch; ``steps``) and ``engine.decode.wait`` (the host waits for the
tokens); a graph's capture is ``engine.graph_capture``
(``runtime/decode_graph.py``). ``graphs_built`` and ``graph_evictions``
count the decode graphs made and dropped (the server's ``/metrics``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.device import resolve_device
from llama_nuts_and_bolts_tpu_torch.kernels.attention import HEAD_DIM, K1_GROUP
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import K2_GROUP
from llama_nuts_and_bolts_tpu_torch.models.llama.loader import LoadedModel
from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
from llama_nuts_and_bolts_tpu_torch.ops.sampling import greedy, sample_token
from llama_nuts_and_bolts_tpu_torch.parallel.mesh import (
    broadcast_choice,
    dp_size,
    tp_backend,
    tp_size,
)
from llama_nuts_and_bolts_tpu_torch.parallel.sharding import check_tp_shape
from llama_nuts_and_bolts_tpu_torch.runtime.decode_graph import (
    DecodeGraph,
    DecodeSlot,
    VerifyGraph,
)
from llama_nuts_and_bolts_tpu_torch.runtime.detokenizer import (
    token_batch_to_string,
    token_to_string,
)
from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
from llama_nuts_and_bolts_tpu_torch.runtime.speculative import (
    DraftModelProposer,
    NgramProposer,
    longest_accepted_prefix,
)
from llama_nuts_and_bolts_tpu_torch.runtime.types import (
    DecodingContext,
    GeneratedPart,
    GenerationState,
    InferenceArgs,
)
from llama_nuts_and_bolts_tpu_torch.tokenizer import (
    PromptPart,
    encode_ordinary,
    render_chat_tokens,
)
from llama_nuts_and_bolts_tpu_torch.utils.logging import get_logger

MIN_PREFILL_BUCKET = 16
ATTN_CHOICES = ("auto", "plain", "flash", "flash_folded", "probe")
KV_CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def prefill_bucket(prompt_len: int, cap: int) -> int:
    b = MIN_PREFILL_BUCKET
    while b < prompt_len:
        b *= 2
    return min(b, cap)


def _check_args(args: InferenceArgs) -> None:
    if args.kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype must be one of {tuple(KV_CACHE_DTYPES)}, "
                         f"got {args.kv_cache_dtype!r}")
    if args.attn_impl not in ATTN_CHOICES:
        raise ValueError(f"attn_impl must be one of {ATTN_CHOICES}, got "
                         f"{args.attn_impl!r}")


class InferenceEngine:
    def __init__(self, model: LoadedModel, args: Optional[InferenceArgs] = None,
                 log_fn=None, draft_model: Optional[LoadedModel] = None,
                 device=None, mesh=None) -> None:
        self.model = model
        self.args = args or InferenceArgs()
        _check_args(self.args)
        self.device = resolve_device(device)
        # tensor parallelism: the model holds this rank's shards
        self.mesh = mesh
        self.tp = tp_size(mesh)
        if mesh is not None:
            self._check_mesh()
        for what, m in (("model", model), ("draft model", draft_model)):
            if m is not None and m.params.device != self.device:
                raise ValueError(f"{what} weights are on {m.params.device}, the "
                                 f"engine runs on {self.device}")
        # optional smaller Llama used as the speculation proposer (two-model
        # speculative decoding); None falls back to n-gram prompt lookup
        if (draft_model is not None
                and draft_model.cfg.vocab_size < model.cfg.vocab_size):
            raise ValueError(
                f"draft model vocab ({draft_model.cfg.vocab_size}) is smaller "
                f"than the target's ({model.cfg.vocab_size}): target token ids "
                "would be clipped by the draft embedding lookup")
        self.draft_model = draft_model
        self.seq_len = self.args.sequence_length or model.cfg.max_sequence_length
        self.log = log_fn or (lambda fmt, *a: get_logger().debug(fmt, *a))
        self._generator = torch.Generator(device=self.device).manual_seed(self.args.seed)
        # prefix cache: token-tuple -> KVCache snapshot (see cache_prefix)
        self._prefix_cache: Dict[tuple, KVCache] = {}
        # decode graphs (LRU, see _decode_chunk) and the slots they run over,
        # by (rows, cache bucket)
        self._chunk_fns: Dict[tuple, DecodeGraph] = {}
        self.graphs_built = 0
        self.graph_evictions = 0
        self._slots: Dict[Tuple[int, int], List[DecodeSlot]] = {}
        self._slots_made = 0
        self._slots_lock = threading.Lock()
        # attn_impl="probe": the measured decode path per cache bucket, and
        # the last probe's seconds per candidate
        self._probed_decode_impl: Dict[int, str] = {}
        self._probe_timings: Dict[str, float] = {}
        if self.args.attn_impl.startswith("flash") and not self._kernels_viable():
            raise ValueError(
                f"attn_impl={self.args.attn_impl!r} needs head_dim {HEAD_DIM} and G = "
                f"H/KV = {K1_GROUP} (the kernels' shape); this model has head_dim "
                f"{model.cfg.head_dim} and G = {model.cfg.n_heads / model.cfg.kv_heads:g}")

    # ------------------------------------------------------------ tokenize

    def tokenize(self, prompt_parts: Sequence[PromptPart]) -> List[int]:
        ids = render_chat_tokens(prompt_parts, self.model.vocab, self.model.mergeable_ranks)
        self.log("Prompt token ids: %s", ids)
        return ids

    def tokenize_string(self, text: str) -> List[int]:
        return encode_ordinary(text, self.model.mergeable_ranks)

    def token_to_string(self, token_id: int, ctx: DecodingContext):
        return token_to_string(self.model.vocab, token_id, ctx)

    def token_batch_to_string(self, token_ids) -> Tuple[list, str]:
        return token_batch_to_string(self.model.vocab, token_ids)

    def new_cache(self, batch: int = 1, max_seq: Optional[int] = None) -> KVCache:
        """Fresh KV cache of ``args.kv_cache_dtype`` (bf16 | int8);
        ``max_seq`` bounds the buffer below the engine context (request
        bucketing — see cache_bucket). Under a mesh its rows must divide
        over dp (see the module docstring)."""
        dp = dp_size(self.mesh)
        if batch % dp:
            raise ValueError(f"a cache of {batch} rows does not divide over dp={dp}: "
                             "the sequential engine serves one row, so a dp mesh runs "
                             "only the batchers (their slots a multiple of dp)")
        return KVCache.create(self.model.cfg, batch, max_seq or self.seq_len,
                              device=self.device,
                              dtype=KV_CACHE_DTYPES[self.args.kv_cache_dtype], tp=self.tp)

    def cache_bucket(self, prompt_len: int, max_new_tokens: Optional[int]) -> int:
        """Cache-buffer length for a request: the smallest power of two from
        256 holding ``prompt + max_new`` (capped at the engine context)."""
        if max_new_tokens is None:
            return self.seq_len
        need = prompt_len + max_new_tokens + 2
        b = 256
        while b < need:
            b *= 2
        return min(b, self.seq_len)

    def _check_mesh(self) -> None:
        """Refuse a mesh the engine cannot run: a shard must keep whole GQA
        groups, and a card's collectives must be capturable (NCCL)."""
        check_tp_shape(self.model.cfg, self.tp)
        backend = tp_backend(self.mesh)
        if self.device.type == "cuda" and backend != "nccl":
            raise ValueError(f"a {backend} group on {self.device}: its collectives "
                             "cannot be captured into the decode graphs; use NCCL")
        if self.device.type == "cpu" and backend == "nccl":
            raise ValueError("an NCCL group with an engine on the CPU: use gloo")

    def _kernels_viable(self) -> bool:
        """Whether the attention kernels (K1, K2, K4, K6) take this model:
        they are built for head_dim 128 and G = H/KV = 4 only, and raise on
        any other shape, so ``auto`` sends other models to the plain path.
        Under a mesh (whose tp divides the KV heads: :meth:`_check_mesh`)
        the local group ``(H/tp) / (KV/tp)`` is the kernels'."""
        cfg = self.model.cfg
        G = (cfg.n_heads // self.tp) / (cfg.kv_heads // self.tp)
        return cfg.head_dim == HEAD_DIM and G == K1_GROUP and G == K2_GROUP

    def _attn_impl(self, seq_len: int = 1, cache_len: Optional[int] = None) -> str:
        """The attention path of a forward over ``seq_len`` new rows into a
        cache of ``cache_len`` slots. Under ``probe`` a decode step (S = 1)
        takes the path measured fastest for its bucket (the first such step
        of a bucket runs the probe, :meth:`autotune_attn_impl`); anything
        else takes :meth:`_auto_attn_impl`."""
        if self.args.attn_impl == "probe" and seq_len == 1:
            bucket = cache_len or self.seq_len
            if bucket not in self._probed_decode_impl:
                self.autotune_attn_impl(cache_len=bucket)
            return self._probed_decode_impl[bucket]
        return self._auto_attn_impl(seq_len, cache_len)

    def _auto_attn_impl(self, seq_len: int = 1, cache_len: Optional[int] = None) -> str:
        """The build-time rules; ``probe`` reads as ``auto``. ``auto`` on a
        card, when the model's shape fits the kernels
        (:meth:`_kernels_viable`): a bf16 cache takes the kernels for every
        prefill (K1) and decode step (K2) at every bucket; an int8 cache, as
        in the JAX package, takes them only to decode (K4) and only when
        ``cache_len`` is a multiple of 128 (the kernel's tiles must divide
        it), and prefills on the plain path. A forced ``flash`` or
        ``flash_folded`` runs the kernels where they can run: an int8 cache
        prefills on the plain path, a bf16 one on K1 (the JAX engine hands
        ``flash_folded`` to its prefill, which refuses it)."""
        forced = self.args.attn_impl
        int8 = self.args.kv_cache_dtype == "int8"
        if forced not in ("auto", "probe"):
            if forced.startswith("flash") and seq_len > 1:
                return "plain" if int8 else "flash"
            return forced
        if not (self.device.type == "cuda" and self._kernels_viable()):
            return "plain"
        if int8:
            bucket = cache_len or self.seq_len
            return "flash" if seq_len == 1 and bucket % 128 == 0 else "plain"
        return "flash"

    def _decode_candidates(self, cache_len: int) -> List[str]:
        """The decode step's paths ``probe`` measures at ``cache_len``:
        ``plain`` always; ``flash`` (K2, K4 for an int8 cache) on a card
        where the kernels take the model, and for an int8 cache only at a
        multiple of 128 slots (the ``auto`` rule's gate)."""
        out = ["plain"]
        if (self.device.type == "cuda" and self._kernels_viable()
                and (self.args.kv_cache_dtype != "int8" or cache_len % 128 == 0)):
            out.append("flash")
        return out

    def autotune_attn_impl(self, iters: int = 5, cache_len: Optional[int] = None) -> str:
        """One-shot decode-path probe at ``cache_len`` (default: the engine
        context): time one-row decode steps on each candidate
        (:meth:`_decode_candidates`) at position ``(cache_len - 2) // 2``
        and keep the fastest, in ``_probed_decode_impl[cache_len]``
        (returned); ``_probe_timings`` holds each candidate's seconds. Under
        a mesh every rank times its own candidates and takes rank 0's
        choice, so that all ranks capture the same graphs.

        Each candidate's step is a one-step :class:`DecodeGraph` captured
        over a scratch one-row slot of the bucket, as the engine would
        decode it: an eager step spends most of its time in the host's
        launches, and would time the host. Its first replay (the capture,
        with its warm-up step) and a second one warm up; each of ``iters``
        replays is then timed by the host clock up to a synchronisation,
        and the best is kept. The graphs and the slot are dropped after; the
        bucket's own graphs are captured on the chosen path later. Unlike
        the JAX package's probe, a candidate that fails raises: candidates
        are filtered up front, and a kernel fault must not quietly give way
        to the plain path. With one candidate (the CPU) nothing is timed:
        ``{"plain": 0.0}``, as the JAX package's probe does off-TPU."""
        cache_len = cache_len or self.seq_len
        candidates = self._decode_candidates(cache_len)
        if len(candidates) == 1:
            self._probed_decode_impl[cache_len] = candidates[0]
            self._probe_timings = {candidates[0]: 0.0}
            self.log("attn-impl probe: only %r viable at this config", candidates[0])
            return candidates[0]
        # mid-bucket: attention at cache_len / 2 stands for a typical step
        pos = max(1, (cache_len - 2) // 2)
        slot = DecodeSlot(self, 1, cache_len, index=-1)      # not kept in _slots
        timings: Dict[str, float] = {}
        for impl in candidates:
            graph = DecodeGraph(self, slot, 1, impl=impl)
            best = float("inf")
            for i in range(2 + iters):
                slot.set([0], [pos])
                t0 = time.perf_counter()
                graph.replay()
                if slot.device.type == "cuda":
                    torch.cuda.synchronize(slot.device)
                if i >= 2:
                    best = min(best, time.perf_counter() - t0)
            timings[impl] = best
        choice = min(timings, key=timings.get)
        if self.mesh is not None:
            choice = candidates[broadcast_choice(candidates.index(choice), self.mesh,
                                                 self.device)]
        self._probed_decode_impl[cache_len] = choice
        self._probe_timings = timings
        self.log("attn-impl probe at cache_len=%d kv=%s: %s -> chose %r",
                 cache_len, self.args.kv_cache_dtype,
                 {k: f"{v * 1e3:.3f}ms" for k, v in timings.items()}, choice)
        return choice

    def _forward(self, tokens: List[List[int]], start_pos: int, cache: KVCache,
                 logits_at: Optional[int] = None):
        tok = torch.tensor(tokens, dtype=torch.int32, device=self.device)
        return forward(self.model.params, self.model.cfg, tok, start_pos, cache,
                       attn_impl=self._attn_impl(tok.shape[1], cache.max_seq),
                       logits_at=logits_at, mesh=self.mesh)

    def _select_token(self, logits_row: torch.Tensor) -> int:
        return int(sample_token(logits_row, self._generator, self.args.temperature,
                                self.args.top_k, self.args.top_p))

    # ------------------------------------------------------- prefix caching

    MAX_CACHED_PREFIXES = 4
    # decode graphs kept (LRU, sampled evicted first): greedy needs one per
    # (chunk size, cache bucket), and sampled adds one per distinct
    # (top_k, top_p)
    MAX_CHUNK_EXECUTABLES = 16

    def cache_prefix(self, prefix_tokens: Sequence[int]) -> None:
        """Prefill ``prefix_tokens`` once and snapshot the KV state: a later
        prompt that starts with these tokens skips recomputing them. The
        snapshot is copied per use, so it stays unchanged. Keeps at most
        MAX_CACHED_PREFIXES snapshots (FIFO eviction)."""
        prefix = tuple(prefix_tokens)
        if not prefix or len(prefix) >= self.seq_len:
            raise ValueError("prefix must be non-empty and shorter than context")
        if prefix in self._prefix_cache:
            return
        _logits, cache = self._run_prefill(list(prefix), self.new_cache(1), 0)
        while len(self._prefix_cache) >= self.MAX_CACHED_PREFIXES:
            self._prefix_cache.pop(next(iter(self._prefix_cache)))
        self._prefix_cache[prefix] = cache

    def _match_prefix(self, prompt_tokens: Sequence[int]):
        """Longest cached prefix of the prompt (None when nothing matches)."""
        best = None
        for prefix in self._prefix_cache:
            if len(prompt_tokens) >= len(prefix) and (
                    tuple(prompt_tokens[:len(prefix)]) == prefix):
                if best is None or len(prefix) > len(best):
                    best = prefix
        return best

    def _run_prefill(self, tokens: Sequence[int], cache: KVCache, start_pos: int,
                     counts: Optional[Dict[str, int]] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
        """Bucketed-padded prefill of ``tokens`` at ``start_pos``. With
        ``args.prefill_chunk=C`` and more than C tokens, all but the tail run
        in exact C-token chunks first; only the tail is bucketed. The
        bucket's padding rows go into ``counts["padded"]``."""
        chunk = self.args.prefill_chunk
        if chunk > 0 and len(tokens) > chunk:
            done = 0
            while len(tokens) - done > chunk:
                _, cache = self._forward([list(tokens[done:done + chunk])],
                                         start_pos + done, cache,
                                         logits_at=chunk - 1)
                done += chunk
            tokens = tokens[done:]
            start_pos += done
        n = len(tokens)
        # cap by the cache room left past start_pos, not the whole cache
        cache_room = cache.max_seq
        bucket = prefill_bucket(n, cache_room - start_pos)
        if start_pos + bucket > cache_room or n > bucket:
            raise ValueError("prefill bucket exceeds cache length")
        padded = list(tokens) + [0] * (bucket - n)
        if counts is not None:
            counts["padded"] = bucket - n
        return self._forward([padded], start_pos, cache, logits_at=n - 1)

    def _prefill(self, prompt_tokens: Sequence[int], cache_len: Optional[int] = None,
                 cache: Optional[KVCache] = None,
                 counts: Optional[Dict[str, int]] = None) -> Tuple[torch.Tensor, KVCache]:
        """Bucketed-padded prefill; returns logits at the last prompt row.
        Reuses the longest cached prefix snapshot when one matches. The
        prefill writes into ``cache`` when one is given (a decode slot's),
        else into a new ``cache_len`` buffer. ``counts`` receives the rows
        ``reused`` from a snapshot and the bucket's ``padded`` rows."""
        prompt_len = len(prompt_tokens)
        if prompt_len >= self.seq_len:
            raise ValueError(
                f"context sequence length {self.seq_len} must be higher than "
                f"prompt tokens length {prompt_len}")
        cache_len = cache_len or self.seq_len
        prefix = self._match_prefix(prompt_tokens)
        if prefix is not None:
            plen = len(prefix)
            if plen == prompt_len:
                # prompt == prefix: re-run its last token for the logits row
                plen -= 1
            suffix = list(prompt_tokens[plen:])
            snapshot = self._prefix_cache[prefix]
            cache = (snapshot.truncated(cache_len) if cache is None
                     else cache.load_(snapshot))
            self.log("Prefix cache hit: %d of %d prompt tokens reused",
                     plen, prompt_len)
            if counts is not None:
                counts["reused"] = plen
            return self._run_prefill(suffix, cache, plen, counts)
        self.log("Running prefill: prompt_len=%d", prompt_len)
        return self._run_prefill(list(prompt_tokens),
                                 cache or self.new_cache(1, cache_len), 0, counts)

    # ------------------------------------------------------------- decode

    def _decode_chunk_size(self) -> int:
        """Resolve ``args.decode_chunk``: 0 is auto, which is 1 on a card.
        The JAX engine's auto takes 8 only on an RPC-attached device, where
        each dispatch costs a network round trip; a card is host-attached,
        and its step replays as one graph at k = 1 too."""
        return max(1, self.args.decode_chunk)

    @contextlib.contextmanager
    def _lease(self, batch: int, cache_len: int):
        """A decode slot of ``batch`` rows over a ``cache_len`` cache, for
        one request at a time: a second live request on the same bucket
        gets a slot (and graphs) of its own."""
        with self._slots_lock:
            slot = next((s for s in self._slots.get((batch, cache_len), ())
                         if not s.leased), None) or self._new_slot(batch, cache_len)
            slot.leased = True
        try:
            yield slot
        finally:
            slot.leased = False

    def _new_slot(self, batch: int, cache_len: int) -> DecodeSlot:
        slot = DecodeSlot(self, batch, cache_len, self._slots_made)
        self._slots_made += 1
        self._slots.setdefault((batch, cache_len), []).append(slot)
        return slot

    def _decode_chunk(self, k: int, sampled: bool = False,
                      cache_len: Optional[int] = None,
                      slot: Optional[DecodeSlot] = None,
                      stops: bool = False) -> DecodeGraph:
        """The graph of k decode steps over ``slot`` (default: the first
        one-row slot of the bucket), greedy, sampled with this engine's
        top_k/top_p (the temperature is the slot's, so one graph serves any),
        or greedy with stop tracking. Keyed as the JAX engine keys its chunk
        executables, ``(k, bucket, "g" | "b" | ("s", top_k, top_p))``, and by
        the slot. At most MAX_CHUNK_EXECUTABLES are kept, refreshed on use;
        a sampled entry is evicted first (client-controlled top_k/top_p must
        not push out the greedy graphs), and a slot that no graph and no
        request holds any more goes with its cache."""
        bucket = cache_len or self.seq_len
        if slot is None:
            slot = next(iter(self._slots.get((1, bucket), ())), None) or \
                self._new_slot(1, bucket)
        key = ((k, bucket, "s", self.args.top_k, self.args.top_p) if sampled
               else (k, bucket, "b" if stops else "g")) + (slot.index,)
        return self._graph(key, lambda: DecodeGraph(self, slot, k, sampled=sampled,
                                                    stops=stops))

    def _verify_graph(self, k: int, slot: DecodeSlot) -> VerifyGraph:
        """The speculative verify step of ``k`` drafts over the one-row
        ``slot``, kept with the decode graphs as ``("verify", k, bucket,
        slot)``."""
        return self._graph(("verify", k, slot.cache_len, slot.index),
                           lambda: VerifyGraph(self, slot, k))

    def _graph(self, key: tuple, make):
        """The graph under ``key`` in the LRU of MAX_CHUNK_EXECUTABLES, made
        by ``make()`` when absent (see :meth:`_decode_chunk`)."""
        if key in self._chunk_fns:
            self._chunk_fns[key] = self._chunk_fns.pop(key)
            return self._chunk_fns[key]
        while len(self._chunk_fns) >= self.MAX_CHUNK_EXECUTABLES:
            victim = next((c for c in self._chunk_fns if "s" in c),
                          next(iter(self._chunk_fns)))
            self._chunk_fns.pop(victim)
            self.graph_evictions += 1
        self._chunk_fns[key] = make()
        self.graphs_built += 1
        held = {g.slot for g in self._chunk_fns.values()}
        with self._slots_lock:
            for slots in self._slots.values():
                slots[:] = [s for s in slots if s.leased or s in held]
        return self._chunk_fns[key]

    def generate_tokens(
        self, prompt_tokens: Sequence[int],
        max_new_tokens: Optional[int] = None,
    ) -> Iterator[Tuple[GenerationState, int]]:
        """Greedy/sampled autoregressive generation, one token per yield.
        ``max_new_tokens`` caps the stream and sizes the request's cache
        buffer to a bucket (cache_bucket). Greedy requests with
        ``speculate_k`` > 0 take the speculative path, which keeps the
        full-context cache; sampled ones ignore it."""
        if max_new_tokens is not None and max_new_tokens <= 0:
            return
        rid = SPANS.new_id()            # the parent of the call's spans
        if self.args.speculate_k > 0 and self.args.temperature == 0.0:
            it = self._generate_tokens_speculative(prompt_tokens, rid)
            try:
                n = 0
                for state, tok in it:
                    n += 1
                    yield state, tok
                    if (max_new_tokens is not None and n >= max_new_tokens
                            or state != GenerationState.IN_PROGRESS):
                        return
            finally:
                it.close()                 # releases its slot at once
            return
        cache_len = self.cache_bucket(len(prompt_tokens), max_new_tokens)
        yield from self._generate_tokens_plain(prompt_tokens, cache_len,
                                               max_new_tokens, rid)

    def _generate_tokens_plain(
        self, prompt_tokens: Sequence[int], cache_len: int,
        max_new_tokens: Optional[int] = None, rid: Optional[int] = None,
    ) -> Iterator[Tuple[GenerationState, int]]:
        """Prefill into a leased decode slot, then decode by replaying its
        graphs: k-step chunks while a whole chunk fits below the horizon,
        one-step graphs after. As in the JAX engine, one chunk stays in
        flight: the next chunk is queued (its feed is this chunk's last
        token, already on the device) before this one's tokens are read, and
        a stop abandons it (its cache writes are never read). A sampled run
        that ends mid-chunk sets the generator where per-token decoding
        would have left it."""
        vocab = self.model.vocab
        horizon = min(self.seq_len, cache_len)
        cap = max_new_tokens if max_new_tokens is not None else float("inf")
        emitted = 0
        chunk_k = self._decode_chunk_size()
        sampled = self.args.temperature > 0.0
        gen = self._generator
        with self._lease(1, cache_len) as slot:
            with SPANS.span("engine.prefill", parent=rid, prompt=len(prompt_tokens),
                            reused=0) as span:
                logits, _ = self._prefill(prompt_tokens, cache_len, cache=slot.cache,
                                          counts=span.counts)
                next_token = self._select_token(logits[0, 0])
            if sampled:
                slot.temperature.fill_(self.args.temperature)
            step = chunk = None          # made when first needed
            pending = None               # (queued chunk, generator state before it)
            cur_pos = len(prompt_tokens)
            while True:
                if vocab.is_stop(next_token):
                    yield GenerationState.FINISHED_BY_REACHING_EOS, next_token
                    return
                if cur_pos + 1 >= horizon:
                    yield GenerationState.FINISHED_BY_REACHING_SEQ_LEN, next_token
                    return
                yield GenerationState.IN_PROGRESS, next_token
                emitted += 1
                if emitted >= cap:
                    # cap hit at a chunk boundary (or a one-step graph): the
                    # generator is exact
                    return

                if chunk_k > 1 and cur_pos + chunk_k < horizon:
                    chunk = chunk or self._decode_chunk(chunk_k, sampled, cache_len, slot)
                    if pending is None:
                        with SPANS.span("engine.decode.launch", parent=rid, steps=chunk_k):
                            slot.set([next_token], [cur_pos])
                            rng = gen.get_state() if sampled else None
                            chunk.replay()
                            pending = (chunk.fetch(), rng)
                    run, rng_before = pending
                    pending = None
                    # queue the next chunk before reading this one, when the
                    # next iteration takes the chunked branch
                    if cur_pos + 2 * chunk_k < horizon:
                        with SPANS.span("engine.decode.launch", parent=rid, steps=chunk_k):
                            rng = gen.get_state() if sampled else None
                            chunk.replay()
                            pending = (chunk.fetch(), rng)
                    with SPANS.span("engine.decode.wait", parent=rid):
                        chunk_tokens = [row[0] for row in chunk.tokens(run)]
                    cur_pos += 1
                    for i, tok in enumerate(chunk_tokens):
                        next_token = tok
                        if i + 1 == len(chunk_tokens):
                            break        # the loop head handles the last one
                        terminal = None
                        if vocab.is_stop(next_token):
                            terminal = GenerationState.FINISHED_BY_REACHING_EOS
                        elif cur_pos + 1 >= horizon:
                            terminal = GenerationState.FINISHED_BY_REACHING_SEQ_LEN
                        if terminal is not None or emitted + 1 >= cap:
                            if sampled:
                                # the chunk drew k times, per-token decoding i + 1
                                chunk.rewind_rng(rng_before, i + 1)
                            yield (terminal if terminal is not None
                                   else GenerationState.IN_PROGRESS), next_token
                            return
                        yield GenerationState.IN_PROGRESS, next_token
                        emitted += 1
                        cur_pos += 1
                    continue

                step = step or self._decode_chunk(1, sampled, cache_len, slot)
                with SPANS.span("engine.decode.launch", parent=rid, steps=1):
                    slot.set([next_token], [cur_pos])
                    step.replay()
                    fetched = step.fetch()
                with SPANS.span("engine.decode.wait", parent=rid):
                    next_token = step.tokens(fetched)[0][0]
                cur_pos += 1

    def _generate_tokens_speculative(
        self, prompt_tokens: Sequence[int], rid: Optional[int] = None,
    ) -> Iterator[Tuple[GenerationState, int]]:
        """Greedy decode with speculation (n-gram prompt lookup, or the draft
        model when the engine has one), over a leased full-context slot.

        Each step verifies the just-emitted token plus up to ``k`` drafts in
        one replay of the slot's verify graph (S=k+1: the same weight bytes as
        S=1), and reads its k+1 predictions back once; drafts are padded to k
        with the last one. A step with no drafts replays the slot's one-step
        decode graph. Emits exactly the vanilla greedy sequence: a draft is
        emitted only when it equals the model's own argmax. Rejected and
        padded rows write K/V beyond the accepted point; those positions are
        invisible to later queries until the real token there overwrites
        them, since each replay starts at the position the host sets."""
        vocab = self.model.vocab
        k = self.args.speculate_k
        with self._lease(1, self.seq_len) as slot:
            with SPANS.span("engine.prefill", parent=rid, prompt=len(prompt_tokens),
                            reused=0) as span:
                logits, _ = self._prefill(prompt_tokens, self.seq_len, cache=slot.cache,
                                          counts=span.counts)
                queue = [int(greedy(logits[0, 0]))]
            if self.draft_model is not None:
                proposer = DraftModelProposer(self.draft_model, list(prompt_tokens),
                                              self.seq_len)
            else:
                proposer = NgramProposer(list(prompt_tokens))
            self.spec_stats = {"steps": 0, "spec_steps": 0, "drafted": 0, "accepted": 0}
            n_ctx = len(prompt_tokens)
            step = verify = None             # made when first needed
            while True:
                tok = queue.pop(0)
                if vocab.is_stop(tok):
                    yield GenerationState.FINISHED_BY_REACHING_EOS, tok
                    return
                if n_ctx + 1 >= self.seq_len:
                    yield GenerationState.FINISHED_BY_REACHING_SEQ_LEN, tok
                    return
                yield GenerationState.IN_PROGRESS, tok
                proposer.extend([tok])
                n_ctx += 1
                if queue:
                    continue

                start = n_ctx - 1             # the emitted token's position
                self.spec_stats["steps"] += 1
                # drafting needs start + k + 1 <= seq_len: the verify rows fit
                drafts = proposer.propose(k) if n_ctx + k <= self.seq_len else []
                if drafts:
                    real = len(drafts)
                    verify = verify or self._verify_graph(k, slot)
                    verify.set([tok] + drafts + [drafts[-1]] * (k - real), start)
                    verify.replay()
                    preds = verify.tokens(verify.fetch())
                    n_acc = longest_accepted_prefix(drafts, preds[:real])
                    self.spec_stats["spec_steps"] += 1
                    self.spec_stats["drafted"] += real
                    self.spec_stats["accepted"] += n_acc
                    queue.extend(drafts[:n_acc])
                    queue.append(preds[n_acc])
                else:
                    step = step or self._decode_chunk(1, False, self.seq_len, slot)
                    slot.set([tok], [start])
                    step.replay()
                    queue.append(step.tokens(step.fetch())[0][0])

    # ---------------------------------------------------------- streaming

    def generate_string(self, prompt_tokens: Sequence[int],
                        max_new_tokens: Optional[int] = None,
                        ) -> Iterator[GeneratedPart]:
        return self._generate_string(self.generate_tokens(prompt_tokens,
                                                          max_new_tokens))

    def generate_string_from_output_tokens(
        self, output_tokens: Sequence[int]
    ) -> Iterator[GeneratedPart]:
        """Replay a scripted token stream through the decoder."""

        def scripted():
            for tok in output_tokens:
                yield GenerationState.IN_PROGRESS, tok

        return self._generate_string(scripted())

    def _generate_string(self, token_iter) -> Iterator[GeneratedPart]:
        ctx = DecodingContext()
        last_state = GenerationState.IN_PROGRESS

        for state, token_id in token_iter:
            token, token_str, added_to_waiting = self.token_to_string(token_id, ctx)
            self.log('Generated token string: "%s", addedToWaiting: %s',
                     token_str, added_to_waiting)
            part = GeneratedPart(
                token_id=token_id,
                token=token,
                decoded_string=token_str,
                added_to_waiting=added_to_waiting,
                waiting_runes_extra_str=ctx.waiting_runes_extra_str,
                generation_state=GenerationState.IN_PROGRESS,
            )
            if state != GenerationState.IN_PROGRESS and not ctx.waiting_parts:
                part.generation_state = state
            last_state = state
            if added_to_waiting:
                ctx.waiting_parts.append(part)
            else:
                ctx.waiting_parts.clear()
            yield part

        # flush still-waiting byte-fallback parts as literal <0xNN> text
        ctx.decoding_finished = True
        if ctx.waiting_parts:
            for i, waiting in enumerate(ctx.waiting_parts):
                decoded = waiting.token.byte_fallback_string()
                if ctx.waiting_runes_extra_str:
                    decoded = ctx.waiting_runes_extra_str + decoded
                    ctx.waiting_runes = ""
                    ctx.waiting_runes_extra_str = ""
                yield GeneratedPart(
                    token_id=waiting.token_id,
                    token=waiting.token,
                    decoded_string=decoded,
                    added_to_waiting=False,
                    waiting_runes_extra_str="",
                    is_resend_of_waiting=True,
                    generation_state=(last_state if i + 1 == len(ctx.waiting_parts)
                                      else GenerationState.IN_PROGRESS),
                )
