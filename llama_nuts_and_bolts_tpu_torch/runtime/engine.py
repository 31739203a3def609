"""Inference engine: bucketed prefill, captured decode steps, streaming.

Port of the plain path of ``llama_nuts_and_bolts_tpu/runtime/engine.py``:
power-of-two prefill buckets (``prefill_chunk`` included), request cache
buckets, the prefix cache, a bf16 or int8 KV cache, greedy/sampled decode in
chunks of ``decode_chunk`` steps and streaming detokenization. Prefill runs
eagerly; decode replays CUDA graphs (``runtime/decode_graph.py``), the
counterparts of the JAX engine's jitted step and chunk scans, kept per
request cache bucket in ``_chunk_fns`` under the same LRU rule.

Speculation and the ``probe`` attention choice are later items of
ROADMAP.md: asking for them raises.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.device import resolve_device
from llama_nuts_and_bolts_tpu_torch.kernels.attention import HEAD_DIM, K1_GROUP
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import K2_GROUP
from llama_nuts_and_bolts_tpu_torch.models.llama.loader import LoadedModel
from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
from llama_nuts_and_bolts_tpu_torch.ops.sampling import sample_token
from llama_nuts_and_bolts_tpu_torch.runtime.decode_graph import DecodeGraph, DecodeSlot
from llama_nuts_and_bolts_tpu_torch.runtime.detokenizer import (
    token_batch_to_string,
    token_to_string,
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
ATTN_CHOICES = ("auto", "plain", "flash", "flash_folded")
KV_CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def prefill_bucket(prompt_len: int, cap: int) -> int:
    b = MIN_PREFILL_BUCKET
    while b < prompt_len:
        b *= 2
    return min(b, cap)


def _check_args(args: InferenceArgs) -> None:
    if args.speculate_k > 0:
        raise NotImplementedError("speculative decoding is a later item of "
                                  "ROADMAP.md (queue 1, speculation)")
    if args.kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype must be one of {tuple(KV_CACHE_DTYPES)}, "
                         f"got {args.kv_cache_dtype!r}")
    if args.attn_impl == "probe":
        raise NotImplementedError("attn_impl='probe' is a later item of "
                                  "ROADMAP.md (queue 1, probe)")
    if args.attn_impl not in ATTN_CHOICES:
        raise ValueError(f"attn_impl must be one of {ATTN_CHOICES}, got "
                         f"{args.attn_impl!r}")


class InferenceEngine:
    def __init__(self, model: LoadedModel, args: Optional[InferenceArgs] = None,
                 log_fn=None, device=None) -> None:
        self.model = model
        self.args = args or InferenceArgs()
        _check_args(self.args)
        self.device = resolve_device(device)
        if model.params.device != self.device:
            raise ValueError(f"model weights are on {model.params.device}, the "
                             f"engine runs on {self.device}")
        self.seq_len = self.args.sequence_length or model.cfg.max_sequence_length
        self.log = log_fn or (lambda fmt, *a: get_logger().debug(fmt, *a))
        self._generator = torch.Generator(device=self.device).manual_seed(self.args.seed)
        # prefix cache: token-tuple -> KVCache snapshot (see cache_prefix)
        self._prefix_cache: Dict[tuple, KVCache] = {}
        # decode graphs (LRU, see _decode_chunk) and the slots they run over,
        # by (rows, cache bucket)
        self._chunk_fns: Dict[tuple, DecodeGraph] = {}
        self._slots: Dict[Tuple[int, int], List[DecodeSlot]] = {}
        self._slots_made = 0
        self._slots_lock = threading.Lock()
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
        bucketing — see cache_bucket)."""
        return KVCache.create(self.model.cfg, batch, max_seq or self.seq_len,
                              device=self.device,
                              dtype=KV_CACHE_DTYPES[self.args.kv_cache_dtype])

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

    def _kernels_viable(self) -> bool:
        """Whether the attention kernels (K1, K2, K4, K6) take this model:
        they are built for head_dim 128 and G = H/KV = 4 only, and raise on
        any other shape, so ``auto`` sends other models to the plain path."""
        cfg = self.model.cfg
        G = cfg.n_heads / cfg.kv_heads
        return cfg.head_dim == HEAD_DIM and G == K1_GROUP and G == K2_GROUP

    def _attn_impl(self, seq_len: int = 1, cache_len: Optional[int] = None) -> str:
        """The attention path of a forward over ``seq_len`` new rows into a
        cache of ``cache_len`` slots. ``auto`` on a card, when the model's
        shape fits the kernels (:meth:`_kernels_viable`): a bf16 cache takes
        the kernels for every prefill (K1) and decode step (K2) at every
        bucket; an int8 cache, as in the JAX package, takes them only to
        decode (K4) and only when ``cache_len`` is a multiple of 128 (the
        kernel's tiles must divide it), and prefills on the plain path. A forced ``flash`` or
        ``flash_folded`` runs the kernels where they can run: an int8 cache
        prefills on the plain path, a bf16 one on K1 (the JAX engine hands
        ``flash_folded`` to its prefill, which refuses it)."""
        forced = self.args.attn_impl
        int8 = self.args.kv_cache_dtype == "int8"
        if forced != "auto":
            if forced.startswith("flash") and seq_len > 1:
                return "plain" if int8 else "flash"
            return forced
        if not (self.device.type == "cuda" and self._kernels_viable()):
            return "plain"
        if int8:
            bucket = cache_len or self.seq_len
            return "flash" if seq_len == 1 and bucket % 128 == 0 else "plain"
        return "flash"

    def _forward(self, tokens: List[List[int]], start_pos: int, cache: KVCache,
                 logits_at: Optional[int] = None):
        tok = torch.tensor(tokens, dtype=torch.int32, device=self.device)
        return forward(self.model.params, self.model.cfg, tok, start_pos, cache,
                       attn_impl=self._attn_impl(tok.shape[1], cache.max_seq),
                       logits_at=logits_at)

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

    def _run_prefill(self, tokens: Sequence[int], cache: KVCache,
                     start_pos: int) -> Tuple[torch.Tensor, KVCache]:
        """Bucketed-padded prefill of ``tokens`` at ``start_pos``. With
        ``args.prefill_chunk=C`` and more than C tokens, all but the tail run
        in exact C-token chunks first; only the tail is bucketed."""
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
        return self._forward([padded], start_pos, cache, logits_at=n - 1)

    def _prefill(self, prompt_tokens: Sequence[int], cache_len: Optional[int] = None,
                 cache: Optional[KVCache] = None) -> Tuple[torch.Tensor, KVCache]:
        """Bucketed-padded prefill; returns logits at the last prompt row.
        Reuses the longest cached prefix snapshot when one matches. The
        prefill writes into ``cache`` when one is given (a decode slot's),
        else into a new ``cache_len`` buffer."""
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
            return self._run_prefill(suffix, cache, plen)
        self.log("Running prefill: prompt_len=%d", prompt_len)
        return self._run_prefill(list(prompt_tokens),
                                 cache or self.new_cache(1, cache_len), 0)

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
        if key in self._chunk_fns:
            self._chunk_fns[key] = self._chunk_fns.pop(key)
            return self._chunk_fns[key]
        while len(self._chunk_fns) >= self.MAX_CHUNK_EXECUTABLES:
            victim = next((c for c in self._chunk_fns if "s" in c),
                          next(iter(self._chunk_fns)))
            self._chunk_fns.pop(victim)
        self._chunk_fns[key] = DecodeGraph(self, slot, k, sampled=sampled, stops=stops)
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
        buffer to a bucket (cache_bucket)."""
        if max_new_tokens is not None and max_new_tokens <= 0:
            return
        cache_len = self.cache_bucket(len(prompt_tokens), max_new_tokens)
        yield from self._generate_tokens_plain(prompt_tokens, cache_len,
                                               max_new_tokens)

    def _generate_tokens_plain(
        self, prompt_tokens: Sequence[int], cache_len: int,
        max_new_tokens: Optional[int] = None,
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
            logits, _ = self._prefill(prompt_tokens, cache_len, cache=slot.cache)
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
                        slot.set([next_token], [cur_pos])
                        rng = gen.get_state() if sampled else None
                        chunk.replay()
                        pending = (chunk.fetch(), rng)
                    run, rng_before = pending
                    pending = None
                    # queue the next chunk before reading this one, when the
                    # next iteration takes the chunked branch
                    if cur_pos + 2 * chunk_k < horizon:
                        rng = gen.get_state() if sampled else None
                        chunk.replay()
                        pending = (chunk.fetch(), rng)
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
                slot.set([next_token], [cur_pos])
                step.replay()
                next_token = step.tokens(step.fetch())[0][0]
                cur_pos += 1

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
