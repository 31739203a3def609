"""Inference engine: bucketed prefill, one decode step per token, streaming.

Port of the plain path of ``llama_nuts_and_bolts_tpu/runtime/engine.py``:
power-of-two prefill buckets (``prefill_chunk`` included), request cache
buckets, the prefix cache, per-token greedy/sampled decode and streaming
detokenization. PyTorch runs eagerly, so there are no executables to cache;
the buckets are kept because they bound the cache each request allocates
and keep the kernels' shapes few.

Speculation, the ``probe`` attention choice, the int8 KV cache and
multi-step decode dispatch (the CUDA-graph counterpart of ``decode_chunk``)
are later items of ROADMAP.md: asking for them raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.device import resolve_device
from llama_nuts_and_bolts_tpu_torch.models.llama.loader import LoadedModel
from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
from llama_nuts_and_bolts_tpu_torch.ops.sampling import sample_token
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
ATTN_CHOICES = ("auto", "plain", "flash")


def prefill_bucket(prompt_len: int, cap: int) -> int:
    b = MIN_PREFILL_BUCKET
    while b < prompt_len:
        b *= 2
    return min(b, cap)


def _check_args(args: InferenceArgs) -> None:
    if args.speculate_k > 0:
        raise NotImplementedError("speculative decoding is a later item of "
                                  "ROADMAP.md (queue 1, speculation)")
    if args.kv_cache_dtype != "bf16":
        raise NotImplementedError("the int8 KV cache is a later item of "
                                  "ROADMAP.md (queue 1, int8 KV cache)")
    if args.attn_impl == "probe":
        raise NotImplementedError("attn_impl='probe' is a later item of "
                                  "ROADMAP.md (queue 1, probe)")
    if args.attn_impl not in ATTN_CHOICES:
        raise ValueError(f"attn_impl must be one of {ATTN_CHOICES}, got "
                         f"{args.attn_impl!r}")
    if args.decode_chunk > 1:
        raise NotImplementedError("multi-step decode dispatch is a later item "
                                  "of ROADMAP.md (queue 1, decode CUDA graph)")


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
        if self.args.attn_impl == "flash" and not self._kernels_viable():
            raise ValueError(
                f"attn_impl='flash' needs head_dim % 128 == 0 (the kernels' "
                f"width); this model has head_dim {model.cfg.head_dim}")

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
        """Fresh bf16 KV cache; ``max_seq`` bounds the buffer below the
        engine context (request bucketing — see cache_bucket)."""
        return KVCache.create(self.model.cfg, batch, max_seq or self.seq_len,
                              device=self.device)

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
        return self.model.cfg.head_dim % 128 == 0

    def _attn_impl(self) -> str:
        """``auto`` takes the CUDA kernels on a card (K1 for every prefill,
        K2 for every decode step, at every cache bucket) when the model's
        head_dim fits them, and the plain path otherwise."""
        if self.args.attn_impl != "auto":
            return self.args.attn_impl
        if self.device.type == "cuda" and self._kernels_viable():
            return "flash"
        return "plain"

    def _forward(self, tokens: List[List[int]], start_pos: int, cache: KVCache,
                 logits_at: Optional[int] = None):
        tok = torch.tensor(tokens, dtype=torch.int32, device=self.device)
        return forward(self.model.params, self.model.cfg, tok, start_pos, cache,
                       attn_impl=self._attn_impl(), logits_at=logits_at)

    def _select_token(self, logits_row: torch.Tensor) -> int:
        return int(sample_token(logits_row, self._generator, self.args.temperature,
                                self.args.top_k, self.args.top_p))

    # ------------------------------------------------------- prefix caching

    MAX_CACHED_PREFIXES = 4

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

    def _prefill(self, prompt_tokens: Sequence[int],
                 cache_len: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
        """Bucketed-padded prefill; returns logits at the last prompt row.
        Reuses the longest cached prefix snapshot when one matches."""
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
            cache = self._prefix_cache[prefix].truncated(cache_len)
            self.log("Prefix cache hit: %d of %d prompt tokens reused",
                     plen, prompt_len)
            return self._run_prefill(suffix, cache, plen)
        self.log("Running prefill: prompt_len=%d", prompt_len)
        return self._run_prefill(list(prompt_tokens),
                                 self.new_cache(1, cache_len), 0)

    # ------------------------------------------------------------- decode

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
        vocab = self.model.vocab
        horizon = min(self.seq_len, cache_len)
        cap = max_new_tokens if max_new_tokens is not None else float("inf")
        emitted = 0
        logits, cache = self._prefill(prompt_tokens, cache_len)
        next_token = self._select_token(logits[0, 0])
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
                return
            logits, cache = self._forward([[next_token]], cur_pos, cache)
            next_token = self._select_token(logits[0, -1])
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
