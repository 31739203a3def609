"""Speculative decoding proposers: n-gram prompt lookup and a draft model.

Port of ``llama_nuts_and_bolts_tpu/runtime/speculative.py``. A verify step
over k+1 candidate tokens reads the same weight bytes as a one-token step,
so every accepted draft is a nearly free token. Every emitted token is still
the target model's own greedy argmax: a draft is emitted only when it equals
the target's prediction (``longest_accepted_prefix``).

  * :class:`NgramProposer` drafts from the sequence itself: the continuation
    of the most recent earlier occurrence of the current n-gram suffix. It
    runs on the host and has no weights (copied as it is).
  * :class:`DraftModelProposer` drafts with a smaller Llama that keeps its
    own KV cache on the engine's device. Its forwards run eagerly on the
    plain attention path (the JAX package's ``"xla"``); capturing them is
    an item of ROADMAP.md.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward


class NgramProposer:
    """Proposes draft continuations by suffix-matching the running context.

    ``propose(k)`` looks for the most recent earlier occurrence of the last
    ``n`` tokens (longest n first) and returns the k tokens that followed it.
    """

    def __init__(self, context: Sequence[int], max_ngram: int = 3) -> None:
        self.context: List[int] = list(context)
        self.max_ngram = max_ngram

    def extend(self, tokens: Sequence[int]) -> None:
        self.context.extend(tokens)

    def propose(self, k: int) -> List[int]:
        """Up to ``k`` draft tokens (empty list when no n-gram matches)."""
        ctx = self.context
        L = len(ctx)
        for n in range(min(self.max_ngram, L - 1), 0, -1):
            suffix = ctx[L - n:]
            # scan candidate match-ends right-to-left: most recent repeat wins
            for end in range(L - 1, n - 1, -1):
                if ctx[end - n:end] == suffix:
                    cont = ctx[end:end + k]
                    if cont:
                        return cont
        return []


def longest_accepted_prefix(drafts: Sequence[int], preds: Sequence[int]) -> int:
    """#leading drafts matching the verifier's argmax chain.

    ``preds[i]`` is the model's next token after consuming the accepted token
    plus drafts[:i]; draft i is correct iff it equals preds[i].
    """
    n = 0
    for d, p in zip(drafts, preds):
        if d != p:
            break
        n += 1
    return n


class DraftModelProposer:
    """Draft-model speculation: a smaller Llama proposes the k tokens.

    Same ``extend``/``propose`` surface as :class:`NgramProposer`. The draft
    keeps its own KV cache of ``seq_len`` positions. ``extend`` is host-only;
    ``propose`` first catches up -- one padded forward over the context
    tokens the cache has not absorbed, at power-of-two buckets from 16 (a
    rejected draft's rows are rewritten before any later query sees them)
    -- then drafts greedily, one single-token forward a draft after the
    first."""

    def __init__(self, draft_model, context: Sequence[int], seq_len: int) -> None:
        self.model = draft_model
        self.context: List[int] = list(context)
        self.seq_len = seq_len
        self._valid = 0                      # cache positions [0, _valid) final
        self._device = draft_model.params.device
        self._cache = KVCache.create(draft_model.cfg, 1, seq_len, device=self._device)

    def extend(self, tokens: Sequence[int]) -> None:
        self.context.extend(tokens)

    def _forward(self, tokens: List[int], start_pos: int, logits_at=None) -> int:
        """Greedy next token after ``tokens`` (row ``logits_at``, else the last)."""
        tok = torch.tensor([tokens], dtype=torch.int32, device=self._device)
        logits, _ = forward(self.model.params, self.model.cfg, tok, start_pos,
                            self._cache, attn_impl="plain", logits_at=logits_at)
        return int(torch.argmax(logits[0, -1]))

    def propose(self, k: int) -> List[int]:
        L = len(self.context)
        if k <= 0 or L + k > self.seq_len:
            return []
        # catch-up: feed the tokens the draft cache hasn't absorbed yet
        fresh = self.context[self._valid:]
        S = len(fresh)
        bucket = 16
        while bucket < S:
            bucket *= 2
        bucket = min(bucket, self.seq_len - self._valid)
        padded = fresh + [fresh[-1]] * (bucket - S)
        drafts = [self._forward(padded, self._valid, logits_at=S - 1)]
        for i in range(1, k):
            drafts.append(self._forward([drafts[-1]], L + i - 1))
        self._valid = L
        return drafts
