"""Whole-request greedy generation for the server's non-streaming path.

Port of ``generate_block`` in ``llama_nuts_and_bolts_tpu/runtime/device_loop.py``:
a prefill, then greedy decode steps until a stop token or the token budget,
returning the same ``(ids, finish)``. The JAX package runs the decode loop
on the device in one dispatch; here it is a host loop of decode steps. The
loop on the device is the decode CUDA graph (ROADMAP item 19).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def generate_block(engine, prompt_tokens: Sequence[int],
                   max_new_tokens: int = 128) -> Tuple[List[int], str]:
    """Prefill + greedy decode; returns (token_ids, finish_reason). The
    tokens end at the first stop token (included, finish ``"stop"``) or at
    ``max_new_tokens`` capped by the context (``"length"``)."""
    from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

    vocab = engine.model.vocab
    prompt_len = len(prompt_tokens)
    if prompt_len >= engine.seq_len:
        raise ValueError("prompt longer than context")
    max_new = min(max_new_tokens, engine.seq_len - prompt_len)
    # request-bucketed cache buffer (engine.cache_bucket)
    cache_len = engine.cache_bucket(prompt_len, max_new)
    cache = engine.new_cache(1, cache_len)
    padded = list(prompt_tokens) + [0] * (prefill_bucket(prompt_len, cache_len) - prompt_len)
    logits, cache = engine._forward([padded], 0, cache, logits_at=prompt_len - 1)
    ids = [int(torch.argmax(logits[0, -1]))]
    pos = prompt_len                      # where the last token is written
    while len(ids) < max_new and not vocab.is_stop(ids[-1]):
        logits, cache = engine._forward([[ids[-1]]], pos, cache)
        ids.append(int(torch.argmax(logits[0, -1])))
        pos += 1
    finish = "stop" if vocab.is_stop(ids[-1]) else "length"
    return ids, finish
