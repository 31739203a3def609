"""Multi-token greedy generation on the device: the decode loop as graphs.

Port of ``llama_nuts_and_bolts_tpu/runtime/device_loop.py``. The JAX
package runs the loop as one ``lax.while_loop`` that stops when every row
has hit a stop id; a CUDA graph has no early exit, so :func:`decode_block`
replays a k-step graph (``runtime/decode_graph.py``) whose stop mask and
counts live on the device, and the host reads ``all(stopped)`` once per
chunk. :func:`generate_block` (the server's non-streaming path and its
prewarm) is a prefill and one ``decode_block``. The streaming paths replay
the engine's chunk graphs instead (``InferenceArgs.decode_chunk``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.ops.sampling import greedy

BLOCK_CHUNK = 8          # decode steps per replay between reads of the stop mask


def decode_block(engine, slot, first_token: torch.Tensor, start_pos: int,
                 max_new_tokens: int, stop_ids: Optional[Sequence[int]] = None):
    """Greedy-decode up to ``max_new_tokens`` from ``first_token`` (int32
    ``[B, 1]``, at position ``start_pos``) over ``slot``'s cache, which the
    caller leased and prefilled.

    Returns (tokens ``[B, max_new_tokens]``, count ``[B]``, cache), as the
    JAX function does: a row's entries past its stop token repeat it, its
    count includes the stop token, and once every row has stopped the
    entries past the longest count are 0 (the JAX loop exits there). Steps
    run in BLOCK_CHUNK-step replays while as many remain, then one step at
    a time, so no step writes past ``start_pos + max_new_tokens - 2``."""
    stop_ids = [-1] if stop_ids is None else list(stop_ids)
    B = first_token.shape[0]
    tokens = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=slot.device)
    tokens[:, :1] = first_token
    slot.begin_block(first_token, start_pos, stop_ids)
    done = 1
    while done < max_new_tokens and not bool(slot.stopped.all()):
        k = BLOCK_CHUNK if max_new_tokens - done >= BLOCK_CHUNK else 1
        graph = engine._decode_chunk(k, cache_len=slot.cache_len, slot=slot, stops=True)
        graph.replay()
        tokens[:, done:done + k] = graph.out.t()
        done += k
    if bool(slot.stopped.all()):
        tokens[:, int(slot.count.max()):] = 0
    return tokens, slot.count.clone(), slot.cache


def generate_block(engine, prompt_tokens: Sequence[int],
                   max_new_tokens: int = 128) -> Tuple[List[int], str]:
    """Prefill + on-device greedy decode; returns (token_ids, finish_reason).
    The tokens end at the first stop token (included, finish ``"stop"``) or
    at ``max_new_tokens`` capped by the context (``"length"``)."""
    from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

    vocab = engine.model.vocab
    prompt_len = len(prompt_tokens)
    if prompt_len >= engine.seq_len:
        raise ValueError("prompt longer than context")
    max_new = min(max_new_tokens, engine.seq_len - prompt_len)
    # request-bucketed cache buffer (engine.cache_bucket)
    cache_len = engine.cache_bucket(prompt_len, max_new)
    padded = list(prompt_tokens) + [0] * (prefill_bucket(prompt_len, cache_len) - prompt_len)
    with engine._lease(1, cache_len) as slot:
        logits, _ = engine._forward([padded], 0, slot.cache, logits_at=prompt_len - 1)
        first = greedy(logits[:, -1])[:, None]
        # first_token sits at position prompt_len
        tokens, count, _ = decode_block(engine, slot, first, prompt_len, max_new,
                                        sorted(vocab.stop_token_ids))
        ids = tokens[0, :int(count[0])].tolist()
    finish = "stop" if ids and vocab.is_stop(ids[-1]) else "length"
    return ids, finish
