"""Batched multi-prompt generation (position-synchronous, ragged prompts).

Port of ``llama_nuts_and_bolts_tpu/runtime/batch.py``. All B sequences
advance position-synchronously through one decode step per position, so the
batch shares each step's weight reads. Prefill runs to the SHORTEST prompt's
bucket (every row's tokens are real up to there); the ragged region and
generation then proceed one position at a time, feeding each row its own
prompt token while its prompt lasts (prompt-echo suppression) and its
previous greedy token after. Finished rows keep stepping (their cache slots
are written but never attended by other rows) until every row terminates.
Each step replays the engine's captured one-step graph at B rows, every
row at the same position (``runtime/decode_graph.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from llama_nuts_and_bolts_tpu_torch.ops.sampling import greedy
from llama_nuts_and_bolts_tpu_torch.runtime.types import GenerationState


@dataclass
class BatchStepResult:
    """One generated token for one row at one step."""

    row: int
    position: int
    token_id: int
    state: GenerationState
    is_prompt_echo: bool   # token came from the row's own prompt (ragged phase)


def generate_tokens_batched(engine, prompts: Sequence[Sequence[int]]):
    """Yields lists of BatchStepResult, one list per position step.

    ``engine`` is an InferenceEngine; rows that finished stop appearing in
    the per-step lists, and the generator ends when all rows are done.
    """
    from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

    vocab = engine.model.vocab
    B = len(prompts)
    lens = [len(p) for p in prompts]
    if not B or min(lens) == 0:
        raise ValueError("batched generation requires non-empty prompts")
    max_len, min_len = max(lens), min(lens)
    if max_len >= engine.seq_len:
        raise ValueError(
            f"context sequence length {engine.seq_len} must be higher than "
            f"longest prompt length {max_len}")

    bucket = prefill_bucket(min_len, engine.seq_len)
    # prefill only to the shortest prompt: every row is real up to min_len
    padded = [list(p[:bucket]) + [0] * (bucket - min(bucket, n))
              for p, n in zip(prompts, lens)]
    with engine._lease(B, engine.seq_len) as slot:
        logits, _ = engine._forward(padded, 0, slot.cache, logits_at=min_len - 1)
        # next token per row as of position min_len
        next_ids = greedy(logits[:, 0]).tolist()
        step = None

        finished: List[Optional[GenerationState]] = [None] * B
        pos = min_len
        while True:
            step_results: List[BatchStepResult] = []
            fed = []
            for b in range(B):
                echo = pos < lens[b]
                tok = int(prompts[b][pos]) if echo else next_ids[b]
                fed.append(tok)
                if finished[b] is not None:
                    continue
                state = GenerationState.IN_PROGRESS
                if not echo and vocab.is_stop(tok):
                    state = GenerationState.FINISHED_BY_REACHING_EOS
                elif pos + 1 >= engine.seq_len:
                    state = GenerationState.FINISHED_BY_REACHING_SEQ_LEN
                if state != GenerationState.IN_PROGRESS:
                    finished[b] = state
                if not echo:
                    step_results.append(BatchStepResult(
                        row=b, position=pos, token_id=tok, state=state,
                        is_prompt_echo=echo))
            if step_results:
                yield step_results
            if all(f is not None for f in finished) or pos + 1 >= engine.seq_len:
                return
            step = step or engine._decode_chunk(1, cache_len=engine.seq_len, slot=slot)
            slot.set(fed, [pos] * B)
            step.replay()
            next_ids = step.tokens(step.fetch())[0]
            pos += 1
