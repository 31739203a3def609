"""Token selection: greedy argmax and temperature/top-k/top-p sampling.

Port of ``greedy`` and ``sample_token`` in
``llama_nuts_and_bolts_tpu/ops/sampling.py``. Randomness comes from a
``torch.Generator``, so sampled tokens cannot equal the JAX package's
(threefry) draws; greedy tokens can.
"""

from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last dim; ties resolve to the lowest index (PyTorch
    returns the first maximal index)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_token(
    logits: torch.Tensor,                 # [..., vocab] fp32
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    if temperature <= 0.0 or generator is None:
        return greedy(logits)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    lead = probs.shape[:-1]
    draw = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                             generator=generator)
    return draw.reshape(lead).to(torch.int32)
