"""Token selection: greedy argmax and temperature/top-k/top-p sampling.

Port of ``llama_nuts_and_bolts_tpu/ops/sampling.py``: ``greedy`` and
``sample_token`` for one request, ``sample_tokens_batched`` and
``top_logprobs_batched`` for a batched decode step. Randomness comes from
``torch.Generator``s, so sampled tokens cannot equal the JAX package's
(threefry) draws; greedy tokens can. What the batched sampler keeps is the
property the JAX one has: a row's token depends only on its seed, its
position and its logits, never on its batch neighbours. Each sampled row
draws Gumbel noise from its own generator, seeded from ``(seed, position)``
by :func:`row_seed`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from llama_nuts_and_bolts_tpu_torch.device import exact_div

_U64 = (1 << 64) - 1


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
    return draw_token(logits, generator, temperature, top_k, top_p)


def draw_token(logits: torch.Tensor, generator: torch.Generator, temperature,
               top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """The sampled branch of :func:`sample_token`, with no host read, so a
    captured decode step can run it. ``temperature`` is a positive float or
    a 0-d tensor on ``logits``' device; either way the logits are divided,
    never multiplied by the reciprocal (``device.exact_div``), so the eager
    and the captured step give the same bits. The draw is
    ``torch.multinomial``'s own for one sample, ``argmax(probs / q)`` with
    ``q ~ Exp(1)`` from ``generator``, without its host-side checks of the
    probabilities."""
    scaled = logits.float()
    if isinstance(temperature, torch.Tensor):
        scaled = scaled / temperature
    else:
        scaled = exact_div(scaled, float(temperature))
    if top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[..., -top_k][..., None]
        scaled = torch.where(scaled < kth, float("-inf"), scaled)
    if top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        scaled = torch.where(scaled < cutoff, float("-inf"), scaled)
    probs = torch.softmax(scaled, dim=-1)
    lead = probs.shape[:-1]
    probs = probs.reshape(-1, probs.shape[-1])
    draw = torch.argmax(probs / exponential_noise(probs, generator), dim=-1)
    return draw.reshape(lead).to(torch.int32)


def exponential_noise(like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``Exp(1)`` noise shaped as ``like``: the generator state one sampled
    token consumes (an engine rewinds a generator by replaying these)."""
    return torch.empty_like(like).exponential_(1, generator=generator)


def row_seed(seed: int, position: int) -> int:
    """The generator seed of one sampled row: ``seed`` and ``position``
    mixed by splitmix64's finaliser (the port's ``fold_in``)."""
    z = (int(seed) + 0x9E3779B97F4A7C15 * (int(position) + 1)) & _U64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return z ^ (z >> 31)


def masked_scaled_logits(logits: torch.Tensor, temperature: torch.Tensor,
                         top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """``logits / temperature`` per row with everything outside the row's
    top-k and then its top-p set at -inf: the distribution a sampled row
    draws from (``sample_tokens_batched`` of the JAX package, lines 59-77).
    Rows with temperature <= 0 are scaled by 1; top-k <= 0 keeps every
    logit, top-p >= 1 keeps every top-k survivor."""
    B, V = logits.shape
    safe_t = torch.where(temperature > 0.0, temperature, torch.ones_like(temperature))
    scaled = logits.float() / safe_t[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (torch.where(top_k > 0, top_k, torch.full_like(top_k, V)) - 1).clamp(0, V - 1)
    kth = torch.gather(sorted_desc, -1, k_idx[:, None].long())
    scaled = torch.where(scaled < kth, float("-inf"), scaled)
    # top-p after top-k: the cutoff comes from the top-k-masked distribution.
    # The running sum is taken in float64: an fp32 running sum reaches 1.0
    # before the tail and would cut it from rows that ask for no top-p
    sorted_masked = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_masked, dim=-1).double(), dim=-1)
    cutoff_idx = torch.sum(cum < top_p[:, None].double(), dim=-1,
                           keepdim=True).clamp_max(V - 1)
    cutoff = torch.gather(sorted_masked, -1, cutoff_idx)
    cut = (scaled < cutoff) & (top_p < 1.0)[:, None]
    return torch.where(cut, float("-inf"), scaled)


def sample_tokens_batched(
    logits: torch.Tensor,          # [B, vocab] fp32
    seeds: Sequence[int],          # [B] per-row base seeds (host)
    positions: Sequence[int],      # [B] per-row positions (host)
    temperature: Sequence[float],  # [B] host; rows <= 0 decode greedily
    top_k: Sequence[int],          # [B] host; rows <= 0 mean "no top-k"
    top_p: Sequence[float],        # [B] host; rows >= 1 mean "no top-p"
) -> torch.Tensor:
    """Row-wise sampling for a shared batched decode step. The per-row
    settings are host arrays (numpy or lists), so a batch of greedy rows
    costs one argmax and no host round trip. A sampled row draws
    ``argmax(masked_logits + Gumbel noise)`` with the noise from a generator
    on the logits' device seeded by ``row_seed(seed, position)``: its token
    depends only on its seed, position and logits. Returns ``[B]`` int32."""
    out = greedy(logits)
    temps = [float(t) for t in temperature]
    rows = [b for b, t in enumerate(temps) if t > 0.0]
    if not rows:
        return out
    dev = logits.device
    sel = torch.tensor(rows, device=dev)

    def host(values, dtype):
        return torch.tensor([values[b] for b in rows], dtype=dtype, device=dev)

    masked = masked_scaled_logits(
        logits[sel], host(temps, torch.float32),
        host([int(k) for k in top_k], torch.int64), host([float(p) for p in top_p],
                                                         torch.float32))
    V = logits.shape[-1]
    noise = torch.empty((len(rows), V), dtype=torch.float32, device=dev)
    for i, b in enumerate(rows):
        gen = torch.Generator(device=dev)
        gen.manual_seed(row_seed(int(seeds[b]), int(positions[b])))
        noise[i] = torch.rand(V, generator=gen, device=dev)
    gumbel = -torch.log(-torch.log(noise))
    out[sel] = torch.argmax(masked + gumbel, dim=-1).to(torch.int32)
    return out


def top_logprobs_batched(logits: torch.Tensor, chosen: torch.Tensor, k: int):
    """Per-row log-softmax info for OpenAI-style ``logprobs``: returns
    (chosen_logprob ``[B]``, top_vals ``[B, k]``, top_ids ``[B, k]`` int32)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    chosen_lp = torch.gather(lp, -1, chosen.long()[:, None])[:, 0]
    top_vals, top_ids = torch.topk(lp, k, dim=-1)
    return chosen_lp, top_vals, top_ids.to(torch.int32)
