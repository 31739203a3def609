"""Grouped-query attention without repeat-KV, and its additive mask.

Port of ``llama_nuts_and_bolts_tpu/ops/attention.py`` and of
``attention_mask`` in its ``models/llama/model.py``. The query heads are
viewed as ``[kv_heads, group]`` so the KV expansion is a broadcast inside the
einsum. Scores and the max-subtracted softmax are fp32; the probabilities are
rounded to ``q.dtype`` before the PV product, which accumulates in fp32.
The einsums run on fp32 copies of their operands: bf16 products are exact in
fp32, so this is the JAX path's fp32 accumulation.

This is the plain path (``attn_impl="plain"``) and the oracle the kernels in
``kernels/`` are held against.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_mask(seq_len: int, cache_len: int, start_pos: int,
                   device=None) -> torch.Tensor:
    """Additive fp32 mask ``[seq_len, cache_len]``: 0 where cache slot ``t``
    is visible to query row ``s`` (``t <= start_pos + s``), -inf elsewhere."""
    rows = torch.arange(seq_len, device=device)[:, None]
    cols = torch.arange(cache_len, device=device)[None, :]
    visible = cols <= rows + start_pos
    return torch.where(visible, 0.0, float("-inf")).to(torch.float32)


def attention_mask_per_row(seq_len: int, cache_len: int,
                           start_pos: torch.Tensor) -> torch.Tensor:
    """Per-row variant for a ``[B]`` ``start_pos`` (continuous batching):
    ``[B, seq_len, cache_len]``, row ``b`` sees slot ``t`` iff
    ``t <= start_pos[b] + s``."""
    dev = start_pos.device
    rows = torch.arange(seq_len, device=dev)[None, :, None]
    cols = torch.arange(cache_len, device=dev)[None, None, :]
    visible = cols <= rows + start_pos.long()[:, None, None]
    return torch.where(visible, 0.0, float("-inf")).to(torch.float32)


def gqa_attention(
    q: torch.Tensor,            # [B, S, n_heads, head_dim]
    k: torch.Tensor,            # [B, kv_heads, T, head_dim]  (cache layout)
    v: torch.Tensor,            # [B, kv_heads, T, head_dim]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, S, T]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns ``[B, S, n_heads, head_dim]`` in ``q.dtype``."""
    B, S, H, D = q.shape
    KV = k.shape[1]
    G = H // KV
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, S, KV, G, D).float()
    scores = torch.einsum("bskgd,bktd->bkgst", qg, k.float()) * scale
    if mask is not None:
        scores = scores + mask[:, None, None, :, :].float()
    probs = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    out = torch.einsum("bktd,bkgst->bskgd", v.float(),
                       probs.to(q.dtype).float())
    return out.reshape(B, S, H, D).to(q.dtype)
