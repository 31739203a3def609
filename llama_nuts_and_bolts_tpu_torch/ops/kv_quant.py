"""int8 K/V rows: the dense int8 cache's and the paged int8 pool's bytes.

Port of the JAX package's ``quantize_kv_rows`` (``models/llama/model.py``
there): symmetric int8 per (..., position) over the head dim, with a bf16
scale, quantized once as the rows are written; the plain attention paths
read them back through :func:`dequantize_kv_rows`.
"""

from __future__ import annotations

import torch

from llama_nuts_and_bolts_tpu_torch.device import exact_div


def quantize_kv_rows(rows: torch.Tensor):
    """Per-(..., position) symmetric int8 over the head dim: (int8 rows,
    bf16 scales with the last axis dropped). Rows are divided by the fp32
    scale, which is stored rounded to bf16, as in the JAX package."""
    r32 = rows.float()
    s = exact_div(r32.abs().amax(dim=-1).clamp_min(1e-8), 127.0)
    q = torch.round(r32 / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def dequantize_kv_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``bf16(int8) * bf16(scale)`` per element, in bf16: int8 rows ``[...,
    D]`` with their scales ``[...]``."""
    return q.to(torch.bfloat16) * s[..., None].to(torch.bfloat16)
