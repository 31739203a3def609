"""The int8-dot attention math of K4's ``int8_mxu`` mode, in plain PyTorch.

Port of ``llama_nuts_and_bolts_tpu/kernels/quant_attn_math.py``: the same
formulas, epsilons (1e-8, 1e-30), clip bounds and order of the scale folds.
The int8 cache tiles stay int8 inside both products and every scale applies
to the small ``[G, block]`` matrices (a leading batch of KV heads may ride
along):

  scores[g, t] = (q_i[g] . k_i[t]) * (qs[g] * softmax_scale) * ks[t]
  pv[g, d]     = (p_i[g] . v_i[:, d]) * ps[g],   p_i = round((p * vs) / ps)

The per-position v scales fold into p before p is quantized per row, so one
scale per row keeps ``sum_t p * v * vs[t]``. The integer products are exact:
in the CUDA kernel (``csrc/decode_attention_int8.cu``) on ``__dp4a``; here on float64,
which holds every such sum exactly (CUDA has no integer matmul), and are then
cast to int32. Rounding is half to even, as ``jnp.round``.
"""

from __future__ import annotations

import torch

from llama_nuts_and_bolts_tpu_torch.device import exact_div


def quantize_q_rows(q: torch.Tensor):
    """``[..., G, D]`` query rows → (int8 rows, fp32 per-row scales
    ``[..., G, 1]``)."""
    qf = q.float()
    qs = exact_div(qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), 127.0)
    q_i = torch.round(qf / qs).clamp(-127, 127).to(torch.int8)
    return q_i, qs


def int8_scores(q_i: torch.Tensor, qs: torch.Tensor, k_tile: torch.Tensor,
                ks_row: torch.Tensor, scale: float) -> torch.Tensor:
    """int8 x int8 → int32 ``q k^T``, then the scales on the ``[..., G, block]``
    result. ``ks_row`` is the fp32 per-position k-scale vector ``[..., block]``."""
    s32 = (q_i.double() @ k_tile.double().transpose(-1, -2)).to(torch.int32)
    return s32.float() * (qs * scale) * ks_row[..., None, :]


def int8_pv(p: torch.Tensor, v_tile: torch.Tensor, vs_row: torch.Tensor) -> torch.Tensor:
    """``p V`` with V kept int8: fold the per-position v scales into ``p``,
    quantize the folded probabilities per row, dot in integers, rescale."""
    pf = p * vs_row[..., None, :]
    ps = exact_div(pf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30), 127.0)
    p_i = torch.round(pf / ps).clamp(-127, 127).to(torch.int8)
    pv32 = (p_i.double() @ v_tile.double()).to(torch.int32)
    return pv32.float() * ps
