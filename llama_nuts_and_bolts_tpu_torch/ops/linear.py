"""bf16 linear projections with fp32 accumulation and one rounding.

Port of ``llama_nuts_and_bolts_tpu/ops/linear.py`` (plain bf16 weights only;
int8/int4 weights are a later slice). ``linear`` takes checkpoint-layout
``w[out, in]``, ``linear_t`` the fused decode layout ``w[in, out]``.

On a card the product goes to cuBLAS with fp32 accumulation
(``device.configure_numerics``); an fp32 result (the logits head) comes from
``torch.mm(..., out_dtype=torch.float32)`` so it never passes through bf16.
The CPU build has no ``aten::mm.dtype`` kernel, so on the CPU both operands
are upcast to fp32 first: bf16 products are exact in fp32, so this is the
same fp32 accumulation with a single rounding at the end.
"""

from __future__ import annotations

from typing import Optional

import torch


def _matmul(x: torch.Tensor, w: torch.Tensor,
            out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x[..., in] @ w[in, out]`` → ``out_dtype`` (default ``x.dtype``)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        out = torch.mm(x2.float(), w.float()).to(out_dtype)
    elif out_dtype == x.dtype:
        out = torch.mm(x2, w)
    else:
        out = torch.mm(x2, w, out_dtype=out_dtype)
    return out.reshape(*lead, w.shape[-1])


def linear(x: torch.Tensor, w: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w.T`` for ``x[..., in]`` and ``w[out, in]``."""
    return _matmul(x, w.t(), out_dtype)


def linear_t(x: torch.Tensor, w: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` for ``x[..., in]`` and the transposed layout ``w[in, out]``."""
    return _matmul(x, w, out_dtype)
