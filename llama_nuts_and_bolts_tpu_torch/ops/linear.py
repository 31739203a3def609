"""Linear projections with fp32 accumulation and one rounding.

Port of ``llama_nuts_and_bolts_tpu/ops/linear.py``. ``linear`` takes
checkpoint-layout ``w[out, in]``, ``linear_t`` the fused decode layout
``w[in, out]``.

On a card a bf16 product goes to cuBLAS with fp32 accumulation
(``device.configure_numerics``); an fp32 result (the logits head) comes from
``torch.mm(..., out_dtype=torch.float32)`` so it never passes through bf16.
The CPU build has no ``aten::mm.dtype`` kernel, so on the CPU both operands
are upcast to fp32 first: bf16 products are exact in fp32, so this is the
same fp32 accumulation with a single rounding at the end.

``w`` may also be quantized, recognised by its fields so that this module
needs nothing of ``quant/`` (which imports the model, which imports this):

  * ``QTensor`` (``q``/``scale``, int8): the int8 matrix is cast to bf16 for
    the product and the scale multiplies the fp32 result. As in the JAX
    package this is plain tensor code, so on the card every call makes a
    bf16 copy of the weight (PERF.md).
  * ``Q4Tensor`` (``packed``/``scale``, int4): K8 (``kernels/q4_matmul.py``)
    on a CUDA tensor for decode-shaped calls (``k8_takes``: at most 32 rows,
    as in decode steps, the logits head and prefill buckets of 16 and 32, and
    a weight layout the kernel holds); otherwise, on the card and on the CPU
    alike, ``unpack_q4`` and a dense product.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import k8_takes, q4_matmul


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


def linear(x: torch.Tensor, w, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w.T`` for ``x[..., in]`` and ``w[out, in]`` (plain, ``QTensor``
    or ``Q4Tensor``)."""
    if hasattr(w, "packed"):
        return _linear_q4(x, w, out_dtype)
    if hasattr(w, "q"):
        out = _matmul(x, w.q.to(x.dtype).t(), torch.float32) * w.scale.float()
        return out.to(out_dtype or x.dtype)
    return _matmul(x, w.t(), out_dtype)


def _linear_q4(x: torch.Tensor, w, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    lead = x.shape[:-1]
    rows = math.prod(lead)
    if x.device.type == "cuda" and k8_takes(rows, w.packed):
        out = q4_matmul(x.reshape(rows, x.shape[-1]), w.packed, w.scale)
        out = out.reshape(*lead, w.packed.shape[1])
    else:
        from llama_nuts_and_bolts_tpu_torch.quant.int4 import unpack_q4

        out = _matmul(x, unpack_q4(w, x.dtype).t(), torch.float32)
    return out.to(out_dtype or x.dtype)


def linear_t(x: torch.Tensor, w: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` for ``x[..., in]`` and the transposed layout ``w[in, out]``."""
    return _matmul(x, w, out_dtype)
