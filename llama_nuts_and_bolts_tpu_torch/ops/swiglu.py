"""SwiGLU feed-forward: ``down(silu(gate(x)) * up(x))``.

Port of ``llama_nuts_and_bolts_tpu/ops/swiglu.py``: gate and up stay fp32
through the SiLU and the product, which is rounded once to ``x.dtype`` before
the down projection. (The fused weight layout in ``models/llama/model.py``
rounds ``gu`` to bf16 before the SiLU instead, as the JAX model does.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from llama_nuts_and_bolts_tpu_torch.ops.linear import linear


def swiglu_act(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """``silu(gate(x)) * up(x)``, rounded once to ``x.dtype``: the input of
    the down projection (a tensor-parallel block sums that product over its
    ranks, ``models/llama/model.py``)."""
    gate = F.silu(linear(x, w_gate, out_dtype=torch.float32))
    up = linear(x, w_up, out_dtype=torch.float32)
    return (gate * up).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return linear(swiglu_act(x, w_gate, w_up), w_down)
