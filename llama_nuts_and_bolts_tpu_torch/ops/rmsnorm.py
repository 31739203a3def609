"""RMSNorm: ``x * rsqrt(mean(x², axis=-1) + eps) * weight``.

Port of ``llama_nuts_and_bolts_tpu/ops/rmsnorm.py``: statistics in fp32, the
fp32-cast weight multiplied in fp32, one cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return ((x32 * inv) * weight.float()).to(x.dtype)
