"""Device resolution and the numerics every entry point runs under.

Entry points default to ``cuda``; the CPU is used only when the caller asks
for it (the tests do). Asking for ``cuda`` where there is no card raises:
nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def configure_numerics() -> None:
    """Match the JAX package's fp32 accumulation: bf16 products reduce in
    fp32 with no reduced-precision split-K reduction, and fp32 products and
    convolutions never drop to TF32."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means :data:`DEFAULT_DEVICE`. Raises for ``cuda`` without a
    card instead of running on the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but no CUDA device is available "
            "(pass device='cpu' / --device cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    configure_numerics()
    if dev.type == "cuda" and dev.index is None:
        # name the card, so that devices compare equal to tensors' devices
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
