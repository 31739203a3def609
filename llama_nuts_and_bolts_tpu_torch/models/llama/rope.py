"""Rotary position embeddings with Llama-3.1 frequency scaling.

Port of ``llama_nuts_and_bolts_tpu/models/llama/rope.py``. The tables are
built in numpy exactly as there: angles in float64, then cos/sin cast to fp32
(that order matters for bit-equal tables). ``apply_rope`` rotates the head
dim viewed as interleaved (re, im) pairs in fp32 and casts back.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Llama-3.1 scaling constants; Llama-3.2 1B/3B checkpoints override
# scale_factor to 32 via params.json ("rope_scaling_factor").
SCALE_FACTOR = 8.0
LOW_FREQ_FACTOR = 1.0
HIGH_FREQ_FACTOR = 4.0
OLD_CONTEXT_LEN = 8192.0


def _scale_freqs(freqs: np.ndarray, scale_factor: float = SCALE_FACTOR,
                 high_freq_factor: float = HIGH_FREQ_FACTOR) -> np.ndarray:
    """Wavelength-banded frequency rescale for long-context Llama-3.1/3.2."""
    low_freq_wavelen = OLD_CONTEXT_LEN / LOW_FREQ_FACTOR
    high_freq_wavelen = OLD_CONTEXT_LEN / high_freq_factor
    wavelen = 2.0 * np.pi / freqs
    smooth = (OLD_CONTEXT_LEN / wavelen - LOW_FREQ_FACTOR) / (
        high_freq_factor - LOW_FREQ_FACTOR
    )
    return np.where(
        wavelen < high_freq_wavelen,
        freqs,
        np.where(
            wavelen > low_freq_wavelen,
            freqs / scale_factor,
            (1.0 - smooth) * freqs / scale_factor + smooth * freqs,
        ),
    )


def precompute_rope_tables(
    head_dim: int,
    end: int,
    theta: float = 500000.0,
    use_scaled: bool = False,
    scale_factor: float = SCALE_FACTOR,
    high_freq_factor: float = HIGH_FREQ_FACTOR,
) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables of shape ``[end, head_dim//2]``, fp32, host-side."""
    exponents = np.arange(0, head_dim, 2, dtype=np.float64)[: head_dim // 2] / head_dim
    freqs = 1.0 / (theta ** exponents)
    if use_scaled:
        freqs = _scale_freqs(freqs, scale_factor, high_freq_factor)
    t = np.arange(end, dtype=np.float64)
    angles = np.outer(t, freqs)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x[B, S, H, D]`` by per-position tables ``cos/sin[S, D//2]``
    (one position per sequence row, shared by the batch) or ``[B, S, D//2]``
    (every batch row at its own positions)."""
    B, S, H, D = x.shape
    x32 = x.float().reshape(B, S, H, D // 2, 2)
    re, im = x32[..., 0], x32[..., 1]
    c = cos[..., None, :] if cos.dim() == 3 else cos[None, :, None, :]
    s = sin[..., None, :] if sin.dim() == 3 else sin[None, :, None, :]
    out = torch.stack([re * c - im * s, re * s + im * c], dim=-1)
    return out.reshape(B, S, H, D).to(x.dtype)
