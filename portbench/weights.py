"""A configuration's weights, made from the seed on the device.

Each stacked weight is one ``torch.randn`` call in bf16 (the type it is
served in) on a ``torch.Generator`` of the device, scaled in place: no
leaf-by-leaf loop and no host copy. The same dict goes to the program
(wrapped in its ``LlamaParams``) and to the plain reference; when the
program's set-up has dropped it, :func:`make_weights` makes the same tensors
again from the same seed, and :func:`checksum` shows they are the same.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.yardstick import Dims

# split-layout weight shapes a layer, [out, in] as in the checkpoint
LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def layer_shapes(d: Dims) -> Dict[str, tuple]:
    q, kv = d.n_heads * d.head_dim, d.n_kv_heads * d.head_dim
    return {"wq": (q, d.dim), "wk": (kv, d.dim), "wv": (kv, d.dim), "wo": (d.dim, q),
            "w_gate": (d.ffn, d.dim), "w_up": (d.ffn, d.dim), "w_down": (d.dim, d.ffn)}


def make_weights(d: Dims, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of the model: ``tok_embeddings [V, dim]``, ``output
    [V, dim]``, ``norm [dim]`` and each layer weight stacked ``[L, ...]``
    (norm weights ``attn_norm``/``ffn_norm`` ``[L, dim]``). Projections are
    N(0, 1/fan_in), norm weights 1 + N(0, 0.1^2)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))

    def randn(shape, scale: float, shift: float = 0.0) -> torch.Tensor:
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)
        t.mul_(scale)
        if shift:
            t.add_(shift)
        return t

    L = d.n_layers
    w: Dict[str, torch.Tensor] = {
        "tok_embeddings": randn((d.vocab, d.dim), 1.0),
        "output": randn((d.vocab, d.dim), 1.0 / math.sqrt(d.dim)),
        "norm": randn((d.dim,), 0.1, 1.0),
        "attn_norm": randn((L, d.dim), 0.1, 1.0),
        "ffn_norm": randn((L, d.dim), 0.1, 1.0),
    }
    for key, (o, i) in layer_shapes(d).items():
        w[key] = randn((L, o, i), 1.0 / math.sqrt(i))
    return w


def checksum(w: Dict[str, torch.Tensor]) -> float:
    """A cheap fingerprint of the weights: a weighted fp64 sum over every
    4099th element of each tensor."""
    return float(sum(w[name].reshape(-1)[::4099].double().sum() * (k + 1)
                     for k, name in enumerate(sorted(w))))
