"""Weight bridge: numpy leaves of the JAX package's ``LlamaParams`` → port params.

The input is a dict with the JAX field names (``tok_embeddings``, ``layers``
as a dict of stacked arrays, ``norm``, ``output``, ``rope_cos``,
``rope_sin``), each a numpy array, e.g. ``np.asarray`` of a JAX array. bf16
arrays (numpy dtype named ``bfloat16``) cross through a ``uint16`` view, so
both packages hold bit-identical weights. Either layout is accepted: the
fused one is recognised by its ``wqkv`` key, as ``forward`` does. A
quantized leaf -- an object or a dict with ``q``/``scale`` (int8) or
``packed``/``scale`` (int4), e.g. the JAX package's ``QTensor`` and
``Q4Tensor`` -- becomes the port's ``QTensor`` or ``Q4Tensor`` with the same
bytes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from llama_nuts_and_bolts_tpu_torch.device import resolve_device
from llama_nuts_and_bolts_tpu_torch.models.llama.model import LlamaParams
from llama_nuts_and_bolts_tpu_torch.quant import Q4Tensor, QTensor


def tensor_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """Bit-exact numpy → torch, bf16 through a ``uint16`` view. The array is
    copied (JAX hands out read-only buffers)."""
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor, bf16_dtype=None) -> np.ndarray:
    """Bit-exact torch → numpy; bf16 comes back as ``uint16`` unless a numpy
    bf16 dtype (e.g. ``ml_dtypes.bfloat16``) is given to view it as."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        raw = t.view(torch.uint16).numpy()
        return raw.view(bf16_dtype) if bf16_dtype is not None else raw
    return t.numpy()


def weight_from_numpy(leaf, device):
    """A plain array, or a quantized leaf (object or dict with ``q``/``scale``
    or ``packed``/``scale``), bit-exact on ``device``."""
    def field(name):
        return leaf.get(name) if isinstance(leaf, dict) else getattr(leaf, name, None)

    for key, cls in (("packed", Q4Tensor), ("q", QTensor)):
        if field(key) is not None:
            return cls(**{key: tensor_from_numpy(np.asarray(field(key)), device),
                          "scale": tensor_from_numpy(np.asarray(field("scale")), device)})
    return tensor_from_numpy(leaf, device)


def params_from_numpy(leaves: Dict, device=None) -> LlamaParams:
    dev = resolve_device(device)
    return LlamaParams(
        tok_embeddings=tensor_from_numpy(leaves["tok_embeddings"], dev),
        layers={name: weight_from_numpy(a, dev)
                for name, a in leaves["layers"].items()},
        norm=tensor_from_numpy(leaves["norm"], dev),
        output=weight_from_numpy(leaves["output"], dev),
        rope_cos=tensor_from_numpy(leaves["rope_cos"], dev),
        rope_sin=tensor_from_numpy(leaves["rope_sin"], dev),
    )
