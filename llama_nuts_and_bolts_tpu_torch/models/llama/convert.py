"""Weight bridge: numpy leaves of the JAX package's ``LlamaParams`` → port params.

The input is a dict with the JAX field names (``tok_embeddings``, ``layers``
as a dict of stacked arrays, ``norm``, ``output``, ``rope_cos``,
``rope_sin``), each a numpy array, e.g. ``np.asarray`` of a JAX array. bf16
arrays (numpy dtype named ``bfloat16``) cross through a ``uint16`` view, so
both packages hold bit-identical weights. Either layout is accepted: the
fused one is recognised by its ``wqkv`` key, as ``forward`` does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from llama_nuts_and_bolts_tpu_torch.device import resolve_device
from llama_nuts_and_bolts_tpu_torch.models.llama.model import LlamaParams


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


def params_from_numpy(leaves: Dict, device=None) -> LlamaParams:
    dev = resolve_device(device)
    return LlamaParams(
        tok_embeddings=tensor_from_numpy(leaves["tok_embeddings"], dev),
        layers={name: tensor_from_numpy(a, dev)
                for name, a in leaves["layers"].items()},
        norm=tensor_from_numpy(leaves["norm"], dev),
        output=tensor_from_numpy(leaves["output"], dev),
        rope_cos=tensor_from_numpy(leaves["rope_cos"], dev),
        rope_sin=tensor_from_numpy(leaves["rope_sin"], dev),
    )
