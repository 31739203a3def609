"""The Llama block, the port's own: dense grouped-query attention with
RoPE, RMSNorm and SwiGLU, no biases, an untied head.

Its shapes are ``yardstick.Dims`` (Llama's ``multiple_of`` rule for the
FFN, ``head_dim = dim // n_heads``), its weights the seven split
projections a layer (``portbench/weights.py``), its plain reference
``portbench/reference.py``, and the program the port's ``LlamaParams`` in a
``LoadedModel``. ``portbench/yardstick.py``'s work counts are this family's.
"""

from __future__ import annotations

from typing import Dict

from portbench.entries import synthetic_vocab
from portbench.reference import Reference
from portbench.weights import make_weights
from portbench.yardstick import Dims

__all__ = ["Reference", "dims", "make_weights", "program"]


def dims(cfg: Dict) -> Dims:
    return Dims.from_config(cfg)


def program(weights: Dict, cfg_path, context: int, device, fused: bool):
    """The program's ``LoadedModel`` over the benchmark's weights: the
    configuration read by the port's own ``params.json`` loader, its rotary
    tables, and (``fused``) its fused decode layout."""
    from llama_nuts_and_bolts_tpu_torch.io.params import load_model_args
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import (
        LlamaParams,
        fuse_decode_params,
        rope_tables,
    )

    cfg = load_model_args(str(cfg_path), max_sequence_length=context)
    cos, sin = rope_tables(cfg, device)
    params = LlamaParams(tok_embeddings=weights["tok_embeddings"],
                         layers={k: weights[k] for k in
                                 ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo",
                                  "w_gate", "w_up", "w_down")},
                         norm=weights["norm"], output=weights["output"],
                         rope_cos=cos, rope_sin=sin)
    if fused:
        params = fuse_decode_params(params)
    return LoadedModel(params=params, cfg=cfg, vocab=synthetic_vocab(cfg.vocab_size),
                       mergeable_ranks={}, tensor_meta={})
