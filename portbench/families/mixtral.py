"""Mixtral: Mistral-7B's attention with a mixture of eight SwiGLU experts,
two a token, in place of the dense feed-forward (Mistral AI, "Mixtral of
Experts", arXiv:2401.04088).

Its shapes (:class:`MixtralDims`, which also gives the work counts of its
readers, ``portbench/metrics/*.moe.py``), its weights and its plain
reference, with the routing tie rule, are ``portbench/mixtral_reference.py``;
the program is the port's ``LlamaParams`` with the expert layer's weights,
in a ``LoadedModel`` that carries a routing log, which the batcher fills
with the experts it chose for every row it served and the reference's tie
rule follows. A port without an expert layer is refused at once.
"""

from typing import Dict

from portbench.entries import synthetic_vocab
from portbench.mixtral_reference import (
    ATTN_KEYS,
    EXPERT_KEYS,
    MixtralDims,
    Reference,
    follow_program,
    make_weights,
)

__all__ = ["Reference", "dims", "make_weights", "program"]


def _port_has_experts() -> bool:
    from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs

    return hasattr(ModelArgs(), "n_experts")


def dims(cfg: Dict) -> MixtralDims:
    """The shapes; a port without an expert layer is refused at once."""
    if not _port_has_experts():
        raise RuntimeError("the port has no expert layer (ModelArgs.n_experts): it cannot "
                           "run a Mixtral configuration")
    return MixtralDims.from_config(cfg)


def program(weights: Dict, cfg_path, context: int, device, fused: bool):
    """The program's ``LoadedModel`` over the benchmark's weights: the
    configuration read by the port's own ``params.json`` loader, whose
    ``n_experts`` makes the port's layer the expert layer (a port without it
    is refused), its rotary tables, (``fused``) its fused layout, and a
    fresh routing log, which the references made from now on follow."""
    from llama_nuts_and_bolts_tpu_torch.io.params import load_model_args
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import (
        LlamaParams,
        fuse_decode_params,
        rope_tables as port_rope_tables,
    )
    from llama_nuts_and_bolts_tpu_torch.ops.moe import RoutingLog

    cfg = load_model_args(str(cfg_path), max_sequence_length=context)
    if not getattr(cfg, "n_experts", 0):
        raise RuntimeError(f"the port read no experts from {cfg_path}")
    cos, sin = port_rope_tables(cfg, device)
    params = LlamaParams(tok_embeddings=weights["tok_embeddings"],
                         layers={key: weights[key] for key in
                                 ("attn_norm", "ffn_norm") + ATTN_KEYS + EXPERT_KEYS},
                         norm=weights["norm"], output=weights["output"],
                         rope_cos=cos, rope_sin=sin)
    if fused:
        params = fuse_decode_params(params)
    log = RoutingLog()
    follow_program(log)
    return LoadedModel(params=params, cfg=cfg, vocab=synthetic_vocab(cfg.vocab_size),
                       mergeable_ranks={}, tensor_meta={}, routing_log=log)
