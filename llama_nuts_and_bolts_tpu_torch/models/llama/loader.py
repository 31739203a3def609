"""Checkpoint → device params: name/shape validation, stacking, placement.

Port of ``llama_nuts_and_bolts_tpu/models/llama/loader.py``. The checkpoint
is read with PyTorch's own ingest, ``torch.load(path, mmap=True,
weights_only=True, map_location="cpu")``: the tensors stay memory-mapped, and
each layer's view is copied straight into its slot of the stacked
``[L, ...]`` tensor on the device, so no whole weight group is ever copied on
the host. ``quant="int8"`` / ``"int4"`` quantizes each layer's view on the
host (``quant/``) before it goes to the device, output head included, so the
card only ever holds the quantized bytes; they are the bytes the JAX
package's loader makes. Meta's multi-shard format is a later item of
ROADMAP.md.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.device import resolve_device
from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs, load_model_args
from llama_nuts_and_bolts_tpu_torch.models.llama.model import (
    LlamaParams,
    layer_weight_shapes,
    rope_tables,
)
from llama_nuts_and_bolts_tpu_torch.tokenizer import Vocabulary, load_tiktoken_model
from llama_nuts_and_bolts_tpu_torch.utils.logging import get_logger

# checkpoint tensor name ↔ layer-weight key
CKPT_LAYER_NAMES: Dict[str, str] = {
    "attn_norm": "layers.{i}.attention_norm.weight",
    "ffn_norm": "layers.{i}.ffn_norm.weight",
    "wq": "layers.{i}.attention.wq.weight",
    "wk": "layers.{i}.attention.wk.weight",
    "wv": "layers.{i}.attention.wv.weight",
    "wo": "layers.{i}.attention.wo.weight",
    "w_gate": "layers.{i}.feed_forward.w1.weight",
    "w_down": "layers.{i}.feed_forward.w2.weight",
    "w_up": "layers.{i}.feed_forward.w3.weight",
}

# fused decode layout: output key -> checkpoint parts concatenated along OUT
FUSED_GROUPS: Dict[str, Tuple[str, ...]] = {
    "wqkv": ("wq", "wk", "wv"),
    "wo": ("wo",),
    "w_gate_up": ("w_gate", "w_up"),
    "w_down": ("w_down",),
}


class CheckpointShapeError(Exception):
    pass


def expected_tensor_shapes(cfg: ModelArgs) -> Dict[str, Tuple[int, ...]]:
    """Full name→shape table (291 entries for the 8B config)."""
    shapes: Dict[str, Tuple[int, ...]] = {
        "tok_embeddings.weight": (cfg.vocab_size, cfg.dim),
        "norm.weight": (cfg.dim,),
        "output.weight": (cfg.vocab_size, cfg.dim),
    }
    per_layer = layer_weight_shapes(cfg)
    for i in range(cfg.n_layers):
        for key, tmpl in CKPT_LAYER_NAMES.items():
            shapes[tmpl.format(i=i)] = per_layer[key]
    return shapes


def validate_checkpoint(tensors: Dict[str, torch.Tensor], cfg: ModelArgs) -> None:
    expected = expected_tensor_shapes(cfg)
    if "output.weight" not in tensors:
        # Llama-3.2 (1B/3B) checkpoints tie the output head to the token
        # embedding and ship no separate output.weight
        expected.pop("output.weight")
    missing = sorted(set(expected) - set(tensors))
    if missing:
        raise CheckpointShapeError(
            f"checkpoint is missing {len(missing)} tensors, e.g. {missing[:3]}")
    for name, shape in expected.items():
        got = tuple(tensors[name].shape)
        if got != shape:
            raise CheckpointShapeError(
                f"tensor {name}: checkpoint shape {got} != expected {shape}")


def _host_quantize(host: torch.Tensor, quant: str):
    """One weight quantized on the host: the fields of a ``QTensor``
    (``quant="int8"``) or ``Q4Tensor`` (``"int4"``), as CPU tensors."""
    from llama_nuts_and_bolts_tpu_torch.quant import host_quantize_q4, quantize_tensor

    if quant == "int4":
        packed, scale = host_quantize_q4(host)
        return {"packed": packed, "scale": scale}
    qt = quantize_tensor(host.to("cpu"))
    return {"q": qt.q, "scale": qt.scale}


def build_params_from_checkpoint(tensors: Dict[str, torch.Tensor],
                                 cfg: ModelArgs, fused: bool = False,
                                 device=None, dtype=torch.bfloat16,
                                 quant: Optional[str] = None) -> LlamaParams:
    """Stack per-layer checkpoint tensors to ``[L, ...]`` on ``device``
    (default ``cuda``). ``fused=True`` assembles the fused decode layout
    (``model.fused_layer_weight_shapes``) from the same views;
    ``quant="int8"|"int4"`` quantizes the matmul weights and the head."""
    if quant not in (None, "int8", "int4"):
        raise ValueError(f"unsupported quant mode {quant!r}")
    if fused and quant is not None:
        raise ValueError("the fused decode layout is for plain bf16 weights "
                         "(quantized layouts keep their own packing)")
    validate_checkpoint(tensors, cfg)
    dev = resolve_device(device)
    log = get_logger()
    L = cfg.n_layers

    def view(key: str, i: int) -> torch.Tensor:
        return tensors[CKPT_LAYER_NAMES[key].format(i=i)]

    def stacked(key: str):
        if quant is not None and not key.endswith("norm"):
            return stacked_quantized(key)
        first = view(key, 0)
        out = torch.empty((L,) + tuple(first.shape), dtype=dtype, device=dev)
        for i in range(L):
            out[i].copy_(view(key, i))
        return out

    def quantized(fields):
        from llama_nuts_and_bolts_tpu_torch.quant import Q4Tensor, QTensor

        return (Q4Tensor if "packed" in fields else QTensor)(**fields)

    def stacked_quantized(key: str):
        out = None
        for i in range(L):
            fields = _host_quantize(view(key, i), quant)
            if out is None:
                out = {f: torch.empty((L,) + tuple(t.shape), dtype=t.dtype, device=dev)
                       for f, t in fields.items()}
            for f, t in fields.items():
                out[f][i].copy_(t)
        return quantized(out)

    layers: Dict[str, torch.Tensor] = {}
    layers["attn_norm"] = stacked("attn_norm")
    layers["ffn_norm"] = stacked("ffn_norm")
    if fused:
        for out_key, parts in FUSED_GROUPS.items():
            d_in = view(parts[0], 0).shape[1]
            d_out = sum(view(p, 0).shape[0] for p in parts)
            out = torch.empty((L, d_in, d_out), dtype=dtype, device=dev)
            for i in range(L):
                off = 0
                for p in parts:
                    w = view(p, i)
                    out[i, :, off:off + w.shape[0]].copy_(w.t())
                    off += w.shape[0]
            layers[out_key] = out
            log.debug("loaded fused weight group %s", out_key)
    else:
        for key in CKPT_LAYER_NAMES:
            if key not in layers:
                layers[key] = stacked(key)
                log.debug("loaded weight group %s", key)

    # tied output head (Llama-3.2 1B/3B): reuse the embedding matrix
    head = tensors.get("output.weight", tensors["tok_embeddings.weight"])
    if quant is not None:
        output = quantized({f: t.to(dev) for f, t in _host_quantize(head, quant).items()})
    elif fused:
        output = head.t().to(dev, dtype).contiguous()     # head stored [dim, vocab]
    else:
        output = head.to(dev, dtype).contiguous()
    cos, sin = rope_tables(cfg, dev)
    return LlamaParams(
        tok_embeddings=tensors["tok_embeddings.weight"].to(dev, dtype),
        layers=layers,
        norm=tensors["norm.weight"].to(dev, dtype),
        output=output,
        rope_cos=cos,
        rope_sin=sin,
    )


@dataclass
class LoadedModel:
    """Everything the engine needs."""

    params: Optional[LlamaParams]
    cfg: ModelArgs
    vocab: Vocabulary
    mergeable_ranks: Dict[bytes, int]
    tensor_meta: Dict[str, Tuple[Tuple[int, ...], str]]  # name -> (shape, dtype)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """PyTorch's own ingest: memory-mapped, restricted unpickler."""
    return torch.load(path, mmap=True, weights_only=True, map_location="cpu")


def load_llama_model(model_dir: str, max_sequence_length: Optional[int] = None,
                     include_tensors: bool = True, fused: bool = False,
                     device=None, quant: Optional[str] = None) -> LoadedModel:
    """Load a Meta-format model dir: consolidated.00.pth + params.json +
    tokenizer.model, with the vocab-size cross-check. ``quant`` as for
    :func:`build_params_from_checkpoint`."""
    log = get_logger()
    dev = resolve_device(device)
    tk_model = load_tiktoken_model(os.path.join(model_dir, "tokenizer.model"))
    vocab = Vocabulary.from_tiktoken(tk_model)

    cfg = load_model_args(os.path.join(model_dir, "params.json"), max_sequence_length)
    if cfg.vocab_size in (-1, 0):
        cfg = cfg.with_(vocab_size=vocab.size)
    elif cfg.vocab_size != vocab.size:
        raise CheckpointShapeError(
            f"params.json vocab_size {cfg.vocab_size} != tokenizer vocab {vocab.size}")

    params = None
    tensor_meta: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    if include_tensors:
        shards = glob.glob(os.path.join(model_dir, "consolidated.*.pth"))
        if len(shards) > 1:
            raise NotImplementedError(
                f"{len(shards)} checkpoint shards: Meta's multi-shard format "
                "is a later item of ROADMAP.md")
        log.info("Loading checkpoint %s ...", model_dir)
        tensors = load_torch_checkpoint(os.path.join(model_dir, "consolidated.00.pth"))
        tensor_meta = {n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                       for n, t in tensors.items()}
        params = build_params_from_checkpoint(tensors, cfg, fused=fused, device=dev,
                                              quant=quant)
        log.info("Loaded %d tensors.", len(tensors))
    return LoadedModel(params=params, cfg=cfg, vocab=vocab,
                       mergeable_ranks=tk_model.mergeable_ranks,
                       tensor_meta=tensor_meta)
