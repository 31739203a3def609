"""Checkpoint → device params: name/shape validation, stacking, placement.

Port of ``llama_nuts_and_bolts_tpu/models/llama/loader.py``. The checkpoint
is read with PyTorch's own ingest, ``torch.load(path, mmap=True,
weights_only=True, map_location="cpu")``: the tensors stay memory-mapped, and
each layer's view is copied straight into its slot of the stacked
``[L, ...]`` tensor on the device, so no whole weight group is ever copied on
the host. ``quant="int8"`` / ``"int4"`` quantizes each layer's view on the
host (``quant/``) before it goes to the device, output head included, so the
card only ever holds the quantized bytes; they are the bytes the JAX
package's loader makes. Meta's multi-shard format (``consolidated.00.pth`` ..
``NN.pth``) is read through ``io/shards.py``: each combined tensor is
concatenated on the host when its layer is copied, one tensor at a time.

``sharding_fn`` (``parallel.param_sharding_fn``) loads one tensor-parallel
rank: each layer's view (quantized first, when asked) is cut to the rank's
slice on the host before it is copied, so a card never holds more than its
shard; the bytes are ``parallel.shard_params`` of the whole load.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from llama_nuts_and_bolts_tpu_torch.device import resolve_device
from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs, load_model_args
from llama_nuts_and_bolts_tpu_torch.io.shards import (
    ShardedTensor,
    find_checkpoint_shards,
    load_sharded_checkpoint,
)
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


# a checkpoint tensor: one file's, or one combined from Meta's shards
CheckpointTensor = Union[torch.Tensor, ShardedTensor]
# weight key -> the function cutting a rank's slice of one layer, or None
ShardingFn = Callable[[str], Optional[Callable[[Any], Any]]]


def _read(t: CheckpointTensor) -> torch.Tensor:
    """A checkpoint tensor's values (shards are concatenated here)."""
    return t.materialize() if isinstance(t, ShardedTensor) else t


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


def validate_checkpoint(tensors: Dict[str, CheckpointTensor], cfg: ModelArgs) -> None:
    """Every expected tensor is present, at its shape (a sharded tensor's
    combined shape)."""
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


def build_params_from_checkpoint(tensors: Dict[str, CheckpointTensor],
                                 cfg: ModelArgs, fused: bool = False,
                                 device=None, dtype=torch.bfloat16,
                                 quant: Optional[str] = None,
                                 sharding_fn: Optional[ShardingFn] = None) -> LlamaParams:
    """Stack per-layer checkpoint tensors to ``[L, ...]`` on ``device``
    (default ``cuda``). ``fused=True`` assembles the fused decode layout
    (``model.fused_layer_weight_shapes``) from the same views;
    ``quant="int8"|"int4"`` quantizes the matmul weights and the head.
    ``tensors`` may be sharded (:func:`load_sharded_checkpoint`): each
    tensor is then combined when it is read. ``sharding_fn`` loads one
    tensor-parallel rank's slices (module docstring)."""
    if quant not in (None, "int8", "int4"):
        raise ValueError(f"unsupported quant mode {quant!r}")
    if fused and (quant is not None or sharding_fn is not None):
        raise ValueError("the fused decode layout is for plain single-device bf16 "
                         "weights (quantized layouts keep their own packing; "
                         "tensor parallelism keeps the split weights)")
    validate_checkpoint(tensors, cfg)
    dev = resolve_device(device)
    log = get_logger()
    L = cfg.n_layers

    def cut(key: str, leaf):
        """This rank's slice of ``leaf`` (all of it without a sharding_fn)."""
        fn = sharding_fn(key) if sharding_fn is not None else None
        return leaf if fn is None else fn(leaf)

    def view(key: str, i: int) -> torch.Tensor:
        return _read(tensors[CKPT_LAYER_NAMES[key].format(i=i)])

    def stacked(key: str):
        if quant is not None and not key.endswith("norm"):
            return stacked_quantized(key)
        out = None
        for i in range(L):
            part = cut(key, view(key, i))
            if out is None:
                out = torch.empty((L,) + tuple(part.shape), dtype=dtype, device=dev)
            out[i].copy_(part)
        return out

    def quantized(fields):
        from llama_nuts_and_bolts_tpu_torch.quant import Q4Tensor, QTensor

        return (Q4Tensor if "packed" in fields else QTensor)(**fields)

    def host_quantized(key: str, host: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``host`` quantized whole, then cut: the fields of this rank's slice."""
        leaf = cut(key, quantized(_host_quantize(host, quant)))
        return {f: getattr(leaf, f) for f in ("packed", "q", "scale") if hasattr(leaf, f)}

    def stacked_quantized(key: str):
        out = None
        for i in range(L):
            fields = host_quantized(key, view(key, i))
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
        def shape(key: str) -> Tuple[int, ...]:
            return tuple(tensors[CKPT_LAYER_NAMES[key].format(i=0)].shape)

        for out_key, parts in FUSED_GROUPS.items():
            d_in = shape(parts[0])[1]
            d_out = sum(shape(p)[0] for p in parts)
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
    embeddings = _read(tensors["tok_embeddings.weight"])
    head = _read(tensors["output.weight"]) if "output.weight" in tensors else embeddings
    if quant is not None:
        output = quantized({f: t.to(dev).contiguous()
                            for f, t in host_quantized("output", head).items()})
    elif fused:
        output = head.t().to(dev, dtype).contiguous()     # head stored [dim, vocab]
    else:
        output = cut("output", head).to(dev, dtype).contiguous()
    cos, sin = rope_tables(cfg, dev)
    return LlamaParams(
        tok_embeddings=cut("tok_embeddings", embeddings).to(dev, dtype),
        layers=layers,
        norm=cut("norm", _read(tensors["norm.weight"])).to(dev, dtype),
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
                     device=None, quant: Optional[str] = None,
                     sharding_fn: Optional[ShardingFn] = None) -> LoadedModel:
    """Load a Meta-format model dir: consolidated.00.pth (or Meta's shards
    consolidated.00..NN.pth) + params.json + tokenizer.model, with the
    vocab-size cross-check. ``quant`` and ``sharding_fn`` as for
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
        log.info("Loading checkpoint %s ...", model_dir)
        shards = find_checkpoint_shards(model_dir)
        if len(shards) > 1:
            # Meta's model-parallel multi-file format (70B ships 8 shards)
            log.info("Found %d checkpoint shards.", len(shards))
            tensors = load_sharded_checkpoint(shards)
        else:
            tensors = load_torch_checkpoint(os.path.join(model_dir, "consolidated.00.pth"))
        tensor_meta = {n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                       for n, t in tensors.items()}
        params = build_params_from_checkpoint(tensors, cfg, fused=fused, device=dev,
                                              quant=quant, sharding_fn=sharding_fn)
        log.info("Loaded %d tensors.", len(tensors))
    return LoadedModel(params=params, cfg=cfg, vocab=vocab,
                       mergeable_ranks=tk_model.mergeable_ranks,
                       tensor_meta=tensor_meta)
