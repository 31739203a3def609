"""Llama transformer forward pass over stacked per-layer weights.

Port of ``llama_nuts_and_bolts_tpu/models/llama/model.py`` for bf16 weights,
a bf16 KV cache and a scalar ``start_pos``:

  * per-layer weights are stacked to ``[n_layers, ...]`` as in the JAX
    package, and the block loop is a Python loop over layer views;
  * the KV cache is written IN PLACE (``cache.k[li, :, :, p:p+S] = k``): this
    takes the place of the JAX package's donated scan carry, so a step's
    cache traffic is the S new rows, never a copy of the buffer;
  * cache slot ``t`` is visible to query row ``s`` iff ``t <= start_pos + s``;
  * bf16 weights and activations, fp32 accumulation, fp32 norm statistics
    and softmax, fp32 logits.

``attn_impl="plain"`` (the JAX ``"xla"`` path) runs ``ops.gqa_attention``
with the additive mask; ``"flash"`` runs K1 for S>1 and K2 for S==1
(``kernels/``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from llama_nuts_and_bolts_tpu_torch.device import resolve_device
from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.kernels.attention import flash_gqa_attention
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
    flash_decode_attention,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.rope import (
    apply_rope,
    precompute_rope_tables,
)
from llama_nuts_and_bolts_tpu_torch.ops import (
    attention_mask,
    gqa_attention,
    linear,
    linear_t,
    rms_norm,
    swiglu,
)

ATTN_IMPLS = ("plain", "flash")


@dataclass
class LlamaParams:
    """Weights. ``layers`` holds tensors stacked to ``[n_layers, ...]``;
    ``rope_cos/rope_sin`` are the fp32 tables on the weights' device."""

    tok_embeddings: torch.Tensor        # [vocab, dim] bf16
    layers: Dict[str, torch.Tensor]     # each [L, ...] bf16
    norm: torch.Tensor                  # [dim] bf16
    output: torch.Tensor                # [vocab, dim] bf16 ([dim, vocab] fused)
    rope_cos: torch.Tensor              # [2*max_seq, head_dim//2] fp32
    rope_sin: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.tok_embeddings.device


@dataclass
class KVCache:
    """Preallocated bf16 cache, k/v of shape [n_layers, batch, kv_heads,
    max_seq, head_dim] (kv-heads-major, as the kernels stream it)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: ModelArgs, batch: int, max_seq: int,
               device=None, dtype=torch.bfloat16) -> "KVCache":
        if dtype != torch.bfloat16:
            raise NotImplementedError(
                "only the bf16 KV cache is ported; the int8 cache is a later "
                "item of ROADMAP.md")
        shape = (cfg.n_layers, batch, cfg.kv_heads, max_seq, cfg.head_dim)
        dev = resolve_device(device)
        return cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))

    def truncated(self, max_seq: int) -> "KVCache":
        """An independent copy of the first ``max_seq`` positions (a full
        copy when the buffer is no longer): a prefix-cache snapshot stays
        unchanged while the copy is written in place."""
        max_seq = min(max_seq, self.max_seq)
        return KVCache(k=self.k[:, :, :, :max_seq].clone(),
                       v=self.v[:, :, :, :max_seq].clone())

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]


def forward(
    params: LlamaParams,
    cfg: ModelArgs,
    tokens: torch.Tensor,          # int [B, S] on the weights' device
    start_pos: int,
    cache: KVCache,
    attn_impl: str = "plain",
    logits_at: Optional[int] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One forward pass (prefill when S>1, decode step when S==1).

    Returns fp32 logits ``[B, S, vocab]`` (``[B, 1, vocab]`` when
    ``logits_at`` picks one row) and ``cache``, written in place."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    if not isinstance(start_pos, int):
        raise TypeError("start_pos must be an int (per-row positions come with "
                        "continuous batching, a later slice)")
    B, S = tokens.shape
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    T = cache.max_seq
    if start_pos + S > T:
        raise ValueError(f"positions {start_pos}..{start_pos + S} exceed the "
                         f"cache length {T}")
    fused = "wqkv" in params.layers
    flash = attn_impl == "flash"

    x = params.tok_embeddings[tokens.long()]                    # [B,S,dim] bf16
    cos = params.rope_cos[start_pos:start_pos + S]
    sin = params.rope_sin[start_pos:start_pos + S]
    mask = None if flash else attention_mask(S, T, start_pos, x.device)[None]
    positions = (torch.full((B,), start_pos, dtype=torch.int32, device=x.device)
                 if flash and S == 1 else None)

    for li in range(cfg.n_layers):
        w = {name: t[li] for name, t in params.layers.items()}
        h = rms_norm(x, w["attn_norm"], cfg.norm_eps)
        if fused:
            qkv = linear_t(h, w["wqkv"])
            q = qkv[..., : H * D].reshape(B, S, H, D)
            k = qkv[..., H * D:(H + KV) * D].reshape(B, S, KV, D)
            v = qkv[..., (H + KV) * D:].reshape(B, S, KV, D)
        else:
            q = linear(h, w["wq"]).reshape(B, S, H, D)
            k = linear(h, w["wk"]).reshape(B, S, KV, D)
            v = linear(h, w["wv"]).reshape(B, S, KV, D)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # in place: only the S new rows of this layer are written
        cache.k[li, :, :, start_pos:start_pos + S] = k.transpose(1, 2)
        cache.v[li, :, :, start_pos:start_pos + S] = v.transpose(1, 2)

        if flash and S == 1:
            att = flash_decode_attention(q, cache.k, cache.v, positions, layer=li)
        elif flash:
            att = flash_gqa_attention(q, cache.k[li], cache.v[li], start_pos)
        else:
            att = gqa_attention(q, cache.k[li], cache.v[li], mask)

        if fused:
            x = x + linear_t(att.reshape(B, S, H * D), w["wo"])
            h2 = rms_norm(x, w["ffn_norm"], cfg.norm_eps)
            gu = linear_t(h2, w["w_gate_up"])
            F_ = cfg.ffn_hidden_dim
            gate, up = gu[..., :F_], gu[..., F_:]
            act = F.silu(gate.float()).to(gu.dtype) * up
            x = x + linear_t(act, w["w_down"])
        else:
            x = x + linear(att.reshape(B, S, H * D), w["wo"])
            h2 = rms_norm(x, w["ffn_norm"], cfg.norm_eps)
            x = x + swiglu(h2, w["w_gate"], w["w_up"], w["w_down"])

    if logits_at is not None:
        x = x[:, logits_at:logits_at + 1]                       # [B,1,dim]
    x = rms_norm(x, params.norm, cfg.norm_eps)
    if fused:   # the fused layout stores the head as [dim, vocab]
        logits = linear_t(x, params.output, out_dtype=torch.float32)
    else:
        logits = linear(x, params.output, out_dtype=torch.float32)
    return logits, cache


# --------------------------------------------------------------------------
# weight layout spec shared by the loader and random init


def layer_weight_shapes(cfg: ModelArgs) -> Dict[str, Tuple[int, ...]]:
    d, f = cfg.dim, cfg.ffn_hidden_dim
    return {
        "attn_norm": (d,),
        "ffn_norm": (d,),
        "wq": (cfg.n_heads * cfg.head_dim, d),
        "wk": (cfg.kv_heads * cfg.head_dim, d),
        "wv": (cfg.kv_heads * cfg.head_dim, d),
        "wo": (d, cfg.n_heads * cfg.head_dim),
        "w_gate": (f, d),
        "w_up": (f, d),
        "w_down": (d, f),
    }


def fused_layer_weight_shapes(cfg: ModelArgs) -> Dict[str, Tuple[int, ...]]:
    """Fused decode layout: qkv and gate+up concatenated along the OUT dim,
    every matmul weight stored transposed ``[in, out]``."""
    d, f = cfg.dim, cfg.ffn_hidden_dim
    qkv_out = (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim
    return {
        "attn_norm": (d,),
        "ffn_norm": (d,),
        "wqkv": (d, qkv_out),
        "wo": (cfg.n_heads * cfg.head_dim, d),
        "w_gate_up": (d, 2 * f),
        "w_down": (f, d),
    }


def fuse_decode_params(params: LlamaParams) -> LlamaParams:
    """Repack checkpoint-layout params into the fused decode layout."""
    lw = params.layers
    if "wqkv" in lw:
        return params
    t = lambda a: a.transpose(1, 2).contiguous()  # noqa: E731
    layers = {
        "attn_norm": lw["attn_norm"],
        "ffn_norm": lw["ffn_norm"],
        "wqkv": t(torch.cat([lw["wq"], lw["wk"], lw["wv"]], dim=1)),
        "wo": t(lw["wo"]),
        "w_gate_up": t(torch.cat([lw["w_gate"], lw["w_up"]], dim=1)),
        "w_down": t(lw["w_down"]),
    }
    return LlamaParams(tok_embeddings=params.tok_embeddings, layers=layers,
                       norm=params.norm, output=params.output.t().contiguous(),
                       rope_cos=params.rope_cos, rope_sin=params.rope_sin)


def rope_tables(cfg: ModelArgs, device: torch.device):
    cos, sin = precompute_rope_tables(
        cfg.head_dim, 2 * cfg.max_sequence_length, cfg.rope_theta,
        cfg.use_scaled_rope, cfg.rope_scale_factor, cfg.rope_high_freq_factor)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def init_random_params(cfg: ModelArgs, seed: int = 0, device=None,
                       dtype=torch.bfloat16, fused: bool = False) -> LlamaParams:
    """Random params with the checkpoint's shapes, from a seeded
    ``torch.Generator`` on ``device`` (default ``cuda``). Each layer is drawn
    in fp32 and cast into the bf16 stack, so the fp32 scratch is one layer's
    weight, never a whole stack. ``fused=True`` draws the fused layout."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = 1.0 / math.sqrt(cfg.dim)

    def rand(shape):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    L = cfg.n_layers
    shapes = fused_layer_weight_shapes(cfg) if fused else layer_weight_shapes(cfg)
    layers = {}
    for name, shape in shapes.items():
        if name.endswith("norm"):
            layers[name] = torch.ones((L,) + shape, dtype=dtype, device=dev)
            continue
        stack = torch.empty((L,) + shape, dtype=dtype, device=dev)
        for li in range(L):
            stack[li] = rand(shape)
        layers[name] = stack
    cos, sin = rope_tables(cfg, dev)
    out_shape = (cfg.dim, cfg.vocab_size) if fused else (cfg.vocab_size, cfg.dim)
    return LlamaParams(
        tok_embeddings=rand((cfg.vocab_size, cfg.dim)),
        layers=layers,
        norm=torch.ones((cfg.dim,), dtype=dtype, device=dev),
        output=rand(out_shape),
        rope_cos=cos,
        rope_sin=sin,
    )
