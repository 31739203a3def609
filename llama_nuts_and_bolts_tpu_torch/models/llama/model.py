"""Llama transformer forward pass over stacked per-layer weights.

Port of ``llama_nuts_and_bolts_tpu/models/llama/model.py``:

  * per-layer weights are stacked to ``[n_layers, ...]`` as in the JAX
    package, and the block loop is a Python loop over layer views; weights
    may be bf16, int8 ``QTensor`` or int4 ``Q4Tensor`` (``quant/``), whose
    layer views ``ops.linear`` takes as they are;
  * the KV cache is written IN PLACE (``cache.k[li, :, :, p:p+S] = k``): this
    takes the place of the JAX package's donated scan carry, so a step's
    cache traffic is the S new rows, never a copy of the buffer;
  * the cache is bf16, or int8 with a bf16 scale per (position, head)
    (``quantize_kv_rows``), quantized once as it is written;
  * cache slot ``t`` is visible to query row ``s`` iff ``t <= start_pos + s``;
    ``start_pos`` may be an int32 ``[B]`` tensor, every batch row at its own
    position (continuous batching): RoPE rows gathered per row, a per-row
    mask, and the cache written at per-row offsets, in place;
  * bf16 activations, fp32 accumulation, fp32 norm statistics and softmax,
    fp32 logits.

``attn_impl="plain"`` (the JAX ``"xla"`` path) runs ``ops.gqa_attention``
with the additive mask, on the dequantized layer for an int8 cache.
``"flash"`` runs K1 for S>1 and, for S==1, K2 on a bf16 cache and K4's
int8-dot mode on an int8 cache; ``"flash_folded"`` (S==1 only) runs K4 on
either cache (``kernels/``). An int8 cache takes ``"flash"`` for decode
only: its prefill runs the plain path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from llama_nuts_and_bolts_tpu_torch.device import exact_div, resolve_device
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
    attention_mask_per_row,
    gqa_attention,
    linear,
    linear_t,
    rms_norm,
    swiglu,
)

ATTN_IMPLS = ("plain", "flash", "flash_folded")


@dataclass
class LlamaParams:
    """Weights. ``layers`` holds tensors stacked to ``[n_layers, ...]``;
    ``rope_cos/rope_sin`` are the fp32 tables on the weights' device."""

    tok_embeddings: torch.Tensor        # [vocab, dim] bf16
    layers: Dict[str, Any]              # each [L, ...] bf16, QTensor or Q4Tensor
    norm: torch.Tensor                  # [dim] bf16
    output: Any                         # [vocab, dim] ([dim, vocab] fused)
    rope_cos: torch.Tensor              # [2*max_seq, head_dim//2] fp32
    rope_sin: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.tok_embeddings.device


@dataclass
class KVCache:
    """Preallocated cache, k/v of shape [n_layers, batch, kv_heads, max_seq,
    head_dim] (kv-heads-major, as the kernels stream it). ``dtype=torch.int8``
    stores rows quantized per (position, head) with bf16 scales
    ``k_scale/v_scale`` [n_layers, batch, kv_heads, max_seq]."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None     # bf16 iff k is int8
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: ModelArgs, batch: int, max_seq: int,
               device=None, dtype=torch.bfloat16) -> "KVCache":
        if dtype not in (torch.bfloat16, torch.int8):
            raise ValueError(f"the KV cache is bf16 or int8, got {dtype}")
        shape = (cfg.n_layers, batch, cfg.kv_heads, max_seq, cfg.head_dim)
        dev = resolve_device(device)
        cache = cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                    v=torch.zeros(shape, dtype=dtype, device=dev))
        if dtype == torch.int8:
            cache.k_scale = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev)
            cache.v_scale = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev)
        return cache

    def truncated(self, max_seq: int) -> "KVCache":
        """An independent copy of the first ``max_seq`` positions (a full
        copy when the buffer is no longer): a prefix-cache snapshot stays
        unchanged while the copy is written in place."""
        max_seq = min(max_seq, self.max_seq)
        cut = lambda t: None if t is None else t[..., :max_seq].clone()  # noqa: E731
        return KVCache(k=self.k[:, :, :, :max_seq].clone(),
                       v=self.v[:, :, :, :max_seq].clone(),
                       k_scale=cut(self.k_scale), v_scale=cut(self.v_scale))

    def load_(self, src: "KVCache") -> "KVCache":
        """Copy ``src``'s first positions into this buffer, in place, as
        many as both hold: a prefix-cache snapshot seeds a decode graph's
        cache, whose address the graph keeps."""
        n = min(self.max_seq, src.max_seq)
        for dst, s in ((self.k, src.k), (self.v, src.v), (self.k_scale, src.k_scale),
                       (self.v_scale, src.v_scale)):
            if dst is not None:
                dst[:, :, :, :n].copy_(s[:, :, :, :n])
        return self

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8


def quantize_kv_rows(rows: torch.Tensor):
    """Per-(..., position) symmetric int8 over the head dim: (int8 rows,
    bf16 scales with the last axis dropped). Rows are divided by the fp32
    scale, which is stored rounded to bf16, as in the JAX package."""
    r32 = rows.float()
    s = exact_div(r32.abs().amax(dim=-1).clamp_min(1e-8), 127.0)
    q = torch.round(r32 / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def forward(
    params: LlamaParams,
    cfg: ModelArgs,
    tokens: torch.Tensor,          # int [B, S] on the weights' device
    start_pos,                     # int, or int32 [B] tensor (one position per row)
    cache: KVCache,
    attn_impl: str = "plain",
    logits_at: Optional[int] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One forward pass (prefill when S>1, decode step when S==1).

    Returns fp32 logits ``[B, S, vocab]`` (``[B, 1, vocab]`` when
    ``logits_at`` picks one row) and ``cache``, written in place. A ``[B]``
    ``start_pos`` runs on the plain path at any S and on the decode kernels
    at S=1, as in the JAX package; its rows' positions plus S must fit the
    cache (checked for CPU tensors; the batchers keep them in range)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    B, S = tokens.shape
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    T = cache.max_seq
    per_row = isinstance(start_pos, torch.Tensor)
    if per_row:
        if start_pos.dtype != torch.int32 or start_pos.shape != (B,):
            raise TypeError(f"a per-row start_pos is an int32 [B={B}] tensor, got "
                            f"{start_pos.dtype} {tuple(start_pos.shape)}")
        if attn_impl != "plain" and S != 1:
            raise ValueError("vector start_pos requires attn_impl='plain' (or "
                             "'flash'/'flash_folded' at S=1)")
        if start_pos.device.type == "cpu" and (
                int(start_pos.min()) < 0 or int(start_pos.max()) + S > T):
            raise ValueError(f"positions {start_pos.tolist()} + {S} exceed the cache "
                             f"length {T}")
    elif not isinstance(start_pos, int):
        raise TypeError("start_pos must be an int or an int32 [B] tensor")
    elif start_pos + S > T:
        raise ValueError(f"positions {start_pos}..{start_pos + S} exceed the "
                         f"cache length {T}")
    if attn_impl == "flash_folded" and S != 1:
        raise ValueError("attn_impl='flash_folded' is the folded-heads DECODE "
                         "kernel (S=1); use 'flash' for prefill")
    quantized = cache.quantized
    if quantized and attn_impl == "flash" and S != 1:
        raise ValueError("int8 KV cache + flash is decode-only (S=1); use "
                         "attn_impl='plain' for prefill")
    fold = quantized or attn_impl == "flash_folded"
    fused = "wqkv" in params.layers
    flash = attn_impl in ("flash", "flash_folded")

    x = params.tok_embeddings[tokens.long()]                    # [B,S,dim] bf16
    dev = x.device
    if per_row:
        # [B, S] write/attend positions of every row; RoPE rows gathered per row
        rows_at = start_pos.to(dev).long()[:, None] + torch.arange(S, device=dev)
        cos, sin = params.rope_cos[rows_at], params.rope_sin[rows_at]
        mask = None if flash else attention_mask_per_row(S, T, start_pos.to(dev))
        positions = start_pos.to(dev).contiguous()
        batch_at = torch.arange(B, device=dev)[:, None]
    else:
        cos = params.rope_cos[start_pos:start_pos + S]
        sin = params.rope_sin[start_pos:start_pos + S]
        mask = None if flash else attention_mask(S, T, start_pos, dev)[None]
        positions = (torch.full((B,), start_pos, dtype=torch.int32, device=dev)
                     if flash and S == 1 else None)

    def write(buf: torch.Tensor, li: int, rows: torch.Tensor) -> None:
        """``rows [B, S, KV(, D)]`` into ``buf [L, B, KV, T(, D)]`` at the
        rows' positions, in place: only the S new rows are written."""
        if per_row:
            # the advanced indices (batch, position) are split by the KV slice,
            # so their [B, S] dims lead: the target is [B, S, KV(, D)] as rows
            buf[li][batch_at, :, rows_at] = rows.to(buf.dtype)
        else:
            buf[li, :, :, start_pos:start_pos + S] = rows.transpose(1, 2)

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
        if quantized:
            kq, ks = quantize_kv_rows(k)
            vq, vs = quantize_kv_rows(v)
            write(cache.k, li, kq)
            write(cache.v, li, vq)
            write(cache.k_scale, li, ks)
            write(cache.v_scale, li, vs)
        else:
            write(cache.k, li, k)
            write(cache.v, li, v)

        if flash and S == 1:
            att = flash_decode_attention(q, cache.k, cache.v, positions,
                                         k_scale=cache.k_scale, v_scale=cache.v_scale,
                                         layer=li, fold_heads=fold, int8_mxu=quantized)
        elif flash:
            att = flash_gqa_attention(q, cache.k[li], cache.v[li], start_pos)
        elif quantized:
            # the plain path dequantizes the layer in bf16 before the einsum
            ck = cache.k[li].to(torch.bfloat16) * cache.k_scale[li][..., None]
            cv = cache.v[li].to(torch.bfloat16) * cache.v_scale[li][..., None]
            att = gqa_attention(q, ck, cv, mask)
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
    if any(hasattr(w, "q") or hasattr(w, "packed") for w in lw.values()):
        raise ValueError("fuse_decode_params supports plain (bf16) weights only")
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
