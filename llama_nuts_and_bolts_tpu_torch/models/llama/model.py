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
    (``ops.quantize_kv_rows``), quantized once as it is written;
  * cache slot ``t`` is visible to query row ``s`` iff ``t <= start_pos + s``;
    ``start_pos`` may be an int32 ``[B]`` tensor, every batch row at its own
    position (continuous batching): RoPE rows gathered per row, a per-row
    mask, and the cache written at per-row offsets, in place;
  * bf16 activations, fp32 accumulation, fp32 norm statistics and softmax,
    fp32 logits;
  * :func:`decoder_block` is the port's one transformer layer: what a cache
    decides -- where a layer's new K/V rows go and which attention reads
    them -- is the forward's attention object, ``BlockInputs.attend``
    (:class:`_DenseAttention` here, the paged pool's in ``paged.py``), and
    :func:`run_blocks` the one loop over the layers.

``attn_impl="plain"`` (the JAX ``"xla"`` path) runs ``ops.gqa_attention``
with the additive mask, on the dequantized layer for an int8 cache.
``"flash"`` runs K1 for S>1 and, for S==1, K2 on a bf16 cache and K4's
int8-dot mode on an int8 cache; ``"flash_folded"`` (S==1 only) runs K4 on
either cache (``kernels/``). An int8 cache takes ``"flash"`` for decode
only: its prefill runs the plain path. ``"ring"`` is the sequence-parallel
prefill (a mesh and S > 1): ring attention over the current segment only
(``parallel/ring_attention.py``), on the bf16 K/V rows before the cache
quantizes them; the rows still land in the cache for the decode steps that
follow.

Under a ``(dp, sp, tp)`` ``mesh`` (``parallel/``) the params and the cache
are this rank's shards (``parallel/sharding.py``):

  * tp: the heads, KV heads and FFN width are the local ones, the kernels
    run on the local heads (``parallel/kernel_shard.py``), and each block
    runs one all-reduce after ``wo`` and one after ``w_down``. A rank's
    partial products are summed in fp32 and cast to bf16 once (at tp = 1 the
    one term is the product itself, so it is rounded as without a mesh). The
    vocab-sharded head's fp32 logits are all-gathered, so every rank of the
    tp group holds the whole row. A leaf that ``_fit_spec`` replicated (an
    int4 weight of fewer groups than ranks) takes the whole input instead:
    its input is all-gathered first and its product needs no sum;
  * dp: ``tokens``, ``start_pos`` (a ``[B]`` one) and the cache hold the
    rank's batch rows, and the logits returned are its rows (the block JAX's
    global array holds on that device; ``parallel.mesh.gather_rows`` joins
    them). No collective runs on dp;
  * sp: without ``seq_parallel`` every sp rank runs the same whole call.
    With ``seq_parallel=True`` (and always under ``"ring"``) ``tokens`` are
    the rank's ``S/sp`` rows of the prompt (``parallel.sharding.shard_tokens``),
    at global positions ``start_pos + sp_rank * S/sp + i``: each layer
    all-gathers the new K/V rows over sp and writes all S into the rank's
    cache (so every sp rank's cache is the same, byte for byte), and the
    rank's query rows attend from their own global start (the plain mask,
    K1, or the ring). Every sp rank ends with the same fp32 logits: the row
    ``logits_at`` (its hidden row broadcast from the rank that holds it), or
    all S rows (the hidden rows gathered in rank order).

The fused layout is single-device, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

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
    attention_mask_per_row,
    dequantize_kv_rows,
    gqa_attention,
    linear,
    linear_t,
    quantize_kv_rows,
    rms_norm,
    swiglu_act,
)
from llama_nuts_and_bolts_tpu_torch.parallel.kernel_shard import (
    tp_flash_decode_attention,
    tp_flash_gqa_attention,
)
from llama_nuts_and_bolts_tpu_torch.parallel.mesh import (
    broadcast_from,
    dp_size,
    gather_last,
    gather_seq,
    reduce_partial,
    sp_rank,
    sp_size,
    tp_size,
)
from llama_nuts_and_bolts_tpu_torch.parallel.ring_attention import ring_gqa_attention
from llama_nuts_and_bolts_tpu_torch.parallel.sharding import check_split_layout, check_tp_shape

ATTN_IMPLS = ("plain", "flash", "flash_folded", "ring")


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
               device=None, dtype=torch.bfloat16, tp: int = 1) -> "KVCache":
        """A zeroed cache; ``tp`` > 1 makes one rank's shard, ``kv_heads /
        tp`` of them."""
        if dtype not in (torch.bfloat16, torch.int8):
            raise ValueError(f"the KV cache is bf16 or int8, got {dtype}")
        shape = (cfg.n_layers, batch, cfg.kv_heads // tp, max_seq, cfg.head_dim)
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


@dataclass
class BlockInputs:
    """What every decoder block of one forward shares: the rows' RoPE
    tables, the mesh, and ``attend(li, q, k, v)``, the forward's attention
    object, built once before the layers: it writes layer ``li``'s new K/V
    rows into its cache and returns the attention output ``[B, S, H, D]``.
    Building it is host work that reads nothing back from the card."""

    cfg: ModelArgs
    cos: torch.Tensor
    sin: torch.Tensor
    attend: Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    mesh: Any = None                    # (dp, sp, tp) DeviceMesh (parallel/)


@dataclass
class _DenseAttention:
    """The dense cache's attention for one forward: writes the new rows
    into ``cache`` at their positions, in place (quantized for an int8
    cache), then attends on the ring, K2 / K4, K1 or the plain path. Under a
    sequence-parallel prefill the rank's rows are all-gathered over sp
    first: ``S_all`` counts the prompt's rows, whose K/V every rank writes."""

    cache: KVCache
    start_pos: Any                      # int, or int32 [B] tensor
    q_start: Any                        # global position of the rank's first row
    S_all: int                          # the prompt's rows (S without seq_parallel)
    attn_impl: str
    mask: Optional[torch.Tensor]
    positions: Optional[torch.Tensor]   # int32 [B]: the decode kernels' rows
    rows_at: Optional[torch.Tensor]     # [B, S_all] write positions (per-row start_pos)
    batch_at: Optional[torch.Tensor]    # [B, 1] batch index (per-row start_pos)
    mesh: Any = None
    seq_parallel: bool = False          # tokens are the rank's S/sp prompt rows

    def __call__(self, li: int, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        cache, mesh = self.cache, self.mesh
        quantized = cache.quantized
        flash = self.attn_impl in ("flash", "flash_folded")
        k_new, v_new = k, v                 # this rank's rows
        if self.seq_parallel:
            k, v = gather_seq(k, mesh), gather_seq(v, mesh)      # [B, S_all, KV, D]
        if quantized:
            kq, ks = quantize_kv_rows(k)
            vq, vs = quantize_kv_rows(v)
            _write(cache.k, li, kq, self)
            _write(cache.v, li, vq, self)
            _write(cache.k_scale, li, ks, self)
            _write(cache.v_scale, li, vs, self)
        else:
            _write(cache.k, li, k, self)
            _write(cache.v, li, v, self)

        if self.attn_impl == "ring":
            # the current segment's bf16 rows, as they were before the cache
            # quantized them
            return ring_gqa_attention(mesh, q, k_new.transpose(1, 2).contiguous(),
                                      v_new.transpose(1, 2).contiguous(), self.start_pos)
        if flash and self.S_all == 1:
            fold = quantized or self.attn_impl == "flash_folded"
            kw = dict(k_scale=cache.k_scale, v_scale=cache.v_scale, layer=li,
                      fold_heads=fold, int8_mxu=quantized)
            if mesh is not None:
                return tp_flash_decode_attention(mesh, q, cache.k, cache.v, self.positions,
                                                 **kw)
            return flash_decode_attention(q, cache.k, cache.v, self.positions, **kw)
        if flash and mesh is not None:
            return tp_flash_gqa_attention(mesh, q, cache.k[li], cache.v[li], self.q_start)
        if flash:
            return flash_gqa_attention(q, cache.k[li], cache.v[li], self.start_pos)
        if quantized:
            # the plain path dequantizes the layer in bf16 before the einsum
            return gqa_attention(q, dequantize_kv_rows(cache.k[li], cache.k_scale[li]),
                                 dequantize_kv_rows(cache.v[li], cache.v_scale[li]),
                                 self.mask)
        return gqa_attention(q, cache.k[li], cache.v[li], self.mask)


def _check_shards(params: LlamaParams, cfg: ModelArgs, cache: KVCache, mesh,
                  batch: Optional[int] = None) -> None:
    """Under a mesh the params and the cache must be this rank's shards,
    and ``batch`` token rows (the rank's, on dp) those of the cache."""
    check_split_layout(params)
    tp = tp_size(mesh)
    check_tp_shape(cfg, tp)
    rows = params.layers["wq"].shape[-2]
    if rows != cfg.n_heads // tp * cfg.head_dim:
        raise ValueError(f"wq has {rows} rows, a tp={tp} shard has "
                         f"{cfg.n_heads // tp * cfg.head_dim}: shard the params "
                         "(parallel.shard_params) before a mesh forward")
    if cache.k.shape[2] != cfg.kv_heads // tp:
        raise ValueError(f"the cache holds {cache.k.shape[2]} KV heads, a tp={tp} "
                         f"shard {cfg.kv_heads // tp}")
    if batch is not None and cache.k.shape[1] != batch:
        raise ValueError(f"{batch} token rows over a cache of {cache.k.shape[1]}: under "
                         f"dp={dp_size(mesh)} the tokens and the cache are the rank's rows "
                         "(parallel.shard_tokens, parallel.shard_cache)")


def prepare_forward(params: LlamaParams, cfg: ModelArgs, tokens: torch.Tensor,
                    start_pos, cache: KVCache, attn_impl: str = "plain",
                    mesh=None, seq_parallel: bool = False) -> Tuple[torch.Tensor, BlockInputs]:
    """Check a forward's arguments, look up the token embeddings and build
    the :class:`BlockInputs` of its blocks, their attention the dense
    cache's: ``(x [B, S, dim] bf16, inputs)``."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    B, S = tokens.shape
    seq_parallel = seq_parallel or attn_impl == "ring"
    sp = sp_size(mesh) if seq_parallel else 1
    S_all = S * sp                      # the prompt's rows
    off = sp_rank(mesh) * S if seq_parallel else 0
    if attn_impl == "ring" and (mesh is None or S_all == 1):
        raise ValueError("attn_impl='ring' is the sequence-parallel PREFILL path: "
                         "needs a mesh with an sp axis and S > 1")
    if mesh is not None:
        _check_shards(params, cfg, cache, mesh, batch=B)
    T = cache.max_seq
    per_row = isinstance(start_pos, torch.Tensor)
    if per_row:
        if start_pos.dtype != torch.int32 or start_pos.shape != (B,):
            raise TypeError(f"a per-row start_pos is an int32 [B={B}] tensor, got "
                            f"{start_pos.dtype} {tuple(start_pos.shape)}")
        if attn_impl != "plain" and S_all != 1:
            raise ValueError("vector start_pos requires attn_impl='plain' (or "
                             "'flash'/'flash_folded' at S=1)")
        if start_pos.device.type == "cpu" and (
                int(start_pos.min()) < 0 or int(start_pos.max()) + S_all > T):
            raise ValueError(f"positions {start_pos.tolist()} + {S_all} exceed the cache "
                             f"length {T}")
    elif not isinstance(start_pos, int):
        raise TypeError("start_pos must be an int or an int32 [B] tensor")
    elif start_pos + S_all > T:
        raise ValueError(f"positions {start_pos}..{start_pos + S_all} exceed the "
                         f"cache length {T}")
    if attn_impl == "flash_folded" and S_all != 1:
        raise ValueError("attn_impl='flash_folded' is the folded-heads DECODE "
                         "kernel (S=1); use 'flash' for prefill")
    if cache.quantized and attn_impl == "flash" and S_all != 1:
        raise ValueError("int8 KV cache + flash is decode-only (S=1); use "
                         "attn_impl='plain' for prefill")
    flash = attn_impl in ("flash", "flash_folded")
    masked = attn_impl == "plain"

    x = params.tok_embeddings[tokens.long()]                    # [B,S,dim] bf16
    dev = x.device
    rows_at = batch_at = None
    if per_row:
        start = start_pos.to(dev)
        # [B, S_all] write positions of every row; RoPE rows gathered per row
        rows_at = start.long()[:, None] + torch.arange(S_all, device=dev)
        mine = rows_at[:, off:off + S]
        cos, sin = params.rope_cos[mine], params.rope_sin[mine]
        q_start = start + off
        mask = attention_mask_per_row(S, T, q_start) if masked else None
        positions = start.contiguous()
        batch_at = torch.arange(B, device=dev)[:, None]
    else:
        q_start = start_pos + off
        cos = params.rope_cos[q_start:q_start + S]
        sin = params.rope_sin[q_start:q_start + S]
        mask = attention_mask(S, T, q_start, dev)[None] if masked else None
        positions = (torch.full((B,), start_pos, dtype=torch.int32, device=dev)
                     if flash and S_all == 1 else None)
    attend = _DenseAttention(cache=cache, start_pos=start_pos, q_start=q_start, S_all=S_all,
                             attn_impl=attn_impl, mask=mask, positions=positions,
                             rows_at=rows_at, batch_at=batch_at, mesh=mesh,
                             seq_parallel=seq_parallel and mesh is not None)
    return x, BlockInputs(cfg=cfg, cos=cos, sin=sin, attend=attend, mesh=mesh)


def layer_weights(params: LlamaParams, li: int) -> Dict[str, Any]:
    """Layer ``li``'s views of the stacked weights."""
    return {name: t[li] for name, t in params.layers.items()}


def _write(buf: torch.Tensor, li: int, rows: torch.Tensor, at: _DenseAttention) -> None:
    """``rows [B, S_all, KV(, D)]`` into ``buf [L, B, KV, T(, D)]`` at the
    rows' positions, in place: only the new rows are written."""
    if at.rows_at is not None:
        # the advanced indices (batch, position) are split by the KV slice,
        # so their [B, S] dims lead: the target is [B, S, KV(, D)] as rows
        buf[li][at.batch_at, :, at.rows_at] = rows.to(buf.dtype)
    else:
        buf[li, :, :, at.start_pos:at.start_pos + at.S_all] = rows.transpose(1, 2)


def _row_linear(x: torch.Tensor, w, mesh) -> torch.Tensor:
    """``linear(x, w)`` for a row-split weight (``wo``, ``w_down``): under a
    mesh, this rank's partial product summed over tp (see the module
    docstring)."""
    if mesh is None:
        return linear(x, w)
    if x.shape[-1] < w.shape[-1]:
        # a weight _fit_spec replicated takes the whole activation
        return linear(gather_last(x, mesh), w)
    partial = linear(x, w, out_dtype=torch.float32 if tp_size(mesh) > 1 else x.dtype)
    return reduce_partial(partial, mesh, x.dtype)


def decoder_block(w: Dict[str, Any], li: int, x: torch.Tensor,
                  inp: BlockInputs) -> torch.Tensor:
    """Transformer block ``li`` on ``x [B, S, dim]`` with layer weights ``w``
    (:func:`layer_weights`): attention (``inp.attend`` writes the new K/V
    rows into its cache in place and attends), then the SwiGLU
    feed-forward, each with its residual. Under ``inp.mesh`` the heads and
    FFN width are this rank's and each half ends in an all-reduce. It reads
    nothing back to the host, so a captured decode step runs it."""
    cfg, mesh = inp.cfg, inp.mesh
    B, S = x.shape[:2]
    tp = tp_size(mesh)
    H, KV, D = cfg.n_heads // tp, cfg.kv_heads // tp, cfg.head_dim
    fused = "wqkv" in w
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
    q = apply_rope(q, inp.cos, inp.sin)
    k = apply_rope(k, inp.cos, inp.sin)
    att = inp.attend(li, q, k, v)

    if fused:
        x = x + linear_t(att.reshape(B, S, H * D), w["wo"])
        h2 = rms_norm(x, w["ffn_norm"], cfg.norm_eps)
        gu = linear_t(h2, w["w_gate_up"])
        F_ = cfg.ffn_hidden_dim
        gate, up = gu[..., :F_], gu[..., F_:]
        act = F.silu(gate.float()).to(gu.dtype) * up
        return x + linear_t(act, w["w_down"])
    x = x + _row_linear(att.reshape(B, S, H * D), w["wo"], mesh)
    h2 = rms_norm(x, w["ffn_norm"], cfg.norm_eps)
    act = swiglu_act(h2, w["w_gate"], w["w_up"])
    return x + _row_linear(act, w["w_down"], mesh)


def run_blocks(params: LlamaParams, x: torch.Tensor, inp: BlockInputs) -> torch.Tensor:
    """Every layer's :func:`decoder_block` in turn on ``x [B, S, dim]``:
    the layer loop of ``forward`` and of the paged functions."""
    for li in range(inp.cfg.n_layers):
        x = decoder_block(layer_weights(params, li), li, x, inp)
    return x


def output_head(params: LlamaParams, cfg: ModelArgs, x: torch.Tensor,
                logits_at: Optional[int] = None, mesh=None,
                seq_parallel: bool = False) -> torch.Tensor:
    """The final norm and the LM head: fp32 logits ``[B, S, vocab]``
    (``[B, 1, vocab]`` when ``logits_at`` picks one row). Under a mesh the
    head is vocab-sharded and every rank gets the all-gathered logits. With
    ``seq_parallel`` ``x`` holds the rank's rows of the prompt, and
    ``logits_at`` is a global row: every sp rank gets the same logits."""
    if seq_parallel and sp_size(mesh) > 1:
        if logits_at is None:
            x = gather_seq(x, mesh)                             # [B,S_all,dim]
        else:
            owner, at = divmod(logits_at, x.shape[1])
            row = (x[:, at:at + 1].contiguous() if sp_rank(mesh) == owner
                   else x.new_empty((x.shape[0], 1, x.shape[2])))
            x, logits_at = broadcast_from(row, mesh, "sp", owner), None
    if logits_at is not None:
        x = x[:, logits_at:logits_at + 1]                       # [B,1,dim]
    x = rms_norm(x, params.norm, cfg.norm_eps)
    if "wqkv" in params.layers:   # the fused layout stores the head as [dim, vocab]
        return linear_t(x, params.output, out_dtype=torch.float32)
    logits = linear(x, params.output, out_dtype=torch.float32)
    if mesh is not None and (tp_size(mesh) == 1 or logits.shape[-1] < cfg.vocab_size):
        # (a head _fit_spec replicated at tp > 1 already holds every row)
        logits = gather_last(logits, mesh)
    return logits


def forward(
    params: LlamaParams,
    cfg: ModelArgs,
    tokens: torch.Tensor,          # int [B, S] on the weights' device
    start_pos,                     # int, or int32 [B] tensor (one position per row)
    cache: KVCache,
    attn_impl: str = "plain",
    logits_at: Optional[int] = None,
    mesh=None,                     # (dp, sp, tp) DeviceMesh: params/cache are shards
    seq_parallel: bool = False,    # tokens are this rank's S/sp prompt rows
) -> Tuple[torch.Tensor, KVCache]:
    """One forward pass (prefill when S>1, decode step when S==1).

    Returns fp32 logits ``[B, S, vocab]`` (``[B, 1, vocab]`` when
    ``logits_at`` picks one row; S is the prompt's under ``seq_parallel``)
    and ``cache``, written in place. A ``[B]``
    ``start_pos`` runs on the plain path at any S and on the decode kernels
    at S=1, as in the JAX package; its rows' positions plus S must fit the
    cache (checked for CPU tensors; the batchers keep them in range).
    ``runtime/profiling.py::narrated_forward`` runs the same three parts,
    a layer at a time. Under ``mesh`` see the module docstring."""
    x, inp = prepare_forward(params, cfg, tokens, start_pos, cache, attn_impl, mesh,
                             seq_parallel)
    x = run_blocks(params, x, inp)
    return output_head(params, cfg, x, logits_at, mesh, inp.attend.seq_parallel), cache


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
