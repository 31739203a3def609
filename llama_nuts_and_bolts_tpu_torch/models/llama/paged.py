"""Paged KV cache: a shared block pool + per-request block tables.

Port of ``llama_nuts_and_bolts_tpu/models/llama/paged.py``. The cache is a POOL of fixed-size
blocks shared by every request; a request holds ``ceil(len / bs)`` blocks
and releases them on completion, so device memory tracks live tokens, not
slots x context.

  * The pool is ``[L, n_blocks, KV, bs, D]``, bf16, or int8 with bf16 scale
    pools ``[L, n_blocks, KV, bs]`` (rows quantized per position and head by
    ``quantize_kv_rows``, the dense int8 cache's bytes).
  * Table entries past a request's blocks point at block 0, the TRASH block:
    padded prefill chunks and free slots' steps write there, and the mask
    ``t <= pos`` keeps it out of every real result. Duplicate
    ``(block, offset)`` writes happen only there, so their order is free.
  * Writes are in place (indexed writes into the pool), where the JAX
    package threads the pool through a donated scan carry; the functions
    still return ``(logits, pool)`` so both packages are called alike.
  * Prefill never reads the pool: a fresh request's prompt attends its
    just-projected k/v with a causal mask. An int8 pool attends the rows
    quantized and dequantized, as the dense int8 cache's prefill does.
    ``attn_impl="plain"`` runs the fp32 oracle (``ops/attention.py``);
    ``"flash"`` runs K1 (``kernels/attention.py``, its tiled plain version
    on the CPU) on the contiguous rows, from ``start_pos = shared_len`` over
    the gathered prefix for a prefix-cache hit.
  * Decode attention: ``attn_impl="plain"`` gathers each row's blocks into a
    dense copy (the JAX package's ``"xla"`` oracle); ``"flash"`` (JAX's
    ``"pallas"``) runs K6 (``kernels/paged_attention.py``), which walks the
    block tables and reads only the blocks a row owns.
  * The speculative verify step (``paged_decode_step_spec``) runs S = k+1
    rows a slot at per-row positions, always on the gather path, as in the
    JAX package (K6 is S=1-shaped).
  * Under a tensor-parallel ``mesh`` (``parallel/``) the params and the pool
    are this rank's shards (``shard_params``, ``shard_pool``): the heads and
    KV heads are the local ones, read off the shards' shapes; decode
    attention runs K6 through ``tp_paged_flash_decode``; ``wo`` and
    ``w_down`` end in ``model.py``'s all-reduce (``_row_linear``) and the
    head in its vocab all-gather (``output_head``), so every rank holds the
    whole logits row. The block tables and positions are every rank's.

Split-layout weights only (``w["wq"]``...), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.device import resolve_device
from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama.model import (
    LlamaParams,
    _check_shards,
    _row_linear,
    output_head,
    quantize_kv_rows,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.rope import apply_rope
from llama_nuts_and_bolts_tpu_torch.ops import gqa_attention, linear, rms_norm, swiglu_act
from llama_nuts_and_bolts_tpu_torch.parallel.kernel_shard import (
    tp_flash_gqa_attention,
    tp_paged_flash_decode,
)

TRASH_BLOCK = 0
DEFAULT_BLOCK_SIZE = 32
PAGED_ATTN_IMPLS = ("plain", "flash")


@dataclass
class PagedKVPool:
    """Shared block pool. ``k``/``v``: ``[L, n_blocks, KV, block_size, D]``;
    an int8 pool carries bf16 ``k_scale``/``v_scale`` ``[L, n_blocks, KV,
    block_size]``."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: ModelArgs, n_blocks: int,
               block_size: int = DEFAULT_BLOCK_SIZE, dtype=torch.bfloat16,
               device=None, tp: int = 1) -> "PagedKVPool":
        """A zeroed pool; ``tp`` > 1 makes one rank's shard, ``kv_heads / tp``
        of them (the pool ``shard_pool`` cuts from a whole zeroed one)."""
        if n_blocks < 2:
            raise ValueError("need at least one real block beyond the trash block")
        if dtype not in (torch.bfloat16, torch.int8):
            raise ValueError(f"the pool is bf16 or int8, got {dtype}")
        dev = resolve_device(device)
        shape = (cfg.n_layers, n_blocks, cfg.kv_heads // tp, block_size, cfg.head_dim)
        pool = cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))
        if dtype == torch.int8:
            pool.k_scale = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev)
            pool.v_scale = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev)
        return pool

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def n_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    def buffers(self):
        """(k, v) or (k, v, k_scale, v_scale)."""
        if self.quantized:
            return self.k, self.v, self.k_scale, self.v_scale
        return self.k, self.v


def _write_rows(pool_layer: torch.Tensor, rows: torch.Tensor,
                blocks: torch.Tensor, offsets: torch.Tensor) -> None:
    """Write one row per batch entry into a layer's pool, in place.

    Values: pool ``[n_blocks, KV, bs, D]``, rows ``[B, KV, D]``; scales: pool
    ``[n_blocks, KV, bs]``, rows ``[B, KV]``. ``blocks``/``offsets``: ``[B]``.
    The advanced indices (block, offset) are split by the KV slice, so their
    batch dim leads: the target is ``[B, KV(, D)]``, as ``rows``."""
    pool_layer[blocks.long(), :, offsets.long()] = rows.to(pool_layer.dtype)


def _write_chunks(pool_layer: torch.Tensor, rows: torch.Tensor,
                  table_row: torch.Tensor) -> None:
    """Write a prompt's rows block by block, in place.

    Values: pool ``[n_blocks, KV, bs, D]``, rows ``[1, KV, S, D]``; scales:
    pool ``[n_blocks, KV, bs]``, rows ``[1, KV, S]``. S is a multiple of bs;
    chunk ``i`` lands in block ``table_row[i]`` (trash past the owned blocks)."""
    bs = pool_layer.shape[2]
    KV, S = rows.shape[1], rows.shape[2]
    n = S // bs
    chunks = rows[0].reshape((KV, n, bs) + tuple(rows.shape[3:])).transpose(0, 1)
    pool_layer[table_row[:n].long()] = chunks.to(pool_layer.dtype)


def _dequant(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``bf16(int8) * bf16(scale)`` per element, in bf16."""
    return t.to(torch.bfloat16) * s[..., None].to(torch.bfloat16)


def _dense_from_gathered(q, k, v, positions, ks=None, vs=None):
    """Dense GQA over per-row gathered blocks ``k/v [B, M, KV, bs, D]`` (+
    int8 scales ``[B, M, KV, bs]``): row ``b`` sees the slots holding
    positions ``<= positions[b]``."""
    B, M, KV, bs, D = k.shape
    S = q.shape[1]
    if ks is not None:
        k, v = _dequant(k, ks), _dequant(v, vs)
    k = k.transpose(1, 2).reshape(B, KV, M * bs, D)
    v = v.transpose(1, 2).reshape(B, KV, M * bs, D)
    dev = q.device
    t = torch.arange(M * bs, device=dev)[None, None, :]
    s_row = torch.arange(S, device=dev)[None, :, None]
    visible = t <= positions.long()[:, None, None] + s_row
    mask = torch.where(visible, 0.0, float("-inf")).to(torch.float32)
    return gqa_attention(q, k, v, mask)


def _gathered_attention(q, pool_k, pool_v, tables, positions, pool_ks=None,
                        pool_vs=None):
    """The plain paged-attention path over one layer's pool ``[n_blocks, KV,
    bs, D]``: gather each row's blocks, then dense GQA."""
    idx = tables.long()
    ks = vs = None
    if pool_ks is not None:
        ks, vs = pool_ks[idx], pool_vs[idx]
    return _dense_from_gathered(q, pool_k[idx], pool_v[idx], positions, ks, vs)


def _check_impl(attn_impl: str) -> None:
    if attn_impl not in PAGED_ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {PAGED_ATTN_IMPLS}, got "
                         f"{attn_impl!r}")


def _project(x, w, cfg: ModelArgs, cos, sin):
    """RMSNorm, q/k/v projections and RoPE: ``q [B,S,H,D]``, ``k/v [B,S,KV,D]``,
    H and KV the weights' (a rank's under a mesh)."""
    B, S = x.shape[:2]
    D = cfg.head_dim
    h = rms_norm(x, w["attn_norm"], cfg.norm_eps)
    q = linear(h, w["wq"]).reshape(B, S, -1, D)
    k = linear(h, w["wk"]).reshape(B, S, -1, D)
    v = linear(h, w["wv"]).reshape(B, S, -1, D)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _finish_block(x, att, w, cfg: ModelArgs, mesh):
    """``wo`` and the SwiGLU feed-forward with their residuals; under a mesh
    each row-split product ends in the all-reduce."""
    B, S = x.shape[:2]
    x = x + _row_linear(att.reshape(B, S, -1), w["wo"], mesh)
    h2 = rms_norm(x, w["ffn_norm"], cfg.norm_eps)
    return x + _row_linear(swiglu_act(h2, w["w_gate"], w["w_up"]), w["w_down"], mesh)


def _logits_row(params: LlamaParams, cfg: ModelArgs, x, logits_at: int, mesh):
    return output_head(params, cfg, x, logits_at, mesh)[:, 0]        # [1, vocab]


def _causal_mask(S: int, device) -> torch.Tensor:
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    return torch.where(cols <= rows, 0.0, float("-inf")).to(torch.float32)


def _write_prompt_rows(pool: PagedKVPool, li: int, k, v, blocks):
    """Write a prompt's k/v ``[1, KV, S, D]`` into layer ``li``'s blocks; returns
    the rows attention reads: bf16 as projected, or for an int8 pool the
    quantized rows dequantized (the error the dense int8 cache's prefill sees)."""
    if not pool.quantized:
        _write_chunks(pool.k[li], k, blocks)
        _write_chunks(pool.v[li], v, blocks)
        return k, v
    kq, ks = quantize_kv_rows(k)                        # [1, KV, S, D], [1, KV, S]
    vq, vs = quantize_kv_rows(v)
    for buf, rows in ((pool.k, kq), (pool.v, vq), (pool.k_scale, ks), (pool.v_scale, vs)):
        _write_chunks(buf[li], rows, blocks)
    return _dequant(kq, ks), _dequant(vq, vs)


def _prompt_attention(q, k, v, start_pos: int, mask, attn_impl: str, mesh):
    """A prompt's attention: K1 from ``start_pos`` (on this rank's heads
    under a mesh) for ``"flash"``, else the fp32 oracle under ``mask``."""
    if attn_impl == "flash":
        return tp_flash_gqa_attention(mesh, q.contiguous(), k.contiguous(), v.contiguous(),
                                      start_pos)
    return gqa_attention(q, k, v, mask)


def paged_prefill(
    params: LlamaParams,
    cfg: ModelArgs,
    tokens: torch.Tensor,       # int [1, S], S % block_size == 0 (padded)
    logits_at: int,             # the prompt's last real row
    pool: PagedKVPool,
    table_row: torch.Tensor,    # int32 [max_blocks]: this request's blocks
    mesh=None,                  # tensor-parallel DeviceMesh: params/pool are shards
    attn_impl: str = "plain",   # "plain" | "flash"
) -> Tuple[torch.Tensor, PagedKVPool]:
    """Prefill a fresh request (positions 0..S-1) into its pool blocks.
    Never reads the pool. Returns (logits ``[1, vocab]`` at ``logits_at``,
    the pool, written in place). ``"flash"`` attends on K1 (on this rank's
    heads under a mesh, ``tp_flash_gqa_attention``)."""
    _check_impl(attn_impl)
    B, S = tokens.shape
    if B != 1:
        raise ValueError("paged_prefill handles one request at a time")
    if mesh is not None:
        _check_shards(params, cfg, pool, mesh)
    if S % pool.block_size:
        raise ValueError(f"prefill length {S} must be a multiple of the "
                         f"block size {pool.block_size}")
    x = params.tok_embeddings[tokens.long()]
    cos, sin = params.rope_cos[:S], params.rope_sin[:S]
    mask = _causal_mask(S, x.device)[None] if attn_impl == "plain" else None
    for li in range(cfg.n_layers):
        w = {name: t[li] for name, t in params.layers.items()}
        q, k, v = _project(x, w, cfg, cos, sin)
        k, v = _write_prompt_rows(pool, li, k.transpose(1, 2), v.transpose(1, 2),
                                  table_row)
        att = _prompt_attention(q, k, v, 0, mask, attn_impl, mesh)
        x = _finish_block(x, att, w, cfg, mesh)
    return _logits_row(params, cfg, x, logits_at, mesh), pool


def paged_prefill_shared(
    params: LlamaParams,
    cfg: ModelArgs,
    tokens: torch.Tensor,       # int [1, S]: the prompt SUFFIX, S % block_size == 0
    shared_len: int,            # multiple of block_size
    logits_at: int,             # suffix-local index of the last real row
    pool: PagedKVPool,
    table_row: torch.Tensor,    # int32 [max_blocks]: shared + owned blocks
    mesh=None,                  # tensor-parallel DeviceMesh: params/pool are shards
    attn_impl: str = "plain",   # "plain" | "flash"
) -> Tuple[torch.Tensor, PagedKVPool]:
    """Suffix-only prefill for a prefix-cache hit: the first ``shared_len``
    positions already live in the table row's first blocks (written by an
    earlier request with the same prefix). Only the suffix is projected; its
    rows land from block ``shared_len // bs`` on, and attention sees the
    gathered shared prefix (``t < shared_len``) plus the causal suffix.
    Shared blocks are never written. ``"plain"`` gathers every table entry
    and masks the slots past ``shared_len``; ``"flash"`` gathers only the
    shared blocks and runs K1 from ``start_pos = shared_len`` over the
    prefix followed by the suffix rows, the same keys and mask."""
    _check_impl(attn_impl)
    B, S = tokens.shape
    if B != 1:
        raise ValueError("paged_prefill_shared handles one request at a time")
    if mesh is not None:
        _check_shards(params, cfg, pool, mesh)
    bs = pool.block_size
    if S % bs or shared_len % bs:
        raise ValueError(f"suffix length {S} and shared length {shared_len} must "
                         f"be multiples of the block size {bs}")
    KV, D = pool.k.shape[2], cfg.head_dim      # a rank's KV heads under a mesh
    M = table_row.shape[0]
    dev = tokens.device
    x = params.tok_embeddings[tokens.long()]
    cos = params.rope_cos[shared_len:shared_len + S]
    sin = params.rope_sin[shared_len:shared_len + S]
    # suffix chunk i writes to table_row[shared_len // bs + i]; slots past
    # the row's entries are trash
    padded = torch.cat([table_row, torch.full((M,), TRASH_BLOCK, dtype=table_row.dtype,
                                              device=dev)])
    chunk_blocks = padded[shared_len // bs:shared_len // bs + M]
    mask = None
    if attn_impl == "flash":
        # key axis = [shared_len prefix rows] ++ [S suffix rows]
        idx = table_row[:shared_len // bs].long()
    else:
        # key axis = [M * bs pool slots] ++ [S suffix rows]
        t_pool = torch.arange(M * bs, device=dev)[None, :].expand(S, M * bs)
        prefix_mask = torch.where(t_pool < shared_len, 0.0, float("-inf"))
        mask = torch.cat([prefix_mask, _causal_mask(S, dev)], dim=1).float()[None]
        idx = table_row.long()

    def gather_prefix(buf, scale=None):
        g = buf[idx]                                       # [n, KV, bs, D]
        if scale is not None:
            g = _dequant(g, scale[idx])
        return g.transpose(0, 1).reshape(1, KV, idx.shape[0] * bs, D)

    for li in range(cfg.n_layers):
        w = {name: t[li] for name, t in params.layers.items()}
        q, k, v = _project(x, w, cfg, cos, sin)
        k, v = _write_prompt_rows(pool, li, k.transpose(1, 2), v.transpose(1, 2),
                                  chunk_blocks)
        if pool.quantized:
            pk = gather_prefix(pool.k[li], pool.k_scale[li])
            pv = gather_prefix(pool.v[li], pool.v_scale[li])
        else:
            pk, pv = gather_prefix(pool.k[li]), gather_prefix(pool.v[li])
        att = _prompt_attention(q, torch.cat([pk, k], dim=2), torch.cat([pv, v], dim=2),
                                shared_len, mask, attn_impl, mesh)
        x = _finish_block(x, att, w, cfg, mesh)
    return _logits_row(params, cfg, x, logits_at, mesh), pool


def paged_decode_step(
    params: LlamaParams,
    cfg: ModelArgs,
    tokens: torch.Tensor,       # int [B, 1]
    positions: torch.Tensor,    # int32 [B]: write/attend position per row
    pool: PagedKVPool,
    tables: torch.Tensor,       # int32 [B, max_blocks]
    attn_impl: str = "plain",   # "plain" | "flash"
    mesh=None,                  # tensor-parallel DeviceMesh: params/pool are shards
) -> Tuple[torch.Tensor, PagedKVPool]:
    """One batched decode step over paged caches. Returns (logits ``[B,
    vocab]``, the pool, written in place). Rows whose table is all trash
    still step harmlessly. Under a mesh ``"flash"`` runs K6 on this rank's
    heads (``tp_paged_flash_decode``)."""
    _check_impl(attn_impl)
    if mesh is not None:
        _check_shards(params, cfg, pool, mesh)
    B = tokens.shape[0]
    bs = pool.block_size
    x = params.tok_embeddings[tokens.long()]                   # [B, 1, dim]
    pos = positions.long()
    cos = params.rope_cos[pos][:, None, :]                     # [B, 1, D/2]
    sin = params.rope_sin[pos][:, None, :]
    blocks = torch.gather(tables.long(), 1, (pos // bs)[:, None])[:, 0]
    offsets = pos % bs
    for li in range(cfg.n_layers):
        w = {name: t[li] for name, t in params.layers.items()}
        q, k, v = _project(x, w, cfg, cos, sin)
        scales = {}
        if pool.quantized:
            kq, ks = quantize_kv_rows(k[:, 0])                 # [B, KV, D], [B, KV]
            vq, vs = quantize_kv_rows(v[:, 0])
            for buf, rows in ((pool.k, kq), (pool.v, vq), (pool.k_scale, ks),
                              (pool.v_scale, vs)):
                _write_rows(buf[li], rows, blocks, offsets)
            scales = {"pool_ks": pool.k_scale, "pool_vs": pool.v_scale}
        else:
            _write_rows(pool.k[li], k[:, 0], blocks, offsets)
            _write_rows(pool.v[li], v[:, 0], blocks, offsets)
        if attn_impl == "flash":
            # K6 reads the layer's blocks straight from the stacked pool
            att = tp_paged_flash_decode(mesh, q, pool.k, pool.v, tables, positions,
                                        layer=li, **scales)
        else:
            layer_scales = ({} if not pool.quantized else
                            {"pool_ks": pool.k_scale[li], "pool_vs": pool.v_scale[li]})
            att = _gathered_attention(q, pool.k[li], pool.v[li], tables, positions,
                                      **layer_scales)
        x = _finish_block(x, att, w, cfg, mesh)
    return output_head(params, cfg, x, None, mesh)[:, 0], pool


def paged_decode_step_spec(
    params: LlamaParams,
    cfg: ModelArgs,
    tokens: torch.Tensor,       # int [B, K+1]: per-row feed token + K drafts
    positions: torch.Tensor,    # int32 [B]: position of each row's FEED token
    pool: PagedKVPool,
    tables: torch.Tensor,       # int32 [B, max_blocks]
    mesh=None,                  # tensor-parallel DeviceMesh: params/pool are shards
) -> Tuple[torch.Tensor, PagedKVPool]:
    """Speculative verification step over paged caches: row j of slot b runs
    at position ``positions[b] + j`` (clamped to the table's last slot, as
    the JAX package clamps). Returns fp32 logits ``[B, K+1, vocab]`` and the
    pool, written in place.

    The scheduler backs positions ``pos .. pos+K`` with blocks for every
    active slot (it clamps the draft count otherwise); rows past a slot's
    blocks write to the trash block. Rejected rows' K/V land beyond the
    accepted point and stay unseen until overwritten. Always the gather
    path."""
    if mesh is not None:
        _check_shards(params, cfg, pool, mesh)
    B, S = tokens.shape
    bs = pool.block_size
    max_pos = tables.shape[1] * bs - 1
    dev = tokens.device
    x = params.tok_embeddings[tokens.long()]                   # [B, S, dim]
    pos_rows = torch.clamp(positions.long()[:, None] + torch.arange(S, device=dev),
                           max=max_pos)                        # [B, S]
    cos, sin = params.rope_cos[pos_rows], params.rope_sin[pos_rows]
    blocks = torch.gather(tables.long(), 1, pos_rows // bs).reshape(-1)   # [B*S]
    offsets = (pos_rows % bs).reshape(-1)

    def write(buf, rows):
        # rows [B, S, KV(, D)] as B*S single rows
        _write_rows(buf, rows.reshape((B * S,) + tuple(rows.shape[2:])), blocks, offsets)

    for li in range(cfg.n_layers):
        w = {name: t[li] for name, t in params.layers.items()}
        q, k, v = _project(x, w, cfg, cos, sin)
        layer_scales = {}
        if pool.quantized:
            kq, ks = quantize_kv_rows(k)                       # [B,S,KV,D], [B,S,KV]
            vq, vs = quantize_kv_rows(v)
            for buf, rows in ((pool.k, kq), (pool.v, vq), (pool.k_scale, ks),
                              (pool.v_scale, vs)):
                write(buf[li], rows)
            layer_scales = {"pool_ks": pool.k_scale[li], "pool_vs": pool.v_scale[li]}
        else:
            write(pool.k[li], k)
            write(pool.v[li], v)
        att = _gathered_attention(q, pool.k[li], pool.v[li], tables, positions,
                                  **layer_scales)
        x = _finish_block(x, att, w, cfg, mesh)
    return output_head(params, cfg, x, None, mesh), pool
