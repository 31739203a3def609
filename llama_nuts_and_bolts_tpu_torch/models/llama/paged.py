"""Paged KV cache: a shared block pool + per-request block tables.

Port of ``llama_nuts_and_bolts_tpu/models/llama/paged.py``. The cache is a POOL of fixed-size
blocks shared by every request; a request holds ``ceil(len / bs)`` blocks
and releases them on completion, so device memory tracks live tokens, not
slots x context.

  * The pool is ``[L, n_blocks, KV, bs, D]``, bf16, or int8 with bf16 scale
    pools ``[L, n_blocks, KV, bs]`` (rows quantized per position and head by
    ``ops.quantize_kv_rows``, the dense int8 cache's bytes).
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
  * The layers are ``model.py``'s (``run_blocks``, ``decoder_block``):
    what is paged is only where a layer's new K/V rows go and which
    attention reads them, the attention object each function builds once
    (``_PagedPrompt`` for a prompt, ``_PagedStep`` for a batched step).
  * A model with experts takes each function's ``routing``
    (``ops/moe.py::Routing``): the expert ids its layers write, and for a step
    the rows that route (a batcher masks its free slots). A prefill routes
    no padding row past ``logits_at`` (``model.py::expert_routing``).
  * Under a tensor-parallel ``mesh`` (``parallel/``) the params and the pool
    are this rank's shards (``shard_params``, ``shard_pool``): the heads and
    KV heads are the local ones; decode attention runs K6 through
    ``tp_paged_flash_decode``; ``wo`` and ``w_down`` end in ``model.py``'s
    all-reduce and the head in its vocab all-gather (``output_head``), so
    every rank holds the whole logits row. The block tables and positions
    are every rank's.

Split-layout weights only (``w["wq"]``...), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.device import resolve_device
from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama.model import (
    BlockInputs,
    LlamaParams,
    _check_shards,
    expert_routing,
    output_head,
    run_blocks,
)
from llama_nuts_and_bolts_tpu_torch.ops import (
    Routing,
    dequantize_kv_rows,
    gqa_attention,
    quantize_kv_rows,
)
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


def _gathered_attention(q, pool_k, pool_v, tables, positions, pool_ks=None,
                        pool_vs=None):
    """The plain paged-attention path over one layer's pool ``[n_blocks, KV,
    bs, D]`` (+ int8 scales ``[n_blocks, KV, bs]``): each row's blocks
    gathered into a dense copy, then dense GQA; row ``b``'s query ``s``
    sees the slots holding positions ``<= positions[b] + s``."""
    idx = tables.long()
    k, v = pool_k[idx], pool_v[idx]                        # [B, M, KV, bs, D]
    if pool_ks is not None:
        k, v = dequantize_kv_rows(k, pool_ks[idx]), dequantize_kv_rows(v, pool_vs[idx])
    B, M, KV, bs, D = k.shape
    k = k.transpose(1, 2).reshape(B, KV, M * bs, D)
    v = v.transpose(1, 2).reshape(B, KV, M * bs, D)
    dev = q.device
    t = torch.arange(M * bs, device=dev)[None, None, :]
    s_row = torch.arange(q.shape[1], device=dev)[None, :, None]
    visible = t <= positions.long()[:, None, None] + s_row
    mask = torch.where(visible, 0.0, float("-inf")).to(torch.float32)
    return gqa_attention(q, k, v, mask)


def _check_impl(attn_impl: str) -> None:
    if attn_impl not in PAGED_ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {PAGED_ATTN_IMPLS}, got "
                         f"{attn_impl!r}")


def _causal_mask(S: int, device) -> torch.Tensor:
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    return torch.where(cols <= rows, 0.0, float("-inf")).to(torch.float32)


def _write_prompt_rows(pool: PagedKVPool, li: int, k, v, blocks):
    """Write a prompt's k/v ``[1, KV, S, D]`` into layer ``li``'s blocks; returns
    the rows attention reads: bf16 as projected, or for an int8 pool the
    quantized rows dequantized (the error the dense int8 cache's prefill sees)."""
    rows = (k, v)
    if pool.quantized:
        (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)   # [1,KV,S(,D)]
        rows = (kq, vq, ks, vs)
        k, v = dequantize_kv_rows(kq, ks), dequantize_kv_rows(vq, vs)
    for buf, r in zip(pool.buffers(), rows):
        _write_chunks(buf[li], r, blocks)
    return k, v


@dataclass
class _PagedPrompt:
    """One request's prompt attention for a prefill: writes a layer's new
    rows into the chunks' ``blocks``, then attends over them, after the
    ``prefix`` table entries' rows, gathered, on a prefix-cache hit:
    ``"flash"`` runs K1 from ``shared_len`` (on this rank's heads under a
    mesh), ``"plain"`` the fp32 oracle under ``mask``."""

    pool: PagedKVPool
    blocks: torch.Tensor                # chunk i's block: blocks[i]
    shared_len: int
    prefix: Optional[torch.Tensor]      # the table entries gathered before the rows
    mask: Optional[torch.Tensor]
    attn_impl: str
    mesh: Any = None

    def _gather(self, buf, scale, li: int) -> torch.Tensor:
        g = buf[li][self.prefix]                           # [n, KV, bs, D]
        if scale is not None:
            g = dequantize_kv_rows(g, scale[li][self.prefix])
        n, KV, bs, D = g.shape
        return g.transpose(0, 1).reshape(1, KV, n * bs, D)

    def __call__(self, li: int, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        pool = self.pool
        k, v = _write_prompt_rows(pool, li, k.transpose(1, 2), v.transpose(1, 2),
                                  self.blocks)
        if self.prefix is not None:
            k = torch.cat([self._gather(pool.k, pool.k_scale, li), k], dim=2)
            v = torch.cat([self._gather(pool.v, pool.v_scale, li), v], dim=2)
        if self.attn_impl == "flash":
            return tp_flash_gqa_attention(self.mesh, q.contiguous(), k.contiguous(),
                                          v.contiguous(), self.shared_len)
        return gqa_attention(q, k, v, self.mask)


@dataclass
class _PagedStep:
    """A batched step's attention over the block tables: writes each row's
    new K/V at its ``(block, offset)`` (``[B*S]``, row-major), then attends
    on K6 (``"flash"``, one row a slot) or over each slot's gathered blocks."""

    pool: PagedKVPool
    tables: torch.Tensor                # int32 [B, max_blocks]
    positions: torch.Tensor             # int32 [B]: each slot's first row
    blocks: torch.Tensor
    offsets: torch.Tensor
    attn_impl: str
    mesh: Any = None

    def __call__(self, li: int, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        pool = self.pool
        rows = (k, v)                                      # [B, S, KV(, D)]
        if pool.quantized:
            (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
            rows = (kq, vq, ks, vs)
        for buf, r in zip(pool.buffers(), rows):
            _write_rows(buf[li], r.flatten(0, 1), self.blocks, self.offsets)
        if self.attn_impl == "flash":
            # K6 reads the layer's blocks straight from the stacked pool
            return tp_paged_flash_decode(self.mesh, q, pool.k, pool.v, self.tables,
                                         self.positions, layer=li, pool_ks=pool.k_scale,
                                         pool_vs=pool.v_scale)
        layer = [buf[li] for buf in pool.buffers()]        # k, v(, k_scale, v_scale)
        return _gathered_attention(q, layer[0], layer[1], self.tables, self.positions,
                                   *layer[2:])


def paged_prefill(
    params: LlamaParams,
    cfg: ModelArgs,
    tokens: torch.Tensor,       # int [1, S], S % block_size == 0 (padded)
    logits_at: int,             # the prompt's last real row
    pool: PagedKVPool,
    table_row: torch.Tensor,    # int32 [max_blocks]: this request's blocks
    mesh=None,                  # tensor-parallel DeviceMesh: params/pool are shards
    attn_impl: str = "plain",   # "plain" | "flash"
    routing: Optional[Routing] = None,
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
    mask = _causal_mask(S, x.device)[None] if attn_impl == "plain" else None
    attend = _PagedPrompt(pool, table_row, 0, None, mask, attn_impl, mesh)
    x = run_blocks(params, x, BlockInputs(cfg, params.rope_cos[:S], params.rope_sin[:S],
                                          attend, mesh, expert_routing(
                                              cfg, routing, 1, S, logits_at, x.device)))
    return output_head(params, cfg, x, logits_at, mesh)[:, 0], pool


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
    routing: Optional[Routing] = None,
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
    M = table_row.shape[0]
    dev = tokens.device
    x = params.tok_embeddings[tokens.long()]
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
    attend = _PagedPrompt(pool, chunk_blocks, shared_len, idx, mask, attn_impl, mesh)
    x = run_blocks(params, x, BlockInputs(cfg, params.rope_cos[shared_len:shared_len + S],
                                          params.rope_sin[shared_len:shared_len + S],
                                          attend, mesh, expert_routing(
                                              cfg, routing, 1, S, logits_at, dev)))
    return output_head(params, cfg, x, logits_at, mesh)[:, 0], pool


def paged_decode_step(
    params: LlamaParams,
    cfg: ModelArgs,
    tokens: torch.Tensor,       # int [B, 1]
    positions: torch.Tensor,    # int32 [B]: write/attend position per row
    pool: PagedKVPool,
    tables: torch.Tensor,       # int32 [B, max_blocks]
    attn_impl: str = "plain",   # "plain" | "flash"
    mesh=None,                  # tensor-parallel DeviceMesh: params/pool are shards
    routing: Optional[Routing] = None,
) -> Tuple[torch.Tensor, PagedKVPool]:
    """One batched decode step over paged caches. Returns (logits ``[B,
    vocab]``, the pool, written in place). Rows whose table is all trash
    still step harmlessly. Under a mesh ``"flash"`` runs K6 on this rank's
    heads (``tp_paged_flash_decode``)."""
    _check_impl(attn_impl)
    if mesh is not None:
        _check_shards(params, cfg, pool, mesh)
    bs = pool.block_size
    x = params.tok_embeddings[tokens.long()]                   # [B, 1, dim]
    pos = positions.long()
    blocks = torch.gather(tables.long(), 1, (pos // bs)[:, None])[:, 0]
    attend = _PagedStep(pool, tables, positions, blocks, pos % bs, attn_impl, mesh)
    x = run_blocks(params, x, BlockInputs(cfg, params.rope_cos[pos][:, None, :],
                                          params.rope_sin[pos][:, None, :], attend, mesh,
                                          expert_routing(cfg, routing, *tokens.shape, None,
                                                         x.device)))
    return output_head(params, cfg, x, None, mesh)[:, 0], pool


def paged_decode_step_spec(
    params: LlamaParams,
    cfg: ModelArgs,
    tokens: torch.Tensor,       # int [B, K+1]: per-row feed token + K drafts
    positions: torch.Tensor,    # int32 [B]: position of each row's FEED token
    pool: PagedKVPool,
    tables: torch.Tensor,       # int32 [B, max_blocks]
    mesh=None,                  # tensor-parallel DeviceMesh: params/pool are shards
    routing: Optional[Routing] = None,
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
    S = tokens.shape[1]
    bs = pool.block_size
    max_pos = tables.shape[1] * bs - 1
    dev = tokens.device
    x = params.tok_embeddings[tokens.long()]                   # [B, S, dim]
    pos_rows = torch.clamp(positions.long()[:, None] + torch.arange(S, device=dev),
                           max=max_pos)                        # [B, S]
    cos, sin = params.rope_cos[pos_rows], params.rope_sin[pos_rows]
    blocks = torch.gather(tables.long(), 1, pos_rows // bs).reshape(-1)   # [B*S]
    attend = _PagedStep(pool, tables, positions, blocks, (pos_rows % bs).reshape(-1),
                        "plain", mesh)
    x = run_blocks(params, x, BlockInputs(cfg, params.rope_cos[pos_rows],
                                          params.rope_sin[pos_rows], attend, mesh,
                                          expert_routing(cfg, routing, *tokens.shape, None,
                                                         dev)))
    return output_head(params, cfg, x, None, mesh), pool
