"""The attention kernels on one rank's batch rows and head shard.

Port of ``llama_nuts_and_bolts_tpu/parallel/kernel_shard.py``. GSPMD cannot
partition a ``pallas_call``, so the JAX package runs each kernel inside a
``shard_map`` region over the local rows (dp) and heads (tp). Attention is
row- and head-local (a query meets only its own row's cache and its own KV
head), so no collective runs inside. A process of the port already holds
only its rank's rows and heads (``parallel/sharding.py``), so each function
here checks that the shard keeps whole GQA groups, the group the kernels
are built for, and that q, the cache and a ``[B]`` positions tensor hold
the same rows (the rank's: a ``[B]`` ``start_pos`` is cut with its rows,
``parallel.sharding.shard_tokens``), and calls the kernel on them:

  q            [B/dp, S, H/tp, D]
  k/v cache    [B/dp, KV/tp, T, D]         ([L, B/dp, KV/tp, T, D] with ``layer``)
  kv scales    [B/dp, KV/tp, T]            ([L, B/dp, KV/tp, T])
  positions    [B/dp] int32, or an int
  paged pool   [n_blocks, KV/tp, bs, D]    ([L, n_blocks, KV/tp, bs, D] with ``layer``)
  pool scales  [n_blocks, KV/tp, bs]       ([L, n_blocks, KV/tp, bs])

The block tables and positions of the paged pool are replicated: the batch
lives in them, not on a mesh axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.attention import K1_GROUP, flash_gqa_attention
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
    K2_GROUP,
    flash_decode_attention,
)
from llama_nuts_and_bolts_tpu_torch.kernels.paged_attention import paged_flash_decode
from llama_nuts_and_bolts_tpu_torch.parallel.mesh import dp_size, tp_size


def _check_shard(mesh, q: torch.Tensor, kv_heads: int, group: int,
                 rows: Optional[int] = None, positions=None) -> None:
    """Whole GQA groups on the rank; with ``rows`` (the cache's batch rows),
    q's rows and a ``[B]`` positions tensor's must be the same ones."""
    if mesh is None:
        return        # the whole heads and rows: the kernel checks its own
    H = q.shape[2]
    if H % kv_heads or H // kv_heads != group:
        raise ValueError(
            f"a tp={tp_size(mesh)} shard of {H} query heads over {kv_heads} KV heads "
            f"does not keep whole GQA groups of {group} (the kernels' group)")
    n_pos = positions.shape[0] if isinstance(positions, torch.Tensor) else None
    if rows is not None and (q.shape[0] != rows or n_pos not in (None, rows)):
        raise ValueError(
            f"a dp={dp_size(mesh)} shard: q holds {q.shape[0]} rows, the cache {rows}"
            + ("" if n_pos is None else f", the positions {n_pos}")
            + "; cut each with its rows (parallel.sharding.shard_tokens, shard_cache)")


def tp_flash_decode_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              start_pos, k_scale=None, v_scale=None,
                              layer: Optional[int] = None, fold_heads: bool = False,
                              int8_mxu: bool = False) -> torch.Tensor:
    """``flash_decode_attention`` (K2, K4 for an int8 cache) on this rank's
    rows and heads: ``[B/dp, 1, H/tp, D]``."""
    _check_shard(mesh, q, k.shape[-3], K2_GROUP, rows=k.shape[-4], positions=start_pos)
    return flash_decode_attention(q, k, v, start_pos, k_scale=k_scale, v_scale=v_scale,
                                  layer=layer, fold_heads=fold_heads, int8_mxu=int8_mxu)


def tp_flash_gqa_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           start_pos) -> torch.Tensor:
    """``flash_gqa_attention`` (K1, prefill) on this rank's rows and heads;
    ``start_pos`` is the global position of q's first row (a
    sequence-parallel rank's own)."""
    _check_shard(mesh, q, k.shape[1], K1_GROUP, rows=k.shape[0])
    return flash_gqa_attention(q, k, v, start_pos)


def tp_paged_flash_decode(mesh, q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                          tables: torch.Tensor, positions, layer: Optional[int] = None,
                          pool_ks: Optional[torch.Tensor] = None,
                          pool_vs: Optional[torch.Tensor] = None,
                          split: Optional[int] = None) -> torch.Tensor:
    """``paged_flash_decode`` (K6, its int8 mode for an int8 pool) on this
    rank's heads of a sharded pool: ``[B, 1, H/tp, D]``. ``tables [B, M]``
    and ``positions`` are every rank's."""
    _check_shard(mesh, q, pool_k.shape[-3], K2_GROUP)
    return paged_flash_decode(q, pool_k, pool_v, tables, positions, layer=layer,
                              pool_ks=pool_ks, pool_vs=pool_vs, split=split)
