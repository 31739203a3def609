"""K6, K7: S=1 decode attention over a paged KV pool, walking block tables.

Port of ``llama_nuts_and_bolts_tpu/kernels/paged_attention.py::paged_flash_decode``.
Batch row ``b`` attends the pool slots holding its positions
``t <= positions[b]``: the blocks ``tables[b, 0 .. positions[b] // bs]``;
blocks past the row's position are never read. Three CUDA kernels in
``csrc/paged_attention.cu`` serve it, each with a plain PyTorch version
beside it that CPU tensors take:

  * K6, ``fold_heads=True`` on a bf16 pool (``_paged_kernel_heads``), with
    ``layer=`` over a stacked ``[L, n_blocks, KV, bs, D]`` pool: the online
    softmax updates once per span of :func:`paged_chunk` consecutive table
    entries, as the Pallas kernel does; counted in ``paged_flash_decode.launches``.
  * K6 on an int8 pool with bf16 scale pools: q quantized per row, int8 score
    dots, one update per (head, bs-key block) with p folded with the v scales
    and quantized over that block (``kernels/quant_attn_math.py``); counted in
    ``paged_flash_decode_int8.launches``.
  * K7, ``fold_heads=False`` (``_paged_kernel``): bf16, a single-layer pool,
    one update per bs-key block -- K6's kernel with a span of one block;
    counted in ``paged_flash_decode_per_head.launches``.

Folding the KV heads into one program amortises TPU grid steps and has no
numerical meaning; the span of the online softmax is the one numerical
choice, and each plain version follows the kernel's (the Pallas kernel's).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.build import check_launch, cuda_stream, library
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
    HEAD_DIM,
    K2_GROUP,
    NEG_INF,
    _positions,
)
from llama_nuts_and_bolts_tpu_torch.kernels.quant_attn_math import (
    int8_pv,
    int8_scores,
    quantize_q_rows,
)

MAX_BLOCK_SIZE = 64      # pool block sizes the kernels take (the pool's default is 32)
SPAN_KEYS = 512          # keys per softmax update of K6's bf16 mode


def paged_chunk(M: int, bs: int) -> int:
    """Table entries per softmax update of K6's bf16 mode: enough for a
    512-key span, reduced until it divides M (``paged_attention.py:256-259``
    of the JAX package)."""
    chunk = max(1, min(M, SPAN_KEYS // bs))
    while M % chunk:
        chunk -= 1
    return chunk


def _check(q, pool_k, pool_v, tables, pool_ks, pool_vs):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError("paged_flash_decode is the S=1 kernel")
    if pool_k.dim() != 5 or pool_v.shape != pool_k.shape:
        raise ValueError(f"expected pools [L, n_blocks, KV, bs, D], got "
                         f"{tuple(pool_k.shape)}, {tuple(pool_v.shape)}")
    B, _, H, D = q.shape
    KV, Dk = pool_k.shape[2], pool_k.shape[4]
    if Dk != D or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and pool {tuple(pool_k.shape)} disagree")
    if tables.dim() != 2 or tables.shape[0] != B or tables.dtype != torch.int32:
        raise ValueError(f"tables must be int32 [B={B}, M], got {tables.dtype} "
                         f"{tuple(tables.shape)}")
    quantized = pool_k.dtype == torch.int8
    if quantized != (pool_ks is not None) or (pool_ks is None) != (pool_vs is None):
        raise ValueError("an int8 pool comes with pool_ks and pool_vs, a bf16 pool "
                         "without")
    dtype = torch.int8 if quantized else torch.bfloat16
    named = [("q", q, torch.bfloat16), ("pool_k", pool_k, dtype),
             ("pool_v", pool_v, dtype), ("tables", tables, torch.int32)]
    if quantized:
        for name, s in (("pool_ks", pool_ks), ("pool_vs", pool_vs)):
            if tuple(s.shape) != tuple(pool_k.shape[:-1]):
                raise ValueError(f"{name} must be [L, n_blocks, KV, bs] = "
                                 f"{tuple(pool_k.shape[:-1])}, got {tuple(s.shape)}")
            named.append((name, s, torch.bfloat16))
    for name, t, want in named:
        if t.dtype != want:
            raise TypeError(f"paged decode takes {want} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"paged decode takes a contiguous {name}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"paged decode runs on cuda or cpu tensors, got {q.device}")


def paged_flash_decode_plain(q: torch.Tensor, pool_k: torch.Tensor,
                             pool_v: torch.Tensor, tables: torch.Tensor,
                             positions: torch.Tensor, layer: int = 0,
                             chunk: int = 1, scale: Optional[float] = None) -> torch.Tensor:
    """K6's bf16 function (K7's with ``chunk=1`` on a one-layer stack) in
    PyTorch: per batch row, spans of ``chunk`` table entries up to its
    position, one online fp32 softmax update per span, p rounded to bf16
    before the PV product. ``pool_k``/``pool_v``: ``[L, n_blocks, KV, bs, D]``."""
    B, _, H, D = q.shape
    KV, bs = pool_k.shape[2], pool_k.shape[3]
    M = tables.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    pk, pv = pool_k[layer], pool_v[layer]
    tbl, pos = tables.tolist(), positions.tolist()
    out = torch.empty_like(q)
    for b in range(B):
        used = min(pos[b] // bs, M - 1)
        qb = q[b, 0].reshape(KV, G, D).float()
        acc = torch.zeros(KV, G, D, device=q.device)
        m = torch.full((KV, G, 1), NEG_INF, device=q.device)
        l = torch.zeros(KV, G, 1, device=q.device)
        for s0 in range(0, used + 1, chunk):
            # entries past the last used block re-read it, masked (the
            # Pallas index map's clamp)
            blocks = [tbl[b][min(j, used)] for j in range(s0, s0 + chunk)]
            kt = pk[blocks].transpose(0, 1).reshape(KV, chunk * bs, D).float()
            vt = pv[blocks].transpose(0, 1).reshape(KV, chunk * bs, D).float()
            s = (qb @ kt.transpose(-1, -2)) * scale                 # [KV, G, span]
            t_pos = s0 * bs + torch.arange(chunk * bs, device=q.device)
            s = torch.where(t_pos <= pos[b], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(torch.bfloat16).float() @ vt
            m = m_new
        out[b, 0] = (acc / l.clamp_min(1e-30)).reshape(H, D).to(q.dtype)
    return out


def paged_flash_decode_int8_plain(q: torch.Tensor, pool_k: torch.Tensor,
                                  pool_v: torch.Tensor, pool_ks: torch.Tensor,
                                  pool_vs: torch.Tensor, tables: torch.Tensor,
                                  positions: torch.Tensor, layer: int = 0,
                                  scale: Optional[float] = None) -> torch.Tensor:
    """K6's int8 function in PyTorch, as the Pallas kernel computes it: per
    batch row and used block, every KV head's scores from int8 dots, the
    online fp32 softmax, and p folded with the v scales and quantized per row
    over the block."""
    B, _, H, D = q.shape
    KV, bs = pool_k.shape[2], pool_k.shape[3]
    M = tables.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    pk, pv, pks, pvs = pool_k[layer], pool_v[layer], pool_ks[layer], pool_vs[layer]
    tbl, pos = tables.tolist(), positions.tolist()
    out = torch.empty_like(q)
    for b in range(B):
        q_i, qs = quantize_q_rows(q[b, 0].reshape(KV, G, D))
        acc = torch.zeros(KV, G, D, device=q.device)
        m = torch.full((KV, G, 1), NEG_INF, device=q.device)
        l = torch.zeros(KV, G, 1, device=q.device)
        for j in range(min(pos[b] // bs, M - 1) + 1):
            blk = tbl[b][j]
            s = int8_scores(q_i, qs, pk[blk], pks[blk].float(), scale)   # [KV, G, bs]
            t_pos = j * bs + torch.arange(bs, device=q.device)
            s = torch.where(t_pos <= pos[b], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + int8_pv(p, pv[blk], pvs[blk].float())
            m = m_new
        out[b, 0] = (acc / l.clamp_min(1e-30)).reshape(H, D).to(q.dtype)
    return out


def _require_kernel_shape(q, pool_k) -> None:
    H, D = q.shape[2], q.shape[3]
    KV, bs = pool_k.shape[2], pool_k.shape[3]
    if D != HEAD_DIM or H // KV != K2_GROUP:
        raise ValueError(f"the paged kernels are built for head_dim {HEAD_DIM} and "
                         f"G = H/KV = {K2_GROUP}, got {D} and {H // KV}")
    if bs > MAX_BLOCK_SIZE:
        raise ValueError(f"the paged kernels take pool blocks of at most "
                         f"{MAX_BLOCK_SIZE} positions, got {bs}")
    for t in (q, pool_k):
        if t.data_ptr() % 16:
            raise ValueError("the paged kernels take 16-byte aligned tensors")


def _bf16_kernel(q, pool_k, pool_v, tables, positions, layer, chunk, scale):
    _require_kernel_shape(q, pool_k)
    B, _, H, D = q.shape
    L, n_blocks, KV, bs, _ = pool_k.shape
    out = torch.empty_like(q)
    fn = library("paged_attention").lnb_paged_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tables.data_ptr(),
                 positions.data_ptr(), out.data_ptr(), B, H, KV, tables.shape[1],
                 n_blocks, bs, chunk, layer, scale, cuda_stream(q.device))
    check_launch(err, "paged_flash_decode")
    return out


def paged_flash_decode_int8(q, pool_k, pool_v, pool_ks, pool_vs, tables, positions,
                            layer: int, scale: float) -> torch.Tensor:
    """K6 on an int8 pool. Arguments as :func:`paged_flash_decode`'s, already
    checked, stacked pools, ``[B]`` int32 positions on the card."""
    _require_kernel_shape(q, pool_k)
    B, _, H, D = q.shape
    L, n_blocks, KV, bs, _ = pool_k.shape
    out = torch.empty_like(q)
    fn = library("paged_attention").lnb_paged_decode_int8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), pool_ks.data_ptr(),
                 pool_vs.data_ptr(), tables.data_ptr(), positions.data_ptr(),
                 out.data_ptr(), B, H, KV, tables.shape[1], n_blocks, bs, layer, scale,
                 cuda_stream(q.device))
    check_launch(err, "paged_flash_decode_int8")
    paged_flash_decode_int8.launches += 1
    return out


def paged_flash_decode_per_head(q, pool_k, pool_v, tables, positions,
                                scale: float) -> torch.Tensor:
    """K7: one KV head per program, one bs-key update per block, over a
    single-layer bf16 pool lifted to a one-layer stack. Arguments already
    checked, ``[B]`` int32 positions on the card."""
    out = _bf16_kernel(q, pool_k, pool_v, tables, positions, 0, 1, scale)
    paged_flash_decode_per_head.launches += 1
    return out


def paged_flash_decode(
    q: torch.Tensor,               # [B, 1, H, D] bf16
    pool_k: torch.Tensor,          # [n_blocks, KV, bs, D] bf16/int8; [L, ...] with layer
    pool_v: torch.Tensor,
    tables: torch.Tensor,          # int32 [B, M]
    positions,                     # int, or int32 [B]
    scale: Optional[float] = None,
    fold_heads: bool = True,
    layer: Optional[int] = None,   # pools are the whole [L, n_blocks, ...] stack
    pool_ks: Optional[torch.Tensor] = None,   # bf16 [n_blocks, KV, bs] for int8 pools
    pool_vs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns ``[B, 1, H, D]`` bf16; row ``b`` attends the pool slots
    holding its positions ``<= positions[b]`` (its just-written row
    included). CUDA tensors launch K6 or K7 as the module docstring says;
    CPU tensors take the plain version of the same function. Refuses what
    the JAX function refuses: ``layer`` or an int8 pool without
    ``fold_heads``."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError("paged_flash_decode is the S=1 kernel")
    quantized = pool_ks is not None
    if layer is None:
        pool_k, pool_v, layer = pool_k[None], pool_v[None], 0   # free views
        if quantized and pool_vs is not None:
            pool_ks, pool_vs = pool_ks[None], pool_vs[None]
    elif not fold_heads:
        raise ValueError("stacked-pool layer mode requires fold_heads=True")
    if quantized and not fold_heads:
        raise ValueError("int8 pools require the fold_heads kernel")
    _check(q, pool_k, pool_v, tables, pool_ks, pool_vs)
    if not isinstance(layer, int) or not 0 <= layer < pool_k.shape[0]:
        raise ValueError(f"layer must be an int in [0, {pool_k.shape[0]}), got {layer!r}")
    B, _, H, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    positions = _positions(positions, B, q.device)
    cpu = q.device.type == "cpu"
    if quantized:
        if cpu:
            return paged_flash_decode_int8_plain(q, pool_k, pool_v, pool_ks, pool_vs,
                                                 tables, positions, layer, scale)
        return paged_flash_decode_int8(q, pool_k, pool_v, pool_ks, pool_vs, tables,
                                       positions, layer, scale)
    chunk = paged_chunk(tables.shape[1], pool_k.shape[3]) if fold_heads else 1
    if cpu:
        return paged_flash_decode_plain(q, pool_k, pool_v, tables, positions, layer,
                                        chunk, scale)
    if not fold_heads:
        return paged_flash_decode_per_head(q, pool_k, pool_v, tables, positions, scale)
    out = _bf16_kernel(q, pool_k, pool_v, tables, positions, layer, chunk, scale)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
paged_flash_decode_int8.launches = 0
paged_flash_decode_per_head.launches = 0
