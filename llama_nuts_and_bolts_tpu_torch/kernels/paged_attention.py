"""K6, K7: S=1 decode attention over a paged KV pool, walking block tables.

Port of ``llama_nuts_and_bolts_tpu/kernels/paged_attention.py::paged_flash_decode``.
Batch row ``b`` attends the pool slots holding its positions
``t <= positions[b]``: the blocks ``tables[b, 0 .. positions[b] // bs]``;
blocks past the row's position are never read. One CUDA kernel in
``csrc/paged_attention.cu``, built for a bf16 and an int8 pool, serves three
functions, each with a plain PyTorch version beside it that CPU tensors take:

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

The kernel splits each row's table walk over ``(splits, KV, B)`` blocks
(:func:`paged_split`, from shapes only; :class:`PagedGeometry`), each
split's fp32 partial combined in split order by the split that finishes
last, inside the same launch; :func:`paged_scratch` holds the partials and
tickets. A split cuts the bf16 spans at its edges, so p is rounded to bf16
relative to the split's running max; the int8 quantization rows are single
pool blocks, which a split never cuts. Folding the KV heads into one program
amortises TPU grid steps and has no numerical meaning; the spans, the splits
and the combine are the numerical choices, and each plain version follows
the kernel's.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.build import (
    check_launch,
    cuda_stream,
    library,
    split_workspace,
)
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
    HEAD_DIM,
    K2_GROUP,
    K2_TARGET_BLOCKS,
    NEG_INF,
    _positions,
)
from llama_nuts_and_bolts_tpu_torch.kernels.quant_attn_math import (
    int8_pv,
    int8_scores,
    quantize_q_rows,
)

MAX_BLOCK_SIZE = 64      # pool block sizes the kernel takes (the pool's default is 32)
BLOCK_SIZE_UNIT = 8      # ... in multiples of 8: the int8 scales' bulk copies are 16-byte runs
SPAN_KEYS = 512          # keys per softmax update of K6's bf16 mode
PAGED_MAX_SPLITS = 256   # splits of one row the kernel's combine takes (csrc: MAX_SPLITS)
PAGED_MIN_SPLIT_KEYS = 64    # keys of a split the rule takes, at least (kernels/k6_splits.py)


def paged_chunk(M: int, bs: int) -> int:
    """Table entries per softmax update of K6's bf16 mode: enough for a
    512-key span, reduced until it divides M (``paged_attention.py:256-259``
    of the JAX package)."""
    chunk = max(1, min(M, SPAN_KEYS // bs))
    while M % chunk:
        chunk -= 1
    return chunk


def paged_split(B: int, KV: int, M: int, bs: int) -> int:
    """Table entries per split of K6/K7's table walk: from
    ``PAGED_MIN_SPLIT_KEYS`` keys up, doubled until the ``B * KV`` heads'
    tables of ``M`` entries cut into at most about ``K2_TARGET_BLOCKS``
    blocks and at most ``PAGED_MAX_SPLITS`` splits a row; never more than M.
    A function of shapes only, never of positions (as K2's
    ``k2_split_k``): the wrapper launches without reading them back. At
    Llama-3.1-8B's KV = 8, bs = 32 and M = 64 (a 2048-token context) that
    is 2 entries at B = 1 (32 splits; 29 active at position 1850) and 8 at
    B = 4."""
    want = -(-B * KV * M // K2_TARGET_BLOCKS)
    split = max(1, PAGED_MIN_SPLIT_KEYS // bs)
    while split < M and (split < want or -(-M // split) > PAGED_MAX_SPLITS):
        split *= 2
    return min(split, M)


@dataclass(frozen=True)
class PagedGeometry:
    """Launch arithmetic shared by the kernel, the plain versions and the
    tests: split ``s`` of row ``b`` walks table entries ``[s * split, (s + 1)
    * split)`` up to the row's last used one; inside a split, one softmax
    update per span of the Pallas partition (multiples of ``chunk``: K6's
    bf16 mode :func:`paged_chunk`, int8 and K7 1) cut at the split's edges.
    The splits past a row's position read nothing."""

    split: int
    chunk: int
    grid: Tuple[int, int, int]    # (splits, kv heads, batch)
    n_entries: List[int]          # used table entries of each row (0: nothing visible)
    active_splits: List[int]      # splits of each row that run (split 0 always)

    def split_entries(self, b: int, s: int) -> Tuple[int, int]:
        """The table entries ``[start, end)`` that active split ``s`` of row
        ``b`` reads."""
        start = s * self.split
        return start, max(start, min(start + self.split, self.n_entries[b]))

    def spans(self, b: int, s: int) -> List[Tuple[int, int]]:
        """The softmax spans ``[a, a1)`` of split ``s`` of row ``b``, in order."""
        a, end = self.split_entries(b, s)
        out = []
        while a < end:
            a1 = min((a // self.chunk + 1) * self.chunk, end)
            out.append((a, a1))
            a = a1
        return out


def paged_n_splits(M: int, split: int) -> int:
    """How many splits of ``split`` table entries cut a table of M; raises
    on a split the kernel's combine cannot take."""
    if split < 1 or -(-M // split) > PAGED_MAX_SPLITS:
        raise ValueError(f"a split of {split} entries cuts M={M} into more than "
                         f"{PAGED_MAX_SPLITS} splits, or is empty")
    return -(-M // split)


def paged_geometry(B: int, KV: int, M: int, bs: int, positions: List[int], chunk: int,
                   split: Optional[int] = None) -> PagedGeometry:
    """The geometry of a launch: :func:`paged_split`'s split unless ``split``
    forces one."""
    split = paged_split(B, KV, M, bs) if split is None else split
    n_entries = [0 if p < 0 else min(p // bs, M - 1) + 1 for p in positions]
    return PagedGeometry(split=split, chunk=chunk, grid=(paged_n_splits(M, split), KV, B),
                         n_entries=n_entries,
                         active_splits=[max(1, -(-n // split)) for n in n_entries])


def paged_scratch(device: torch.device, B: int, KV: int,
                  n_splits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6/K7's workspace for a launch on the current stream
    (:func:`build.split_workspace`): every split's fp32 partial
    ``acc [G, D]`` then its ``(m, l) [G, 2]``, and one ticket counter per
    (row, KV head)."""
    return split_workspace(device, ("k6", B, KV, n_splits),
                           B * KV * n_splits * K2_GROUP * (HEAD_DIM + 2), B * KV)


def paged_kernel_takes(bs: int) -> bool:
    """Whether the kernel takes pool blocks of ``bs`` positions: a multiple
    of ``BLOCK_SIZE_UNIT`` up to ``MAX_BLOCK_SIZE``."""
    return 0 < bs <= MAX_BLOCK_SIZE and bs % BLOCK_SIZE_UNIT == 0


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


def _combine(parts, KV: int, G: int, D: int, device) -> torch.Tensor:
    """The splits' ``(m, l, acc)`` partials of one row, combined in split
    order as the kernel combines them: ``m = max m_i``, ``l = sum l_i
    e^(m_i - m)``, ``out = sum acc_i e^(m_i - m) / max(l, 1e-30)``."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros(KV, G, D, device=device)
    for m_i, l_i, acc_i in parts:
        w = torch.exp(m_i - m)
        l = l + l_i * w
        acc = acc + acc_i * w
    return acc / l.clamp_min(1e-30)


def paged_flash_decode_plain(q: torch.Tensor, pool_k: torch.Tensor,
                             pool_v: torch.Tensor, tables: torch.Tensor,
                             positions: torch.Tensor, layer: int = 0,
                             chunk: int = 1, scale: Optional[float] = None,
                             split: Optional[int] = None) -> torch.Tensor:
    """K6's bf16 function (K7's with ``chunk=1`` on a one-layer stack) in
    PyTorch, on the kernel's partition (:func:`paged_geometry`; ``split``
    forces the entries a split takes): per batch row and active split, one
    online fp32 softmax update per span, p rounded to bf16 before the PV
    product, then the splits combined in split order. ``pool_k``/``pool_v``:
    ``[L, n_blocks, KV, bs, D]``."""
    B, _, H, D = q.shape
    KV, bs = pool_k.shape[2], pool_k.shape[3]
    M = tables.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    pk, pv = pool_k[layer], pool_v[layer]
    tbl, pos = tables.tolist(), positions.tolist()
    geo = paged_geometry(B, KV, M, bs, pos, chunk, split)
    out = torch.empty_like(q)
    for b in range(B):
        qb = q[b, 0].reshape(KV, G, D).float()
        parts = []
        for s in range(geo.active_splits[b]):
            acc = torch.zeros(KV, G, D, device=q.device)
            m = torch.full((KV, G, 1), NEG_INF, device=q.device)
            l = torch.zeros(KV, G, 1, device=q.device)
            for a, a1 in geo.spans(b, s):
                blocks = tbl[b][a:a1]
                n = len(blocks) * bs
                kt = pk[blocks].transpose(0, 1).reshape(KV, n, D).float()
                vt = pv[blocks].transpose(0, 1).reshape(KV, n, D).float()
                s_ = (qb @ kt.transpose(-1, -2)) * scale                # [KV, G, span]
                t_pos = a * bs + torch.arange(n, device=q.device)
                s_ = torch.where(t_pos <= pos[b], s_, NEG_INF)
                m_new = torch.maximum(m, s_.amax(-1, keepdim=True))
                p = torch.exp(s_ - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.to(torch.bfloat16).float() @ vt
                m = m_new
            parts.append((m, l, acc))
        out[b, 0] = _combine(parts, KV, G, D, q.device).reshape(H, D).to(q.dtype)
    return out


def paged_flash_decode_int8_plain(q: torch.Tensor, pool_k: torch.Tensor,
                                  pool_v: torch.Tensor, pool_ks: torch.Tensor,
                                  pool_vs: torch.Tensor, tables: torch.Tensor,
                                  positions: torch.Tensor, layer: int = 0,
                                  scale: Optional[float] = None,
                                  split: Optional[int] = None) -> torch.Tensor:
    """K6's int8 function in PyTorch, on the kernel's partition: per batch
    row, active split and used block, every KV head's scores from int8
    dots, the online fp32 softmax, and p folded with the v scales and
    quantized per row over the block, as the Pallas kernel computes it;
    then the splits combined in split order (a split's edge is a block's, so
    the quantization rows are the Pallas kernel's)."""
    B, _, H, D = q.shape
    KV, bs = pool_k.shape[2], pool_k.shape[3]
    M = tables.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    pk, pv, pks, pvs = pool_k[layer], pool_v[layer], pool_ks[layer], pool_vs[layer]
    tbl, pos = tables.tolist(), positions.tolist()
    geo = paged_geometry(B, KV, M, bs, pos, 1, split)
    out = torch.empty_like(q)
    for b in range(B):
        q_i, qs = quantize_q_rows(q[b, 0].reshape(KV, G, D))
        parts = []
        for s in range(geo.active_splits[b]):
            acc = torch.zeros(KV, G, D, device=q.device)
            m = torch.full((KV, G, 1), NEG_INF, device=q.device)
            l = torch.zeros(KV, G, 1, device=q.device)
            for j in range(*geo.split_entries(b, s)):
                blk = tbl[b][j]
                s_ = int8_scores(q_i, qs, pk[blk], pks[blk].float(), scale)   # [KV, G, bs]
                t_pos = j * bs + torch.arange(bs, device=q.device)
                s_ = torch.where(t_pos <= pos[b], s_, NEG_INF)
                m_new = torch.maximum(m, s_.amax(-1, keepdim=True))
                p = torch.exp(s_ - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + int8_pv(p, pv[blk], pvs[blk].float())
                m = m_new
            parts.append((m, l, acc))
        out[b, 0] = _combine(parts, KV, G, D, q.device).reshape(H, D).to(q.dtype)
    return out


def _require_kernel_shape(q, tensors) -> None:
    H, D = q.shape[2], q.shape[3]
    KV, bs = tensors[0].shape[2], tensors[0].shape[3]
    if D != HEAD_DIM or H // KV != K2_GROUP:
        raise ValueError(f"the paged kernels are built for head_dim {HEAD_DIM} and "
                         f"G = H/KV = {K2_GROUP}, got {D} and {H // KV}")
    if not paged_kernel_takes(bs):
        raise ValueError(f"the paged kernels take pool blocks of a multiple of "
                         f"{BLOCK_SIZE_UNIT} positions up to {MAX_BLOCK_SIZE}, got {bs}")
    for t in (q, *tensors):
        if t.data_ptr() % 16:
            raise ValueError("the paged kernels take 16-byte aligned tensors")


def _launch(entry: str, q, pools, tables, positions, layer: int, chunk: Optional[int],
            scale: float, split: Optional[int],
            lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """Launch the kernel on a bf16 pool (``pools = (k, v)``, with the span
    ``chunk``) or an int8 one (``pools = (k, v, k_scale, v_scale)``,
    ``chunk=None``), split by :func:`paged_split` unless ``split`` forces
    one. ``lib`` is another build of the same source (``k6_breakdown``)."""
    _require_kernel_shape(q, pools)
    B, _, H, D = q.shape
    L, n_blocks, KV, bs, _ = pools[0].shape
    M = tables.shape[1]
    split = paged_split(B, KV, M, bs) if split is None else split
    n_splits = paged_n_splits(M, split)
    parts, tickets = paged_scratch(q.device, B, KV, n_splits)
    ml = parts.data_ptr() + B * KV * n_splits * K2_GROUP * D * parts.element_size()
    out = torch.empty_like(q)
    fn = getattr(lib or library("paged_attention"), entry)
    fn.restype = ctypes.c_int
    ints = [B, H, KV, M, n_blocks, bs] + ([] if chunk is None else [chunk]) + [split, layer]
    fn.argtypes = [ctypes.c_void_p] * (len(pools) + 7) + [ctypes.c_int] * len(ints) + [
        ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), *(t.data_ptr() for t in pools), tables.data_ptr(),
                 positions.data_ptr(), out.data_ptr(), parts.data_ptr(), ml,
                 tickets.data_ptr(), *ints, scale, cuda_stream(q.device))
    check_launch(err, entry.removeprefix("lnb_"))
    return out


def paged_flash_decode_int8(q, pool_k, pool_v, pool_ks, pool_vs, tables, positions,
                            layer: int, scale: float,
                            split: Optional[int] = None) -> torch.Tensor:
    """K6 on an int8 pool. Arguments as :func:`paged_flash_decode`'s, already
    checked, stacked pools, ``[B]`` int32 positions on the card."""
    out = _launch("lnb_paged_decode_int8", q, (pool_k, pool_v, pool_ks, pool_vs), tables,
                  positions, layer, None, scale, split)
    paged_flash_decode_int8.launches += 1
    return out


def paged_flash_decode_per_head(q, pool_k, pool_v, tables, positions,
                                scale: float, split: Optional[int] = None) -> torch.Tensor:
    """K7: one update per bs-key block, over a single-layer bf16 pool lifted
    to a one-layer stack. Arguments already checked, ``[B]`` int32 positions
    on the card."""
    out = _launch("lnb_paged_decode", q, (pool_k, pool_v), tables, positions, 0, 1,
                  scale, split)
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
    split: Optional[int] = None,   # table entries a split takes; None: paged_split's
) -> torch.Tensor:
    """Returns ``[B, 1, H, D]`` bf16; row ``b`` attends the pool slots
    holding its positions ``<= positions[b]`` (its just-written row
    included). CUDA tensors launch K6 or K7 as the module docstring says;
    CPU tensors take the plain version of the same function. Refuses what
    the JAX function refuses: ``layer`` or an int8 pool without
    ``fold_heads``. ``split`` forces the partition of the table walk (tests
    and ``k6_splits``); the model's path leaves it to :func:`paged_split`."""
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
                                                 tables, positions, layer, scale, split)
        return paged_flash_decode_int8(q, pool_k, pool_v, pool_ks, pool_vs, tables,
                                       positions, layer, scale, split)
    chunk = paged_chunk(tables.shape[1], pool_k.shape[3]) if fold_heads else 1
    if cpu:
        return paged_flash_decode_plain(q, pool_k, pool_v, tables, positions, layer,
                                        chunk, scale, split)
    if not fold_heads:
        return paged_flash_decode_per_head(q, pool_k, pool_v, tables, positions, scale,
                                           split)
    out = _launch("lnb_paged_decode", q, (pool_k, pool_v), tables, positions, layer, chunk,
                  scale, split)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
paged_flash_decode_int8.launches = 0
paged_flash_decode_per_head.launches = 0
