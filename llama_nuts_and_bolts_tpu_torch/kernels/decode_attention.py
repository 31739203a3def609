"""K2, K3, K4, K5: S=1 flash decode attention over a bf16 or int8 KV cache.

Port of ``llama_nuts_and_bolts_tpu/kernels/decode_attention.py::flash_decode_attention``.
Batch row ``b`` attends cache slots ``t <= start_pos[b]`` of layer ``layer``;
tiles past a row's position are never read. With ``blocked=True`` three CUDA
kernels serve it, each with a plain PyTorch version beside it that CPU
tensors take:

  * K2, a bf16 cache (``_decode_kernel_blocked``): ``csrc/decode_attention.cu``;
    counted in ``flash_decode_attention.launches``. Its key walk is split
    over ``(splits, KV, B)`` blocks (:func:`k2_split_k`, from shapes only),
    each split's partial softmax combined in split order by the split that
    finishes last, inside the same launch; :func:`k2_scratch` holds the
    partials and tickets.
  * K3, an int8 cache with per-position bf16 scales ``[L, B, KV, T]``, each
    element dequantized to ``bf16(bf16(int8) * bf16(scale))`` before the
    products: the same kernel built for int8 tiles; counted in
    ``flash_decode_attention_q8.launches``.
    :func:`flash_decode_attention_plain` computes K2's and K3's function.
  * K4, ``fold_heads=True`` (``_decode_kernel_blocked_heads``). Folding the KV
    heads into one program amortises TPU grid steps and has no numerical
    meaning, so its bf16 mode and its int8 dequantizing mode compute K2's and
    K3's functions, and launch those kernels (only the tile partition of the
    online softmax differs). Its ``int8_mxu`` mode -- every decode step on an
    int8 cache -- is a kernel of its own, ``csrc/decode_attention_int8.cu``:
    q quantized per row, int8 x int8 -> int32 dots, the v scales folded into
    p before p is quantized per row over the whole tile
    (``kernels/quant_attn_math.py``). Its numerics depend on the tile, so the
    kernel, :func:`flash_decode_attention_int8_mxu_plain` and the wrapper all
    take it from :func:`decode_block_k`; counted in
    ``flash_decode_attention_int8_mxu.launches``. A thread-block cluster of
    :func:`k4_cluster` blocks serves each (KV head, row), every rank a
    contiguous slice of each tile (:class:`K4Geometry`); the tile-wide max
    and quantization scale cross the cluster, so the function stays the
    tile's, whatever the cluster.

K5, ``blocked=False`` (``_decode_kernel``), is the whole-head kernel over a
single-layer ``[B, KV, T, D]`` cache (``layer=`` raises, as in the JAX
package). Its function is K2's (K3's on an int8 cache, whose tiles the Pallas
kernel dequantizes to ``bf16(f32(int8) * f32(scale))``, the same bf16 value):
:func:`flash_decode_attention_whole_head` launches K2's or K3's kernel on a
one-layer view of the cache and counts its own launches. Its Pallas tiles are
``min(512, T)`` keys, K2's 64: only the partition of the online softmax
differs, within the bf16 tolerance K2 is held to against JAX's tiles.

In PyTorch ``cache.k[li]`` is a free view, so the JAX ``layer`` prefetch
scalar has no job left; ``layer=`` is kept so that both packages are called
alike.
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
from llama_nuts_and_bolts_tpu_torch.kernels.quant_attn_math import (
    int8_pv,
    int8_scores,
    quantize_q_rows,
)

NEG_INF = -1e30
HEAD_DIM = 128        # the only head width on the main path
K2_BLOCK_K = 64       # cache positions per tile (K2, K3)
K2_GROUP = 4          # H / KV the kernels are built for: Llama-3.1-8B's 32 / 8
K2_TARGET_BLOCKS = 256  # blocks of a call when every split is active: ~2 per SM of 132
K2_MAX_SPLITS = 256   # splits of one row the kernel's combine takes (csrc: MAX_SPLITS)
FOLD_TILE_BYTES = 2 * 1024 * 1024
# K4's cluster rule and partition (csrc/decode_attention_int8.cu)
K4_TARGET_BLOCKS = 64   # blocks a call should reach: C * B * KV
K4_MIN_CHUNK = 16       # keys a rank takes of a tile, at least (any cluster)
# keys a rank takes of a tile, at least, in the clusters the rule picks: a
# split tile pays two exchanges across the cluster, which a short tile does
# not earn back (kernels/k4_clusters.py times the rule's size beside 8 at
# T=256; PERF.md §6)
K4_RULE_CHUNK = 256
K4_CLUSTERS = (1, 2, 4, 8, 16)  # 16 only when forced: needs a non-portable cluster
K4_MAX_CLUSTER = 8      # the most the rule picks (the portable cluster size)
K4_PIECE = 256          # keys of one bulk copy, at most


def k2_split_k(B: int, KV: int, T: int) -> int:
    """Keys per split of K2/K3's key walk: the smallest power-of-two
    multiple of the tile, from two tiles up, that cuts the ``B * KV`` cache
    heads of length ``T`` into at most about ``K2_TARGET_BLOCKS`` blocks,
    and at most one split per head for a short cache. A function of shapes
    only, never of positions: the wrapper launches without reading them
    back. (On an H100 a split of one tile measured slower at every shape:
    more splits to combine, or more blocks than the SMs hold at once.)"""
    want = -(-B * KV * T // K2_TARGET_BLOCKS)
    split = 2 * K2_BLOCK_K
    while split < T and (split < want or -(-T // split) > K2_MAX_SPLITS):
        split *= 2
    return split


@dataclass(frozen=True)
class K2Geometry:
    """Launch arithmetic shared by the K2/K3 kernel and the plain version:
    split ``s`` of row ``b`` covers keys ``[s * split_k, (s + 1) * split_k)``
    in 64-key tiles; the splits past a row's position read nothing."""

    split_k: int
    grid: Tuple[int, int, int]    # (splits, kv heads, batch)
    n_keys: List[int]             # visible keys of each batch row
    active_splits: List[int]      # splits of each row that run (split 0 always)

    def split_keys(self, b: int, s: int) -> Tuple[int, int]:
        """The keys ``[start, end)`` that active split ``s`` of row ``b`` reads."""
        start = s * self.split_k
        return start, max(start, min(start + self.split_k, self.n_keys[b]))


def k2_geometry(B: int, KV: int, T: int, positions: List[int]) -> K2Geometry:
    split = k2_split_k(B, KV, T)
    n_keys = [max(0, min(p + 1, T)) for p in positions]
    return K2Geometry(split_k=split, grid=(-(-T // split), KV, B), n_keys=n_keys,
                      active_splits=[max(1, -(-n // split)) for n in n_keys])


def k4_cluster_takes(block_k: int, cluster: int) -> bool:
    """Whether K4 can cut a ``block_k`` tile over ``cluster`` ranks: a
    cluster size it is built for, and chunks of whole 8-key units (16-byte
    copies of the bf16 scales), 16 keys at least when the tile is split."""
    chunk = block_k // cluster
    return (cluster in K4_CLUSTERS and block_k % cluster == 0 and chunk % 8 == 0
            and (cluster == 1 or chunk >= K4_MIN_CHUNK))


def k4_cluster(B: int, KV: int, T: int, block_k: int) -> int:
    """K4's cluster size, from shapes only, never positions: the smallest
    power of two up to ``K4_MAX_CLUSTER`` whose ``C * B * KV`` blocks reach
    ``K4_TARGET_BLOCKS`` while every rank keeps ``K4_RULE_CHUNK`` keys of a
    tile, else the largest such. At B=1, KV=8 and a 2048-key tile that is 8
    (64 blocks on the H100's 132 SMs), at B=4 2, at B=16 1; a 256-key tile
    (T=256) is never split. The tile, not ``T``, bounds the split."""
    C = 1
    while (C < K4_MAX_CLUSTER and C * B * KV < K4_TARGET_BLOCKS
           and block_k // (2 * C) >= K4_RULE_CHUNK and k4_cluster_takes(block_k, 2 * C)):
        C *= 2
    return C


@dataclass(frozen=True)
class K4Geometry:
    """K4's launch arithmetic: a ``(cluster, KV, B)`` grid in clusters of
    ``(cluster, 1, 1)``; rank ``r`` owns keys ``[t0 + r * chunk, t0 + (r + 1)
    * chunk)`` of the tile at ``t0``, copied in pieces of at most ``piece``
    keys (only the visible ones)."""

    cluster: int
    block_k: int
    chunk: int
    piece: int
    grid: Tuple[int, int, int]

    def rank_keys(self, n_keys: int, t0: int, r: int) -> Tuple[int, int]:
        """The visible keys ``[start, end)`` rank ``r`` reads of the tile at
        ``t0`` in a row with ``n_keys`` of them (empty past the position)."""
        start = t0 + r * self.chunk
        return start, max(start, min(start + self.chunk, n_keys))

    def active_ranks(self, n_keys: int, t0: int) -> int:
        """How many ranks hold visible keys of the tile at ``t0``."""
        return min(self.cluster, max(0, -(-(n_keys - t0) // self.chunk)))

    def copies(self, n_keys: int, t0: int, r: int) -> List[Tuple[int, int, int]]:
        """Rank ``r``'s bulk copies of the tile at ``t0``, per k piece and
        then per v piece: ``(first key, row bytes, scale bytes)``. A k piece
        carries both scale rows, each rounded up to 16-byte units; a v piece
        carries none."""
        start, end = self.rank_keys(n_keys, t0, r)
        out = []
        for kind in (0, 1):
            for key in range(start, end, self.piece):
                n = min(self.piece, end - key)
                out.append((key, n * HEAD_DIM, 0 if kind else 2 * (-(-n // 8) * 8) * 2))
        return out


def k4_geometry(B: int, KV: int, T: int, block_k: int,
                cluster: Optional[int] = None) -> K4Geometry:
    """The geometry of a K4 launch: :func:`k4_cluster`'s size unless
    ``cluster`` forces one."""
    C = k4_cluster(B, KV, T, block_k) if cluster is None else cluster
    if not k4_cluster_takes(block_k, C):
        raise ValueError(f"K4 cannot cut a {block_k}-key tile over a cluster of {C}: "
                         f"sizes {K4_CLUSTERS}, chunks of 8k keys, at least "
                         f"{K4_MIN_CHUNK} when split")
    chunk = block_k // C
    return K4Geometry(cluster=C, block_k=block_k, chunk=chunk, piece=min(chunk, K4_PIECE),
                      grid=(C, KV, B))


def decode_block_k(T: int, kv_heads: int, head_dim: int, quantized: bool,
                   block_k: Optional[int] = None) -> int:
    """K4's cache tile. With ``block_k=None`` the model's choice first
    (``models/llama/model.py:204-211`` of the JAX package: the largest of
    2048..128 that divides T), then the folded kernel's 2 MB rule
    (``kernels/decode_attention.py:311-313,335-339``). An int8 cache at
    KV=8, D=128 gets 2048, a bf16 one 1024, a 256-slot cache 256."""
    if block_k is None:
        block_k = next((b for b in (2048, 1024, 512, 256, 128) if T % b == 0), T)
        if block_k == T and T > 2048:
            raise ValueError(f"flash decode needs a cache length divisible by 128 "
                             f"(got {T}); use attn_impl='plain' or a padded buffer")
    block_k = min(block_k, T)
    if T % block_k:
        raise ValueError(f"cache length {T} must be a multiple of block_k={block_k}")
    per_slot = kv_heads * head_dim * (1 if quantized else 2)
    while block_k * per_slot > FOLD_TILE_BYTES and block_k > 128:
        block_k //= 2
    if T % block_k:
        block_k = next((b for b in (512, 256, 128) if T % b == 0), T)
    return block_k


def _positions(start_pos, B: int, device: torch.device) -> torch.Tensor:
    """A ``[B]`` int32 tensor on ``device``; an int broadcasts to every row."""
    if isinstance(start_pos, int):
        if start_pos < 0:
            raise ValueError(f"negative start_pos {start_pos}")
        return torch.full((B,), start_pos, dtype=torch.int32, device=device)
    if not isinstance(start_pos, torch.Tensor) or start_pos.dtype != torch.int32:
        raise TypeError("decode attention takes an int or an int32 [B] tensor of "
                        "positions")
    if start_pos.shape != (B,) or start_pos.device != device:
        raise ValueError(f"positions must be [B={B}] on {device}, got "
                         f"{tuple(start_pos.shape)} on {start_pos.device}")
    return start_pos.contiguous()


def _check(q, k, v, k_scale, v_scale, layer):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode attention is the S=1 kernel: q [B,1,H,D], got "
                         f"{tuple(q.shape)}")
    if k.dim() != 5 or v.shape != k.shape:
        raise ValueError(f"expected stacked k/v [L,B,KV,T,D], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    L, Bk, KV, T, Dk = k.shape
    if Bk != B or Dk != D or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if D != HEAD_DIM:
        raise ValueError(f"decode attention supports head_dim {HEAD_DIM}, got {D}")
    if not isinstance(layer, int) or not 0 <= layer < L:
        raise ValueError(f"layer must be an int in [0, {L}), got {layer!r}")
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 cache comes with k_scale and v_scale, a bf16 "
                         "cache without")
    cache_dtype = torch.int8 if quantized else torch.bfloat16
    named = [("q", q, torch.bfloat16), ("k", k, cache_dtype), ("v", v, cache_dtype)]
    if quantized:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(s.shape) != tuple(k.shape[:-1]):
                raise ValueError(f"{name} must be [L,B,KV,T] = {tuple(k.shape[:-1])}, "
                                 f"got {tuple(s.shape)}")
        named += [("k_scale", k_scale, torch.bfloat16), ("v_scale", v_scale, torch.bfloat16)]
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"decode attention takes {dtype} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"decode attention takes a contiguous {name}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.data_ptr() % 16 and name in ("q", "k", "v"):
            raise ValueError(f"decode attention takes a 16-byte aligned {name}")


def _dequant_tile(t: torch.Tensor, s: Optional[torch.Tensor]) -> torch.Tensor:
    """A cache tile as the kernels' products see it: bf16, or for int8
    ``bf16(bf16(int8) * bf16(scale))`` per element; returned in fp32."""
    if s is None:
        return t.float()
    return (t.to(torch.bfloat16) * s[..., None]).float()


def flash_decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, positions: torch.Tensor,
                                 layer: int = 0, k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2's (bf16 cache) and K3's (int8 cache with scales) function in
    PyTorch, on the kernel's partition: per batch row, each active split
    (:func:`k2_geometry`) runs the online fp32 softmax over its own 64-key
    tiles with p rounded to bf16, then the splits' ``(m, l, acc)`` combine
    in split order: ``m = max m_i``, ``l = sum l_i e^(m_i - m)``,
    ``out = sum acc_i e^(m_i - m) / max(l, 1e-30)``."""
    B, _, H, D = q.shape
    KV, T = k.shape[2], k.shape[3]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    geo = k2_geometry(B, KV, T, positions.tolist())
    out = torch.empty_like(q)
    for b in range(B):
        qb = q[b, 0].reshape(KV, G, D).float()
        parts = []
        for s in range(geo.active_splits[b]):
            k0, k1 = geo.split_keys(b, s)
            acc = torch.zeros(KV, G, D, device=q.device)
            m = torch.full((KV, G, 1), NEG_INF, device=q.device)
            l = torch.zeros(KV, G, 1, device=q.device)
            for t0 in range(k0, k1, K2_BLOCK_K):
                sl = (layer, b, slice(None), slice(t0, min(k1, t0 + K2_BLOCK_K)))
                ks = None if k_scale is None else k_scale[sl]
                vs = None if v_scale is None else v_scale[sl]
                kt, vt = _dequant_tile(k[sl], ks), _dequant_tile(v[sl], vs)
                s_ = (qb @ kt.transpose(-1, -2)) * scale           # [KV,G,tile]
                m_new = torch.maximum(m, s_.amax(-1, keepdim=True))
                p = torch.exp(s_ - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.to(torch.bfloat16).float() @ vt
                m = m_new
            parts.append((m, l, acc))
        m = torch.stack([p[0] for p in parts]).amax(0)
        l = torch.zeros_like(m)
        acc = torch.zeros(KV, G, D, device=q.device)
        for m_i, l_i, acc_i in parts:
            w = torch.exp(m_i - m)
            l = l + l_i * w
            acc = acc + acc_i * w
        out[b, 0] = (acc / l.clamp_min(1e-30)).reshape(H, D).to(q.dtype)
    return out


def flash_decode_attention_int8_mxu_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_scale: torch.Tensor,
        v_scale: torch.Tensor, positions: torch.Tensor, layer: int,
        block_k: int) -> torch.Tensor:
    """K4's ``int8_mxu`` function in PyTorch, as the Pallas kernel computes it:
    per batch row and ``block_k`` tile up to its position, every KV head's
    scores from int8 dots, the online fp32 softmax, and p folded with the v
    scales and quantized per row over the whole tile."""
    B, _, H, D = q.shape
    KV, T = k.shape[2], k.shape[3]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    for b, p_b in enumerate(positions.tolist()):
        q_i, qs = quantize_q_rows(q[b, 0].reshape(KV, G, D))       # per head row
        acc = torch.zeros(KV, G, D, device=q.device)
        m = torch.full((KV, G, 1), NEG_INF, device=q.device)
        l = torch.zeros(KV, G, 1, device=q.device)
        for kb in range(-(-min(p_b + 1, T) // block_k)):
            sl = (layer, b, slice(None), slice(kb * block_k, (kb + 1) * block_k))
            s = int8_scores(q_i, qs, k[sl], k_scale[sl].float(), scale)
            k_pos = kb * block_k + torch.arange(block_k, device=q.device)
            s = torch.where(k_pos <= p_b, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + int8_pv(p, v[sl], v_scale[sl].float())
            m = m_new
        out[b, 0] = (acc / l.clamp_min(1e-30)).reshape(H, D).to(q.dtype)
    return out


def _require_group(H: int, KV: int) -> None:
    if H // KV != K2_GROUP:
        raise ValueError(f"the decode kernels are built for G = H/KV = {K2_GROUP}, "
                         f"got {H // KV}")


def k2_scratch(device: torch.device, B: int, KV: int,
               n_splits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2/K3's workspace for a launch on the current stream
    (:func:`build.split_workspace`): every split's fp32 partial
    ``acc [G, D]`` then its ``(m, l) [G, 2]``, and one ticket counter per
    (row, KV head)."""
    return split_workspace(device, ("k2", B, KV, n_splits),
                           B * KV * n_splits * K2_GROUP * (HEAD_DIM + 2), B * KV)


def _decode_kernel(entry: str, q, k, v, scales, positions, layer,
                   lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """Launch the bf16 (``scales=()``) or int8 (``scales=(k_scale,
    v_scale)``) cache kernel: K2's or K3's, and K5's on a one-layer view.
    ``lib`` is another build of the same source (``k2_breakdown``)."""
    B, _, H, D = q.shape
    KV, T = k.shape[2], k.shape[3]
    _require_group(H, KV)
    split = k2_split_k(B, KV, T)
    parts, tickets = k2_scratch(q.device, B, KV, -(-T // split))
    out = torch.empty_like(q)
    fn = getattr(lib or library("decode_attention"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (8 + len(scales)) + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    ml = parts.data_ptr() + B * KV * (-(-T // split)) * K2_GROUP * D * parts.element_size()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 *(s.data_ptr() for s in scales), positions.data_ptr(), out.data_ptr(),
                 parts.data_ptr(), ml, tickets.data_ptr(), B, H, KV, T, layer, split,
                 1.0 / math.sqrt(D), cuda_stream(q.device))
    check_launch(err, entry.removeprefix("lnb_"))
    return out


def _k2_kernel(q, k, v, positions, layer) -> torch.Tensor:
    """Launch the bf16 cache kernel (K2's, and K5's on a one-layer view)."""
    return _decode_kernel("lnb_flash_decode_attention", q, k, v, (), positions, layer)


def _k3_kernel(q, k, v, k_scale, v_scale, positions, layer) -> torch.Tensor:
    """Launch the int8 cache kernel (K3's, and K5's on a one-layer view)."""
    return _decode_kernel("lnb_flash_decode_attention_q8", q, k, v, (k_scale, v_scale),
                          positions, layer)


def _launch_k2(q, k, v, positions, layer) -> torch.Tensor:
    """K2: the bf16 cache kernel."""
    out = _k2_kernel(q, k, v, positions, layer)
    flash_decode_attention.launches += 1
    return out


def flash_decode_attention_q8(q, k, v, k_scale, v_scale, positions,
                              layer: int) -> torch.Tensor:
    """K3: the int8 cache kernel (K2's, built for int8 tiles and their
    per-position scales). Arguments as :func:`flash_decode_attention`'s,
    already checked, with ``[B]`` int32 positions on the card."""
    out = _k3_kernel(q, k, v, k_scale, v_scale, positions, layer)
    flash_decode_attention_q8.launches += 1
    return out


def flash_decode_attention_whole_head(q, k, v, positions, k_scale=None,
                                      v_scale=None) -> torch.Tensor:
    """K5: ``blocked=False`` over a single-layer cache lifted to a one-layer
    stack (``[1, B, KV, T, D]``, scales ``[1, B, KV, T]``), on K2's kernel
    for a bf16 cache and K3's for an int8 one. Arguments already checked,
    ``[B]`` int32 positions on the card."""
    if k.dtype == torch.int8:
        out = _k3_kernel(q, k, v, k_scale, v_scale, positions, 0)
    else:
        out = _k2_kernel(q, k, v, positions, 0)
    flash_decode_attention_whole_head.launches += 1
    return out


def flash_decode_attention_int8_mxu(q, k, v, k_scale, v_scale, positions,
                                    layer: int, block_k: int,
                                    cluster: Optional[int] = None) -> torch.Tensor:
    """K4 ``int8_mxu``: the int8-dot cluster kernel over ``block_k`` tiles.
    Arguments as :func:`flash_decode_attention`'s, already checked.
    ``cluster`` is the blocks a (KV head, row) takes; the model's path
    leaves it to :func:`k4_cluster` (None), tests and ``k4_clusters`` force
    other sizes with it. The function does not depend on it."""
    B, _, H, D = q.shape
    KV, T = k.shape[2], k.shape[3]
    _require_group(H, KV)
    if T % block_k:
        raise ValueError(f"cache length {T} must be a multiple of block_k={block_k}")
    geo = k4_geometry(B, KV, T, block_k, cluster)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.data_ptr() % 16:
            raise ValueError(f"the K4 kernel takes a 16-byte aligned {name}")
    out = torch.empty_like(q)
    fn = library("decode_attention_int8").lnb_flash_decode_int8_mxu
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                 v_scale.data_ptr(), positions.data_ptr(), out.data_ptr(), B, H, KV,
                 T, layer, block_k, geo.cluster, 1.0 / math.sqrt(D),
                 cuda_stream(q.device))
    check_launch(err, "flash_decode_attention_int8_mxu")
    flash_decode_attention_int8_mxu.launches += 1
    return out


def flash_decode_attention(
    q: torch.Tensor,          # [B, 1, H, D] bf16
    k: torch.Tensor,          # [L, B, KV, T, D] bf16/int8 with layer, else [B, KV, T, D]
    v: torch.Tensor,
    start_pos,                # int, or int32 [B] tensor of per-row positions
    k_scale=None,             # bf16 [L, B, KV, T] ([B, KV, T] without layer) for int8
    v_scale=None,
    blocked: bool = True,
    layer: Optional[int] = None,
    fold_heads: bool = False,
    int8_mxu: bool = False,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Returns ``[B, 1, H, D]`` bf16. CUDA tensors launch K2, K3, K4 or K5
    as the module docstring says; CPU tensors take the plain version of the
    same function. ``block_k`` matters to K4's ``int8_mxu`` mode only:
    ``None`` takes the model's tile (:func:`decode_block_k`). ``blocked=False``
    (K5) takes a single-layer cache and ignores ``fold_heads``, as the JAX
    function does."""
    if layer is None:
        k, v, layer = k[None], v[None], 0       # a one-layer stack, free view
        if k_scale is not None and v_scale is not None:
            k_scale, v_scale = k_scale[None], v_scale[None]
    elif not blocked:
        raise ValueError("stacked-cache layer mode requires blocked=True")
    _check(q, k, v, k_scale, v_scale, layer)
    B, _, H, D = q.shape
    KV, T = k.shape[2], k.shape[3]
    quantized = k.dtype == torch.int8
    positions = _positions(start_pos, B, q.device)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode attention runs on cuda or cpu tensors, got {q.device}")
    cpu = q.device.type == "cpu"
    if not blocked:
        if cpu:
            return flash_decode_attention_plain(q, k, v, positions, 0, k_scale, v_scale)
        return flash_decode_attention_whole_head(q, k, v, positions, k_scale, v_scale)
    if fold_heads:
        bk = decode_block_k(T, KV, D, quantized, block_k)
    if fold_heads and int8_mxu and quantized:
        if cpu:
            return flash_decode_attention_int8_mxu_plain(q, k, v, k_scale, v_scale,
                                                         positions, layer, bk)
        return flash_decode_attention_int8_mxu(q, k, v, k_scale, v_scale, positions,
                                               layer, bk)
    if cpu:
        return flash_decode_attention_plain(q, k, v, positions, layer, k_scale, v_scale)
    if quantized:
        return flash_decode_attention_q8(q, k, v, k_scale, v_scale, positions, layer)
    return _launch_k2(q, k, v, positions, layer)


flash_decode_attention.launches = 0
flash_decode_attention_q8.launches = 0
flash_decode_attention_int8_mxu.launches = 0
flash_decode_attention_whole_head.launches = 0
