"""K2: S=1 flash decode attention over a stacked bf16 KV cache.

Port of ``llama_nuts_and_bolts_tpu/kernels/decode_attention.py::flash_decode_attention``
with ``blocked=True``, ``fold_heads=False`` and a bf16 cache (its
``_decode_kernel_blocked``). Batch row ``b`` attends cache slots
``t <= start_pos[b]`` of layer ``layer``; tiles past a row's position are
never read. The CUDA kernel is ``csrc/decode_attention.cu`` (its header says
what bounds it and how it is laid out); :func:`flash_decode_attention_plain`
computes the same function with the same tiles in PyTorch.

In PyTorch ``cache.k[li]`` is a free view, so the JAX ``layer`` prefetch
scalar has no job left; ``layer=`` is kept so that both packages are called
alike. The int8 cache (K3), ``fold_heads=True`` (K4) and ``blocked=False``
(K5) are other kernels, not yet ported: the wrapper raises on them.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.build import check_launch, library

NEG_INF = -1e30
HEAD_DIM = 128        # the only head width on the main path
K2_BLOCK_K = 64       # cache positions per tile
K2_GROUP = 4          # H / KV the kernel is built for: Llama-3.1-8B's 32 / 8


@dataclass(frozen=True)
class K2Geometry:
    """Launch arithmetic shared by the kernel and the plain version."""

    grid: Tuple[int, int]         # (kv heads, batch)
    k_tiles: List[int]            # tiles streamed by each batch row

    def last_visible_tile(self, b: int) -> int:
        return self.k_tiles[b] - 1


def k2_geometry(B: int, KV: int, T: int, positions: List[int]) -> K2Geometry:
    return K2Geometry(grid=(KV, B),
                      k_tiles=[-(-min(p + 1, T) // K2_BLOCK_K) for p in positions])


def _positions(start_pos, B: int, device: torch.device) -> torch.Tensor:
    """A ``[B]`` int32 tensor on ``device``; an int broadcasts to every row."""
    if isinstance(start_pos, int):
        if start_pos < 0:
            raise ValueError(f"negative start_pos {start_pos}")
        return torch.full((B,), start_pos, dtype=torch.int32, device=device)
    if not isinstance(start_pos, torch.Tensor) or start_pos.dtype != torch.int32:
        raise TypeError("K2 takes an int or an int32 [B] tensor of positions")
    if start_pos.shape != (B,) or start_pos.device != device:
        raise ValueError(f"positions must be [B={B}] on {device}, got "
                         f"{tuple(start_pos.shape)} on {start_pos.device}")
    return start_pos.contiguous()


def _check(q, k, v, k_scale, v_scale, blocked, layer, fold_heads, int8_mxu):
    if k_scale is not None or v_scale is not None or k.dtype == torch.int8:
        raise NotImplementedError("int8 KV cache decode is K3/K4 (ROADMAP.md), "
                                  "not ported yet")
    if fold_heads or int8_mxu:
        raise NotImplementedError("fold_heads/int8_mxu is K4 (ROADMAP.md), "
                                  "not ported yet")
    if not blocked:
        raise NotImplementedError("blocked=False is K5 (ROADMAP.md), not "
                                  "ported yet")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"K2 is the S=1 kernel: q [B,1,H,D], got {tuple(q.shape)}")
    if k.dim() != 5 or v.shape != k.shape:
        raise ValueError(f"expected stacked k/v [L,B,KV,T,D], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    L, Bk, KV, T, Dk = k.shape
    if Bk != B or Dk != D or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if D != HEAD_DIM:
        raise ValueError(f"K2 supports head_dim {HEAD_DIM}, got {D}")
    if not isinstance(layer, int) or not 0 <= layer < L:
        raise ValueError(f"layer must be an int in [0, {L}), got {layer!r}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"K2 takes bf16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"K2 takes a contiguous {name}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"K2 takes a 16-byte aligned {name}")


def flash_decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, positions: torch.Tensor,
                                 layer: int = 0) -> torch.Tensor:
    """The kernel's function in PyTorch: per batch row, the same tiles up to
    its position, the same online fp32 softmax and bf16 rounding of p."""
    B, _, H, D = q.shape
    KV, T = k.shape[2], k.shape[3]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    pos = positions.tolist()
    geo = k2_geometry(B, KV, T, pos)
    out = torch.empty_like(q)
    for b in range(B):
        qb = q[b, 0].reshape(KV, G, D).float()
        acc = torch.zeros(KV, G, D, device=q.device)
        m = torch.full((KV, G, 1), NEG_INF, device=q.device)
        l = torch.zeros(KV, G, 1, device=q.device)
        for kb in range(geo.k_tiles[b]):
            t0, t1 = kb * K2_BLOCK_K, min(T, (kb + 1) * K2_BLOCK_K)
            kt = k[layer, b, :, t0:t1].float()
            s = (qb @ kt.transpose(-1, -2)) * scale                # [KV,G,tile]
            k_pos = torch.arange(t0, t1, device=q.device)
            s = torch.where(k_pos <= pos[b], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(torch.bfloat16).float() @ v[layer, b, :, t0:t1].float()
            m = m_new
        out[b, 0] = (acc / l.clamp_min(1e-30)).reshape(H, D).to(q.dtype)
    return out


def flash_decode_attention(
    q: torch.Tensor,          # [B, 1, H, D] bf16
    k: torch.Tensor,          # [L, B, KV, T, D] bf16 with layer, else [B, KV, T, D]
    v: torch.Tensor,
    start_pos,                # int, or int32 [B] tensor of per-row positions
    k_scale=None,
    v_scale=None,
    blocked: bool = True,
    layer: Optional[int] = None,
    fold_heads: bool = False,
    int8_mxu: bool = False,
) -> torch.Tensor:
    """Returns ``[B, 1, H, D]`` bf16. CUDA tensors launch the kernel (and
    count it in ``launches``); CPU tensors take
    :func:`flash_decode_attention_plain`."""
    if layer is None:
        k, v, layer = k[None], v[None], 0       # a one-layer stack, free view
    _check(q, k, v, k_scale, v_scale, blocked, layer, fold_heads, int8_mxu)
    B, _, H, D = q.shape
    KV, T = k.shape[2], k.shape[3]
    positions = _positions(start_pos, B, q.device)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k, v, positions, layer)
    if q.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, got {q.device}")
    if H // KV != K2_GROUP:
        raise ValueError(f"the K2 kernel is built for G = H/KV = {K2_GROUP}, "
                         f"got {H // KV}")
    out = torch.empty_like(q)
    fn = library("decode_attention").lnb_flash_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
                 out.data_ptr(), B, H, KV, T, layer, 1.0 / math.sqrt(D), stream)
    check_launch(err, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
