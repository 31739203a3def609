"""K1: causal, cache-bounded GQA flash attention for prefill.

Port of ``llama_nuts_and_bolts_tpu/kernels/attention.py::flash_gqa_attention``.
Query row ``s`` sits at ``start_pos + s`` and sees cache slot ``t`` iff
``t <= start_pos + s``. The CUDA kernel is ``csrc/flash_attention.cu`` (its
header says what bounds it and how it is laid out); :func:`flash_gqa_attention_plain`
computes the same function with the same tiles in PyTorch.

:func:`flash_gqa_attention` launches the kernel for CUDA tensors and runs
the plain version for CPU tensors; there is no other path.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.build import check_launch, library

NEG_INF = -1e30
HEAD_DIM = 128        # the only head width on the main path
K1_ROWS = 128         # query rows per block: (K1_ROWS // G) positions x G heads
K1_BLOCK_K = 64       # cache positions per key tile
K1_GROUP = 4          # H / KV the kernel is built for: Llama-3.1-8B's 32 / 8


@dataclass(frozen=True)
class K1Geometry:
    """Launch arithmetic shared by the kernel and the plain version."""

    block_q: int                  # positions per q tile
    grid: Tuple[int, int, int]    # (q tiles, kv heads, batch)
    k_tiles: List[int]            # key tiles streamed by each q tile

    def last_visible_tile(self, i: int) -> int:
        return self.k_tiles[i] - 1


def k1_geometry(B: int, S: int, H: int, KV: int, T: int,
                start_pos: int) -> K1Geometry:
    G = H // KV
    block_q = K1_ROWS // G
    n_q = -(-S // block_q)
    # keys up to the last position any row of q tile i may see
    k_tiles = [-(-min(T, start_pos + (i + 1) * block_q) // K1_BLOCK_K)
               for i in range(n_q)]
    return K1Geometry(block_q=block_q, grid=(n_q, KV, B), k_tiles=k_tiles)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start_pos):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,S,H,D], k/v [B,KV,T,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    Bk, KV, T, Dk = k.shape
    if Bk != B or Dk != D or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if D != HEAD_DIM:
        raise ValueError(f"K1 supports head_dim {HEAD_DIM}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"K1 takes bf16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"K1 takes a contiguous {name}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"K1 takes a 16-byte aligned {name}")
    if not isinstance(start_pos, int) or start_pos < 0:
        raise ValueError(f"K1 takes a non-negative int start_pos, got {start_pos!r}")


def flash_gqa_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, start_pos: int) -> torch.Tensor:
    """The kernel's function in PyTorch: the same q tiles and key tiles, the
    same online fp32 softmax and bf16 rounding of p before PV."""
    B, S, H, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    geo = k1_geometry(B, S, H, KV, T, start_pos)
    qg = q.reshape(B, S, KV, G, D)
    out = torch.empty_like(q)
    for i, n_k in enumerate(geo.k_tiles):
        p0, p1 = i * geo.block_q, min(S, (i + 1) * geo.block_q)
        rows = (p1 - p0) * G                     # row r <-> position p0 + r // G
        qt = qg[:, p0:p1].permute(0, 2, 1, 3, 4).reshape(B, KV, rows, D).float()
        q_pos = start_pos + p0 + torch.arange(rows, device=q.device)[:, None] // G
        acc = torch.zeros(B, KV, rows, D, device=q.device)
        m = torch.full((B, KV, rows, 1), NEG_INF, device=q.device)
        l = torch.zeros(B, KV, rows, 1, device=q.device)
        for kb in range(n_k):
            t0, t1 = kb * K1_BLOCK_K, min(T, (kb + 1) * K1_BLOCK_K)
            s = (qt @ k[:, :, t0:t1].float().transpose(-1, -2)) * scale
            k_pos = torch.arange(t0, t1, device=q.device)[None, :]
            s = torch.where(k_pos <= q_pos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(torch.bfloat16).float() @ v[:, :, t0:t1].float()
            m = m_new
        o = (acc / l.clamp_min(1e-30)).reshape(B, KV, p1 - p0, G, D)
        out[:, p0:p1] = o.permute(0, 2, 1, 3, 4).reshape(B, p1 - p0, H, D).to(q.dtype)
    return out


def flash_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        start_pos: int) -> torch.Tensor:
    """``q [B,S,H,D]`` bf16 against the cache layer ``k/v [B,KV,T,D]`` bf16,
    queries at ``[start_pos, start_pos + S)``; returns ``[B,S,H,D]`` bf16.
    CUDA tensors launch the kernel (and count it in ``launches``); CPU
    tensors take :func:`flash_gqa_attention_plain`."""
    _check(q, k, v, start_pos)
    B, S, H, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        return flash_gqa_attention_plain(q, k, v, start_pos)
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, got {q.device}")
    if H // KV != K1_GROUP:
        raise ValueError(f"the K1 kernel is built for G = H/KV = {K1_GROUP}, "
                         f"got {H // KV}")
    out = torch.empty_like(q)
    lib = library("flash_attention")
    fn = lib.lnb_flash_gqa_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, KV, T, start_pos, 1.0 / math.sqrt(D), stream)
    check_launch(err, "flash_gqa_attention")
    flash_gqa_attention.launches += 1
    return out


flash_gqa_attention.launches = 0
