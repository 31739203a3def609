"""Ring attention: exact causal GQA attention with the sequence sharded on sp.

Port of ``llama_nuts_and_bolts_tpu/parallel/ring_attention.py``. Each sp
rank holds a chunk of the prompt's rows; K/V chunks travel around the ring
(:func:`parallel.mesh.rotate`, the counterpart of ``lax.ppermute``) while
each query row keeps an online softmax in fp32. A step's scores are
``[B, KV, G, S/sp, S/sp]``, never ``[S, S]``: the ring exists for its
memory. A rank's chunks (this module works on its own, no global arrays):

  q     [B, S/sp, H/tp, D]
  k, v  [B, KV/tp, S/sp, D]
  out   like q

Causality is evaluated in global positions: query row ``start_pos + i``
sees key column ``start_pos + j`` iff ``j <= i``, the ``attention_mask`` of
an unsharded prefill of the current segment only (the cache's earlier rows
are not read).

The JAX body is XLA, not Pallas, so this is plain PyTorch. JAX forms
``Q·K`` and ``P·V`` from bf16 operands with fp32 accumulation; a bf16
``torch.matmul`` would round its output to bf16, so both products are formed
in fp32 from the bf16 values (exact products, summed in fp32) with TF32 off.
"""

from __future__ import annotations

import contextlib
import math

import torch

from llama_nuts_and_bolts_tpu_torch.parallel.mesh import axis_rank, axis_size, rotate

NEG_INF = -1e30


@contextlib.contextmanager
def _fp32_matmul():
    """fp32 products without TF32's 10-bit mantissa, restored after."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def ring_gqa_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       start_pos: int, *, scale=None, axis: str = "sp") -> torch.Tensor:
    """Exact causal attention of this rank's query chunk over every rank's
    key chunk, the chunks rotated ``sp`` times (``_local_ring``): after
    ``r`` rotations a rank holds the chunk of rank ``(idx - r) % sp``."""
    B, Sl, H, D = q.shape
    KV = k.shape[1]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    sp, idx = axis_size(mesh, axis), axis_rank(mesh, axis)
    dev = q.device
    # [B, KV, G, Sl, D]: the bf16 values held exactly in fp32
    qg = q.to(torch.bfloat16).reshape(B, Sl, KV, G, D).permute(0, 2, 3, 1, 4).float()
    row_pos = start_pos + idx * Sl + torch.arange(Sl, device=dev)
    acc = torch.zeros((B, KV, G, Sl, D), dtype=torch.float32, device=dev)
    m = torch.full((B, KV, G, Sl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sl), dtype=torch.float32, device=dev)
    with _fp32_matmul():
        for r in range(sp):
            src = (idx - r) % sp
            col_pos = start_pos + src * Sl + torch.arange(Sl, device=dev)
            kf = k.to(torch.bfloat16).float()[:, :, None]            # [B, KV, 1, Sl, D]
            s = torch.matmul(qg, kf.transpose(-1, -2)) * scale       # [B, KV, G, Sl, Sl]
            visible = col_pos[None, :] <= row_pos[:, None]
            s = torch.where(visible, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            correction = torch.exp(m - m_new)
            l = l * correction + p.sum(-1)
            pv = torch.matmul(p.to(torch.bfloat16).float(),
                              v.to(torch.bfloat16).float()[:, :, None])
            acc = acc * correction[..., None] + pv
            m = m_new
            k = rotate(k, mesh, axis)
            v = rotate(v, mesh, axis)
    out = acc / torch.clamp_min(l[..., None], 1e-30)               # [B, KV, G, Sl, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sl, H, D).to(q.dtype)
