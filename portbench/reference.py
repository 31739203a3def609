"""The plain reference: the decoder's forward pass in float32, written from
the architecture's equations in plain PyTorch.

RMSNorm, grouped-query attention with rotary embeddings over interleaved
(re, im) pairs (Meta's layout, the port's; a checkpoint that rotates halves
is the same model up to a fixed permutation of the q and k rows), SwiGLU,
no biases, an untied output head. It imports nothing of the program: it
takes the weights the benchmark made and the tokens, and works out
everything else again (the rotary tables, the masks). Every product runs in
float32 with TF32 off; attention runs in blocks of query rows so that long
sequences fit.

``precision="fp8"`` is the control: the same pass with every projection's
weights rounded to float8 e4m3 per output row and its inputs per token row
(a W8A8 deployment's arithmetic), the step below the configuration's bf16.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch

FP8_MAX = 448.0          # the largest float8 e4m3 value
LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@contextlib.contextmanager
def exact_fp32():
    """float32 products without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to float8 e4m3 with one scale a row, back in
    float32."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rope_tables(theta: float, head_dim: int, n: int, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64) / head_dim
    freqs = 1.0 / (theta ** exps)
    angles = torch.arange(n, dtype=torch.float64)[:, None] * freqs[None, :]
    return (torch.cos(angles).to(torch.float32).to(device),
            torch.sin(angles).to(torch.float32).to(device))


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x [T, heads, D]`` rotated by position over interleaved pairs."""
    T, Hn, D = x.shape
    pairs = x.reshape(T, Hn, D // 2, 2)
    re, im = pairs[..., 0], pairs[..., 1]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([re * c - im * s, re * s + im * c], dim=-1).reshape(T, Hn, D)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


class Reference:
    """The forward pass of one configuration over the benchmark's weights
    (``portbench/weights.py``), at ``precision`` "fp32" or "fp8"."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: Dict,
                 precision: str = "fp32", q_block: int = 512) -> None:
        if cfg.get("use_scaled_rope"):
            raise ValueError("the reference rotates without Llama-3.1's frequency scaling")
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision is fp32 or fp8, got {precision!r}")
        self.w = weights
        self.dim = cfg["dim"]
        self.H = cfg["n_heads"]
        self.KV = cfg["n_kv_heads"]
        self.D = cfg["dim"] // cfg["n_heads"]
        self.eps = cfg["norm_eps"]
        self.theta = cfg["rope_theta"]
        self.fp8 = precision == "fp8"
        self.q_block = q_block

    def _weight(self, t: torch.Tensor) -> torch.Tensor:
        w = t.to(torch.float32)
        return fp8_rows(w) if self.fp8 else w

    def _linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (fp8_rows(x) if self.fp8 else x) @ w.T

    def _attention(self, q, k, v) -> torch.Tensor:
        """Causal attention of ``q [T, H, D]`` over ``k, v [T, KV, D]``."""
        T = q.shape[0]
        G = self.H // self.KV
        qh = q.permute(1, 0, 2).reshape(self.KV, G, T, self.D)
        kh, vh = k.permute(1, 0, 2), v.permute(1, 0, 2)          # [KV, T, D]
        out = torch.empty_like(qh)
        scale = self.D ** -0.5
        for s0 in range(0, T, self.q_block):
            s1 = min(T, s0 + self.q_block)
            scores = torch.einsum("kgsd,ktd->kgst", qh[:, :, s0:s1], kh[:, :s1]) * scale
            rows = torch.arange(s0, s1, device=q.device)[:, None]
            cols = torch.arange(s1, device=q.device)[None, :]
            scores = scores.masked_fill(cols > rows, float("-inf"))
            p = torch.softmax(scores, dim=-1)
            out[:, :, s0:s1] = torch.einsum("kgst,ktd->kgsd", p, vh[:, :s1])
        return out.reshape(self.H, T, self.D).permute(1, 0, 2).reshape(T, self.H * self.D)

    def logits(self, seqs: Sequence[Sequence[int]], first_rows: Sequence[int]) -> List[torch.Tensor]:
        """float32 logits ``[len(seq) - first, vocab]`` of each sequence's
        rows from ``first_rows[j]`` on (row t predicts token t + 1)."""
        w = self.w
        dev = w["norm"].device
        with torch.no_grad(), exact_fp32():
            n = max(len(s) for s in seqs)
            cos, sin = rope_tables(self.theta, self.D, n, dev)
            xs = [w["tok_embeddings"][torch.tensor(list(s), device=dev)].to(torch.float32)
                  for s in seqs]
            for li in range(w["wq"].shape[0]):
                lw = {k: self._weight(w[k][li]) for k in LAYER_KEYS}
                an = w["attn_norm"][li].to(torch.float32)
                fn = w["ffn_norm"][li].to(torch.float32)
                for j, x in enumerate(xs):
                    T = x.shape[0]
                    h = rms_norm(x, an, self.eps)
                    q = rotate(self._linear(h, lw["wq"]).reshape(T, self.H, self.D),
                               cos[:T], sin[:T])
                    k = rotate(self._linear(h, lw["wk"]).reshape(T, self.KV, self.D),
                               cos[:T], sin[:T])
                    v = self._linear(h, lw["wv"]).reshape(T, self.KV, self.D)
                    x = x + self._linear(self._attention(q, k, v), lw["wo"])
                    h = rms_norm(x, fn, self.eps)
                    act = torch.nn.functional.silu(self._linear(h, lw["w_gate"])) \
                        * self._linear(h, lw["w_up"])
                    xs[j] = x + self._linear(act, lw["w_down"])
                del lw
            head = self._weight(w["output"])
            nw = w["norm"].to(torch.float32)
            return [self._linear(rms_norm(x[r:], nw, self.eps), head)
                    for x, r in zip(xs, first_rows)]
