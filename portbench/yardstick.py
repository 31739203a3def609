"""The yardstick: the published peaks of one NVIDIA H100, and the work a
kernel or a model step needs, counted from shapes.

The roofline arithmetic is a frozen copy of ``chip_smoke.py``'s
``bound_ms``, ``k1_work``, ``k2_work`` and ``paged_work``, generalised from
Llama-3.1-8B's attention widths to any configuration's H, KV and D. Each
input byte is counted once and each output byte once, and attention counts
only the keys a row can see. A later change to the program does not change
these counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

# NVIDIA's data sheet, H100 SXM, dense rates (no sparsity), at 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
BF16 = 2                          # bytes an element


@dataclass(frozen=True)
class Dims:
    """A configuration's shapes, as the model step sees them."""

    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn: int
    vocab: int

    @classmethod
    def from_config(cls, cfg: Dict) -> "Dims":
        hidden = int(4 * cfg["dim"] * 2 / 3)
        if cfg.get("ffn_dim_multiplier", -1) > 0:
            hidden = int(cfg["ffn_dim_multiplier"] * hidden)
        m = cfg["multiple_of"]
        return cls(dim=cfg["dim"], n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
                   n_kv_heads=cfg["n_kv_heads"], head_dim=cfg["dim"] // cfg["n_heads"],
                   ffn=m * ((hidden + m - 1) // m), vocab=cfg["vocab_size"])

    def linears(self) -> List[Tuple[int, int]]:
        """``(out, in)`` of one layer's GEMMs in the split layout."""
        d, q, kv, f = self.dim, self.n_heads * self.head_dim, \
            self.n_kv_heads * self.head_dim, self.ffn
        return [(q, d), (kv, d), (kv, d), (d, q), (f, d), (f, d), (d, f)]

    @property
    def layer_params(self) -> int:
        return sum(o * i for o, i in self.linears()) + 2 * self.dim


def bound_s(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least time the chip could take, and which peak bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(S: int, T: int, start_pos: int, H: int, KV: int, D: int,
            B: int = 1) -> Tuple[float, float]:
    """One layer of K1 (prefill attention): ``S`` query rows from
    ``start_pos`` over a cache of ``T``; q in and o out, each visible k and
    v row once, 4 H D operations a visible key."""
    n_keys = sum(min(T, start_pos + s + 1) for s in range(S))
    nbytes = 2 * B * S * H * D * BF16 + 2 * B * KV * min(T, start_pos + S) * D * BF16
    return nbytes, 4.0 * B * H * D * n_keys


def k2_work(positions: Iterable[int], T: int, H: int, KV: int,
            D: int) -> Tuple[float, float]:
    """One layer of K2 (dense decode attention): one query row a sequence
    at ``positions``, each visible k and v row once."""
    positions = list(positions)
    vis = sum(min(p + 1, T) for p in positions)
    return (2 * len(positions) * H * D * BF16 + 2 * KV * vis * D * BF16,
            4.0 * H * D * vis)


def paged_work(positions: Iterable[int], H: int, KV: int, D: int,
               int8: bool = False, distinct_rows: Optional[int] = None) -> Tuple[float, float]:
    """One layer of K6 (paged decode attention): every visible row of k
    and v read once (int8 rows with their bf16 scales), q in and out in
    bf16; 4 H D operations a visible key (at the int8 rate for int8).
    Where rows share pool blocks (a prefix-cache hit), ``distinct_rows``
    counts each shared block's rows once for the bytes."""
    positions = list(positions)
    rows = sum(p + 1 for p in positions) if distinct_rows is None else distinct_rows
    per_row = KV * (D + 2) if int8 else KV * D * BF16
    nbytes = 2 * len(positions) * H * D * BF16 + 2 * rows * per_row
    ops = 4.0 * H * D * sum(p + 1 for p in positions)
    return nbytes, ops * (BF16_FLOPS_PER_S / INT8_OPS_PER_S if int8 else 1.0)


def gemm_ideal_s(d: Dims, rows: int, head_rows: int) -> Dict[str, float]:
    """The least time of one forward's GEMMs: ``rows`` rows through every
    layer's projections and ``head_rows`` through the output head, each
    weight read once, activations in and out once. Returns the total and
    the parts bound by bytes and by operations."""
    out = {"total": 0.0, "bytes": 0.0, "operations": 0.0}

    def add(o: int, i: int, r: int, times: int) -> None:
        if r <= 0:
            return
        t, kind = bound_s(BF16 * (o * i + r * (i + o)), 2.0 * r * i * o)
        out["total"] += t * times
        out[kind] += t * times

    for o, i in d.linears():
        add(o, i, rows, d.n_layers)
    add(d.vocab, d.dim, head_rows, 1)
    return out


def attention_keys(start: int, n: int) -> int:
    """Keys visible to ``n`` causal rows that start at ``start``."""
    return n * start + n * (n + 1) // 2


def model_flops(d: Dims, rows: int, keys: int, head_rows: int) -> float:
    """Model FLOPs of ``rows`` new token rows that together see ``keys``
    keys in each layer, with ``head_rows`` of them through the head:
    2 x the layers' parameters a row, 4 H D a visible key a layer, and
    2 x dim x vocab a head row. Padding and free slots are not counted."""
    return (2.0 * d.n_layers * d.layer_params * rows
            + 4.0 * d.n_heads * d.head_dim * d.n_layers * keys
            + 2.0 * d.dim * d.vocab * head_rows)
