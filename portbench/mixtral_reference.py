"""The Mixtral family's shapes, weights and plain reference: Mistral-7B's
attention with a mixture of SwiGLU experts, top k, in place of the dense
feed-forward (Mistral AI, "Mixtral of Experts", arXiv:2401.04088, Table 1
and section 2.1). It imports nothing of the program;
``portbench/families/mixtral.py`` is the family.

A layer: RMSNorm, grouped-query attention with RoPE (as ``reference.py``),
the residual; RMSNorm, the router ``h W_g^T`` (no bias), the softmax over
the E experts, the top k renormalised over the k, each chosen expert's
SwiGLU weighted and summed, the residual. An untied head.

**The routing tie rule.** The program computes in bf16, the reference in
float32, and their router logits differ by rounding; where a row's k-th and
(k+1)-th logits lie closer than that, the program may rightly have taken
either expert, and the two choices give that layer, and every later row that
attends to the row, another output. So the reference follows the experts
the program chose, as the program recorded them for every row it served,
prompt rows included (``follow``: the program's routing log, which the
family's ``program`` hands over through :func:`follow_program`), wherever
that choice is one the rounding allows: every expert the program took has a
reference logit no more than ``tau`` below the reference's own k-th. A
choice further off is no rounding, and the reference keeps its own there,
so a program that routes wrongly is judged against the right routing. Rows
the program did not record take the reference's own choice. The float8
control never follows: it stands in the program's place and routes itself.

``TAU`` is 3 x the widest |router logit| difference between the program
(bf16, on the card) and this reference following the program's routing
everywhere, over every (row, layer) pair of serve-chat-length sequences at
the configuration's widths (``portbench/router_gap.py``: 0.0561 over 97,920
pairs of 6 sequences of 1020 rows, rising from 0.0100 at the first layer;
the widest reference margin where the program chose otherwise, 0.0447;
PERF.md section 2).
"""

import math
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from portbench import reference
from portbench.reference import exact_fp32, rms_norm, rope_tables, rotate

TAU = 0.17
ATTN_KEYS = ("wq", "wk", "wv", "wo")
EXPERT_KEYS = ("router", "e_gate", "e_up", "e_down")
BF16 = 2


@dataclass(frozen=True)
class MixtralDims:
    """A configuration's shapes, as the model step sees them."""

    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn: int                       # an expert's SwiGLU width
    vocab: int
    n_experts: int
    top_k: int

    @classmethod
    def from_config(cls, cfg: Dict) -> "MixtralDims":
        hidden = int(4 * cfg["dim"] * 2 / 3)
        if cfg.get("ffn_dim_multiplier", -1) > 0:
            hidden = int(cfg["ffn_dim_multiplier"] * hidden)
        m = cfg["multiple_of"]
        return cls(dim=cfg["dim"], n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
                   n_kv_heads=cfg["n_kv_heads"], head_dim=cfg["dim"] // cfg["n_heads"],
                   ffn=m * ((hidden + m - 1) // m), vocab=cfg["vocab_size"],
                   n_experts=cfg["n_experts"], top_k=cfg["n_experts_per_tok"])

    # ---------------------------------------------------- the work counts

    @property
    def attn_params(self) -> int:
        """One layer's attention projections (wq, wk, wv, wo)."""
        q, kv = self.n_heads * self.head_dim, self.n_kv_heads * self.head_dim
        return 2 * q * self.dim + 2 * kv * self.dim

    @property
    def expert_params(self) -> int:
        """One expert's three matrices."""
        return 3 * self.ffn * self.dim

    @property
    def dense_bytes(self) -> int:
        """The bf16 weights a step reads whatever the routing: every layer's
        attention projections, norms and router, the final norm and the
        head (the embedding rows gathered are left out)."""
        per_layer = self.attn_params + self.n_experts * self.dim + 2 * self.dim
        return BF16 * (self.n_layers * per_layer + self.vocab * self.dim + self.dim)

    def kv_bytes(self, keys: int) -> int:
        """Every layer's K and V rows of ``keys`` visible keys, read once."""
        return BF16 * 2 * self.n_kv_heads * self.head_dim * self.n_layers * keys

    def flops(self, rows: int, keys: int, expert_rows: int, head_rows: int) -> float:
        """Model FLOPs of ``rows`` token rows that see ``keys`` keys in each
        layer, with ``expert_rows`` routed (row, expert) pairs summed over the
        layers and ``head_rows`` rows through the head: the attention
        projections and the router 2 x their parameters a row a layer,
        4 H D a visible key a layer, an expert 2 x its parameters a pair,
        the head 2 x dim x vocab a row."""
        per_row = 2.0 * self.n_layers * (self.attn_params + self.n_experts * self.dim)
        return (per_row * rows
                + 4.0 * self.n_heads * self.head_dim * self.n_layers * keys
                + 2.0 * self.expert_params * expert_rows
                + 2.0 * self.dim * self.vocab * head_rows)


def make_weights(d: MixtralDims, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight, made from the seed on the device in bf16, as
    ``portbench/weights.py`` makes the Llama block's: the embedding N(0, 1),
    projections N(0, 1/fan_in), norm weights 1 + N(0, 0.1^2); the router
    ``[L, E, dim]`` and the experts ``e_gate``, ``e_up`` ``[L, E, F, dim]``,
    ``e_down [L, E, dim, F]`` N(0, 1/fan_in) too."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))

    def randn(shape, scale: float, shift: float = 0.0) -> torch.Tensor:
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)
        t.mul_(scale)
        if shift:
            t.add_(shift)
        return t

    L, E, F = d.n_layers, d.n_experts, d.ffn
    q, kv = d.n_heads * d.head_dim, d.n_kv_heads * d.head_dim
    w = {"tok_embeddings": randn((d.vocab, d.dim), 1.0),
         "output": randn((d.vocab, d.dim), 1.0 / math.sqrt(d.dim)),
         "norm": randn((d.dim,), 0.1, 1.0),
         "attn_norm": randn((L, d.dim), 0.1, 1.0),
         "ffn_norm": randn((L, d.dim), 0.1, 1.0)}
    shapes = {"wq": (q, d.dim), "wk": (kv, d.dim), "wv": (kv, d.dim), "wo": (d.dim, q),
              "router": (E, d.dim), "e_gate": (E, F, d.dim), "e_up": (E, F, d.dim),
              "e_down": (E, d.dim, F)}
    for key, shape in shapes.items():
        w[key] = randn((L,) + shape, 1.0 / math.sqrt(shape[-1]))
    return w


# the program's routing log of the run being judged (``follow_program``)
_PROGRAM_ROUTING = None


def follow_program(log) -> None:
    """Hand the references made from now on the program's routing log: an
    object whose ``rows(prompt, n)`` gives the experts the program chose
    for the first ``n`` rows of the request with that prompt, ``[n, L, k]``
    with -1 where it recorded none, or None for a prompt it did not serve
    (None: nothing to follow)."""
    global _PROGRAM_ROUTING
    _PROGRAM_ROUTING = log


class Reference(reference.Reference):
    """The forward pass of one Mixtral configuration over the benchmark's
    weights (:func:`make_weights`), at ``precision`` "fp32" or "fp8" (the
    control: every projection, the router's and the experts' too, W8A8 as
    ``reference.py``'s), with the routing tie rule (module docstring) at
    ``tau`` (``TAU`` by default; 0 keeps the reference's own routing) over
    ``follow`` (the log :func:`follow_program` was last handed by default;
    the control never follows). ``record``, a list, receives each layer's
    router logits ``[rows, E]`` (the sequences' rows in turn); ``stats``
    counts the (row, layer) pairs the program recorded (``recorded``),
    those where it chose otherwise than the reference within ``tau`` and
    was followed (``otherwise``), the widest reference margin among them
    (``widest_margin``), and those it chose further off, where the
    reference kept its own (``refused``)."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: Dict,
                 precision: str = "fp32", q_block: int = 512,
                 tau: Optional[float] = None, follow=None) -> None:
        super().__init__(weights, cfg, precision, q_block)
        self.E = cfg["n_experts"]
        self.k = cfg["n_experts_per_tok"]
        self.tau = TAU if tau is None else tau
        self.follow = None if self.fp8 else (follow or _PROGRAM_ROUTING)
        self.record: Optional[list] = None
        self.stats = {"recorded": 0, "otherwise": 0, "widest_margin": 0.0, "refused": 0}

    # --------------------------------------------------------- the layer

    def _experts(self, h: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                 ew: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Rows ``h [N, dim]`` through their chosen experts ``ids [N, k]``,
        weighted by ``weights [N, k]`` and summed; each expert over its rows."""
        out = torch.zeros_like(h)
        for e in range(self.E):
            rows, slot = torch.nonzero(ids == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = h[rows]
            act = torch.nn.functional.silu(self._linear(xe, ew["e_gate"][e])) \
                * self._linear(xe, ew["e_up"][e])
            out.index_add_(0, rows, self._linear(act, ew["e_down"][e])
                           * weights[rows, slot][:, None])
        return out

    def _choose(self, router: torch.Tensor, program: Optional[torch.Tensor]) -> torch.Tensor:
        """The experts ``[N, k]`` each row takes under the tie rule: the
        program's (``program [N, k]``, -1 where not recorded) where it
        recorded distinct experts each within ``tau`` of the reference's
        own k-th logit, else the reference's own top k."""
        k = self.k
        top, own = torch.topk(router, k, dim=-1)
        if program is None:
            return own
        recorded = (program >= 0).all(-1)
        ids = program.clamp(0, self.E - 1)
        ranked = torch.sort(ids, dim=-1).values
        sound = (recorded & (program < self.E).all(-1)
                 & (ranked[:, 1:] != ranked[:, :-1]).all(-1))
        below = top[:, k - 1:k] - router.gather(1, ids)           # under the k-th
        take = sound & (below <= self.tau).all(-1)
        otherwise = take & (ranked != torch.sort(own, dim=-1).values).any(-1)
        st = self.stats
        st["recorded"] += int(recorded.sum())
        st["otherwise"] += int(otherwise.sum())
        st["refused"] += int((recorded & ~take).sum())
        if otherwise.any():
            st["widest_margin"] = max(st["widest_margin"],
                                      float(below.amax(-1)[otherwise].max()))
        return torch.where(take[:, None], ids, own)

    def _program_ids(self, seqs: Sequence[Sequence[int]], first_rows: Sequence[int],
                     dev) -> Optional[torch.Tensor]:
        """The program's recorded experts ``[rows, L, k]`` of every
        sequence's rows in turn (-1 where none), or None with nothing to
        follow; a sequence's prompt is its rows up to ``first_rows[j]``."""
        if self.follow is None or self.tau <= 0:
            return None
        parts = []
        for s, first in zip(seqs, first_rows):
            rows = self.follow.rows(list(s[:first + 1]), len(s))
            parts.append(np.full((len(s), self.w["wq"].shape[0], self.k), -1)
                         if rows is None else rows)
        return torch.from_numpy(np.concatenate(parts).astype(np.int64)).to(dev)

    # ---------------------------------------------------------- the pass

    def logits(self, seqs: Sequence[Sequence[int]],
               first_rows: Sequence[int]) -> List[torch.Tensor]:
        """float32 logits ``[len(seq) - first, vocab]`` of each sequence's
        rows from ``first_rows[j]`` on (row t predicts token t + 1), under
        the tie rule."""
        w = self.w
        dev = w["norm"].device
        self.stats = {"recorded": 0, "otherwise": 0, "widest_margin": 0.0, "refused": 0}
        with torch.no_grad(), exact_fp32():
            n = max(len(s) for s in seqs)
            cos, sin = rope_tables(self.theta, self.D, n, dev)
            xs = [w["tok_embeddings"][torch.tensor(list(s), device=dev)].to(torch.float32)
                  for s in seqs]
            lens = [x.shape[0] for x in xs]
            program = self._program_ids(seqs, first_rows, dev)
            for li in range(w["wq"].shape[0]):
                lw = {key: self._weight(w[key][li]) for key in ATTN_KEYS}
                ew = {key: self._weight(w[key][li]) for key in EXPERT_KEYS}
                an = w["attn_norm"][li].to(torch.float32)
                fn = w["ffn_norm"][li].to(torch.float32)
                for j, x in enumerate(xs):
                    T = x.shape[0]
                    h = rms_norm(x, an, self.eps)
                    q = rotate(self._linear(h, lw["wq"]).reshape(T, self.H, self.D),
                               cos[:T], sin[:T])
                    kk = rotate(self._linear(h, lw["wk"]).reshape(T, self.KV, self.D),
                                cos[:T], sin[:T])
                    v = self._linear(h, lw["wv"]).reshape(T, self.KV, self.D)
                    xs[j] = x + self._linear(self._attention(q, kk, v), lw["wo"])
                X = torch.cat(xs)
                H2 = rms_norm(X, fn, self.eps)
                router = self._linear(H2, ew["router"])                 # [N, E]
                if self.record is not None:
                    self.record.append(router.clone())
                ids = self._choose(router, None if program is None else program[:, li])
                pr = torch.softmax(router, dim=-1).gather(1, ids)
                Y = self._experts(H2, ids, pr / pr.sum(dim=-1, keepdim=True), ew)
                xs = list(torch.split(X + Y, lens))
                del lw, ew
            head = self._weight(w["output"])
            nw = w["norm"].to(torch.float32)
            if program is not None:
                st = self.stats
                print(f"[mixtral reference] tau {self.tau}: the program recorded "
                      f"{st['recorded']} (row, layer) pairs; followed where it chose "
                      f"otherwise at {st['otherwise']} (widest margin "
                      f"{st['widest_margin']:.4f}); refused {st['refused']}",
                      file=sys.stderr, flush=True)
            return [self._linear(rms_norm(x[r:], nw, self.eps), head)
                    for x, r in zip(xs, first_rows)]
