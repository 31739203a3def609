"""A mixture of SwiGLU experts in place of the dense feed-forward (Mixtral's).

``y = sum_{i in top-k} p_i / (sum_{j in top-k} p_j) * SwiGLU_i(h)`` with
``p = softmax(h W_g^T)`` over the ``E`` experts (Mixtral of Experts,
arXiv:2401.04088, section 2.1; the router has no bias):

  * the router's logits are float32 products of the bf16 ``h``, and the
    softmax, the top-k and the renormalisation over the chosen k are float32;
  * each chosen expert runs its SwiGLU over the rows routed to it: gate and
    up products in the weights' type (the grouped product gives no other),
    ``silu(gate) * up`` in float32 rounded once, then the down product;
  * the k outputs are weighted and summed in float32 and rounded once.

Only routed (row, expert) pairs are computed. On a card the pairs are sorted
by expert on the device and each projection is one grouped product over
every expert (``torch._grouped_mm``) with device-side offsets: an expert no
row chose has an empty group and its weights are never read, nothing is read
back to the host, and a captured decode step holds it. On the CPU the plain
version loops over the experts with host indices.

:class:`Routing` is what one forward's expert layers share: which rows route
(``live``: a batcher's free slots and a prefill's padding rows route none, and
their output is 0) and where each layer writes the experts each row chose
(``ids [L, rows, k]``, in place; ``E`` for a row that routes none), which a
batcher reads back with its tokens (:func:`expert_stats`, and a
:class:`RoutingLog` when its model carries one).

Weights, a layer's views: ``router [E, dim]``; split ``e_gate``, ``e_up``
``[E, F, dim]`` and ``e_down [E, dim, F]`` (``[out, in]``, as ``linear``); or
fused ``e_gate_up [E, dim, 2F]`` and ``e_down [E, F, dim]`` (``[in, out]``,
as ``linear_t``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from llama_nuts_and_bolts_tpu_torch.ops.linear import linear, linear_t

IDS_DTYPE = torch.int16


@dataclass
class Routing:
    """One forward's routing record and row mask (see the module docstring):
    ``ids`` ``[L, rows, k]`` (:data:`IDS_DTYPE`) written in place (None: not
    recorded), ``live`` bool ``[rows]`` over the forward's flattened
    ``[B * S]`` rows (None: every row routes)."""

    ids: Optional[torch.Tensor] = None
    live: Optional[torch.Tensor] = None


def expert_stats(ids: np.ndarray, n_experts: int) -> Tuple[int, int]:
    """``(experts hit, routed pairs)`` of read-back routing ``ids [..., L,
    rows, k]``, each summed over the layers (and any leading steps): an
    expert is hit in a layer when a row of it chose the expert; an id of
    ``n_experts`` is no expert."""
    per_layer = ids.reshape(-1, ids.shape[-2] * ids.shape[-1])
    counts = (per_layer[:, :, None] == np.arange(n_experts)).sum(axis=1)
    return int((counts > 0).sum()), int(counts.sum())


class RoutingLog:
    """The experts a batcher routed each row of each served request to,
    for an audit of what it served (a benchmark's reference follows it):
    ``begin`` opens a request's record at its admission, ``add`` records
    its rows ``ids [n, L, k]`` from position ``start``, and ``rows`` gives
    a prompt's ``[n, L, k]``, -1 where nothing was recorded (a prefix-cache
    hit's shared rows, a verify's). A prompt served again names the later
    request. It grows with every request, so only a batcher whose model
    carries one (``LoadedModel.routing_log``) records."""

    def __init__(self) -> None:
        self._rid: Dict[tuple, int] = {}
        self._parts: Dict[int, List[Tuple[int, np.ndarray]]] = {}

    def begin(self, rid: int, prompt: Sequence[int]) -> None:
        self._rid[tuple(prompt)] = rid
        self._parts[rid] = []

    def add(self, rid: int, start: int, ids: np.ndarray) -> None:
        self._parts[rid].append((start, ids))

    def rows(self, prompt: Sequence[int], n: int) -> Optional[np.ndarray]:
        """Positions ``0 .. n - 1`` of the request with this prompt, or None."""
        parts = self._parts.get(self._rid.get(tuple(prompt)))
        if not parts:
            return None
        out = np.full((n,) + parts[0][1].shape[1:], -1, dtype=np.int64)
        for start, ids in parts:
            stop = min(n, start + ids.shape[0])
            if stop > start:
                out[start:stop] = ids[:stop - start]
        return out


def route(h: torch.Tensor, router: torch.Tensor, k: int,
          live: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids [N, k], weights [N, k] fp32)`` of rows ``h [N, dim]``: the top-k
    experts of the float32 softmax over ``h router^T`` and their
    probabilities renormalised over the k. A row outside ``live`` gets the
    id ``E`` (no expert)."""
    probs = torch.softmax(linear(h, router, out_dtype=torch.float32), dim=-1)
    top, ids = torch.topk(probs, k, dim=-1)
    if live is not None:
        ids = torch.where(live[:, None], ids, router.shape[0])
    return ids, top / top.sum(dim=-1, keepdim=True)


def _swiglu_pairs(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return (F.silu(gate.float()) * up.float()).to(x.dtype)


def _plain(x: torch.Tensor, w: Dict[str, torch.Tensor], flat: torch.Tensor,
           counts: torch.Tensor, k: int) -> torch.Tensor:
    """Each expert over its routed rows, a loop over the experts with host
    indices; ``[N * k, dim]`` in pair order, 0 for a pair of no expert.
    ``counts`` goes unread: the signature is :func:`_grouped`'s, whose
    place it takes on the CPU."""
    y = torch.zeros((flat.shape[0], x.shape[-1]), dtype=x.dtype, device=x.device)
    fused = "e_gate_up" in w
    for e in range(w["router"].shape[0]):
        pairs = torch.nonzero(flat == e)[:, 0]
        if pairs.numel() == 0:
            continue
        xe = x[pairs // k]
        if fused:
            gate, up = linear_t(xe, w["e_gate_up"][e]).chunk(2, dim=-1)
            y[pairs] = linear_t(_swiglu_pairs(xe, gate, up), w["e_down"][e])
        else:
            act = _swiglu_pairs(xe, linear(xe, w["e_gate"][e]), linear(xe, w["e_up"][e]))
            y[pairs] = linear(act, w["e_down"][e])
    return y


def _grouped(x: torch.Tensor, w: Dict[str, torch.Tensor], flat: torch.Tensor,
             counts: torch.Tensor, k: int) -> torch.Tensor:
    """The pairs sorted by expert, each projection one grouped product with
    the counts' running sums as its groups' ends (pairs of no expert sort
    last, past every group, and give 0); ``[N * k, dim]`` in pair order."""
    order = torch.argsort(flat, stable=True)
    ends = torch.cumsum(counts, dim=0, dtype=torch.int32)
    xs = x[order // k]
    if "e_gate_up" in w:
        gate, up = torch._grouped_mm(xs, w["e_gate_up"], offs=ends).chunk(2, dim=-1)
        ys = torch._grouped_mm(_swiglu_pairs(xs, gate, up), w["e_down"], offs=ends)
    else:
        gate = torch._grouped_mm(xs, w["e_gate"].transpose(-2, -1), offs=ends)
        up = torch._grouped_mm(xs, w["e_up"].transpose(-2, -1), offs=ends)
        ys = torch._grouped_mm(_swiglu_pairs(xs, gate, up), w["e_down"].transpose(-2, -1),
                               offs=ends)
    # rows past the last group's end are left unwritten by the product
    ys = torch.where((flat[order] < counts.shape[0])[:, None], ys, 0)
    return torch.empty_like(ys).index_copy_(0, order, ys)


def expert_ffn(h: torch.Tensor, w: Dict[str, torch.Tensor], k: int,
               routing: Optional[Routing] = None, layer: int = 0) -> torch.Tensor:
    """The expert layer on ``h [B, S, dim]`` (the normed input of the
    feed-forward) with one layer's weights ``w``: ``[B, S, dim]`` in
    ``h``'s type. ``routing`` masks rows and records layer ``layer``'s
    ids. The grouped products on a card, the plain loop on the CPU."""
    lead, dim = h.shape[:-1], h.shape[-1]
    x = h.reshape(-1, dim)
    E = w["router"].shape[0]
    ids, weights = route(x, w["router"], k, None if routing is None else routing.live)
    flat = ids.reshape(-1)                                           # [N * k]
    counts = (flat[:, None] == torch.arange(E, device=x.device)).sum(0, dtype=torch.int32)
    if routing is not None and routing.ids is not None:
        routing.ids[layer].copy_(ids)
    y = (_grouped if x.device.type == "cuda" else _plain)(x, w, flat, counts, k)
    out = (y.view(-1, k, dim).float() * weights[..., None]).sum(dim=1)
    return out.to(h.dtype).reshape(*lead, dim)
