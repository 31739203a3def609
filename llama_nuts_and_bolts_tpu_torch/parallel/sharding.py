"""The shardings of the ``(dp, sp, tp)`` mesh: Megatron tensor-parallel
splits of the Llama weights, the dense cache's rows and heads, the paged
pool's heads, and a rank's block of the tokens.

Port of ``llama_nuts_and_bolts_tpu/parallel/sharding.py``. The JAX package
places each array with a ``NamedSharding`` and lets XLA keep the shards; a
process of the port holds only its own rank's blocks, so the specs below
name the split axes of each array and :func:`shard_leaf` and
:func:`cut_block` cut rank ``r``'s block out of a whole tensor: the block
that JAX's ``addressable_shards`` holds on the device at the same mesh
coordinate, byte for byte.

Weight layouts are checkpoint layouts ``[out, in]`` stacked to ``[L, out, in]``:

  wq/wk/wv  [L, heads*hd, D]  → (None, "tp", None)   column: by heads
  wo        [L, D, heads*hd]  → (None, None, "tp")   row: partial sums, all-reduce
  gate/up   [L, F, D]         → (None, "tp", None)
  down      [L, D, F]         → (None, None, "tp")   row: all-reduce
  output    [V, D]            → ("tp", None)         vocab-sharded logits
  tok_emb   [V, D]            → replicated

No weight spec names dp or sp: the weights are replicated on both.
Quantized leaves follow the JAX package's ``_put_weight``: an int8
``QTensor``'s per-channel scale ``[..., out]`` takes the value's spec without
its contraction axis; an int4 ``Q4Tensor`` (packed ``[..., G, out, K/2]``,
scale ``[..., G, out]``) puts the contraction split on the group axis and
the out split on its rows, and an axis that tp does not divide is
replicated instead (``_fit_spec``: e.g. a weight of fewer int4 groups than
ranks). This is the JAX package's ``q4_shardings``, for the whole tree
(:func:`shard_params`) and for the loader's sharded load alike
(:func:`sharding_fn_for`). A dense axis that tp does not divide is refused,
as JAX's ``device_put`` refuses it.

The dense cache ``[L, B, KV, T, hd]`` (and int8 scales ``[L, B, KV, T]``)
keeps its rank's batch rows on dp and KV heads on tp (``cache_sharding``),
and is replicated on sp: a sequence-parallel prefill writes every row of the
prompt into every sp rank's cache. The paged pool ``[L, n_blocks, KV, bs,
hd]`` (int8 scale pools ``[L, n_blocks, KV, bs]``) keeps its rank's KV heads
only: block writes, the gather path and K6 all stay on the rank, and the
batch lives in the block tables, which every rank holds whole. Tokens ``[B,
S]`` keep their batch rows on dp and, in a sequence-parallel prefill, their
prompt rows on sp (:func:`token_sharding`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.parallel.mesh import (
    MESH_AXES,
    axis_rank,
    axis_size,
    tp_rank,
    tp_size,
)

Spec = Tuple[Optional[str], ...]
# a rank's place on the axes a spec names: axis -> (index, size)
Coords = Dict[str, Tuple[int, int]]

LAYER_SPECS = {
    "attn_norm": (None, None),
    "ffn_norm": (None, None),
    "wq": (None, "tp", None),
    "wk": (None, "tp", None),
    "wv": (None, "tp", None),
    "wo": (None, None, "tp"),
    "w_gate": (None, "tp", None),
    "w_up": (None, "tp", None),
    "w_down": (None, None, "tp"),
}

TOP_SPECS = {
    "tok_embeddings": (None, None),
    "norm": (None,),
    "output": ("tp", None),
    "rope": (None, None),
}


def _fit_spec(spec: Spec, shape: Sequence[int], tp: int) -> Spec:
    """Replicate any spec axis whose dim tp does not divide."""
    return tuple(ax if ax is None or shape[i] % tp == 0 else None
                 for i, ax in enumerate(spec))


def cut_block(t: torch.Tensor, spec: Spec, coords: Coords) -> torch.Tensor:
    """The block of ``t`` at ``coords`` under ``spec`` (a view): each axis
    that ``spec`` names is cut into ``coords[name][1]`` equal parts, and the
    part at ``coords[name][0]`` kept."""
    for axis, name in enumerate(spec):
        if name is None:
            continue
        index, n = coords[name]
        if t.shape[axis] % n:
            raise ValueError(f"axis {axis} of a {tuple(t.shape)} tensor does not "
                             f"divide over {name}={n}")
        size = t.shape[axis] // n
        t = t.narrow(axis, index * size, size)
    return t


def mesh_coords(mesh) -> Coords:
    """This process's ``(index, size)`` on each axis of the mesh."""
    return {a: (axis_rank(mesh, a), axis_size(mesh, a)) for a in MESH_AXES}


def _take(t: torch.Tensor, spec: Spec, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``t`` under a spec that names tp only."""
    return cut_block(t, spec, {"tp": (rank, tp)})


def shard_leaf(value: Any, spec: Spec, rank: int, tp: int) -> Any:
    """Rank ``rank``'s slice of one weight leaf (a tensor, ``QTensor`` or
    ``Q4Tensor``) under the dense ``spec``; views of ``value``."""
    if hasattr(value, "packed"):          # Q4Tensor: grouped layout
        lead, s_out, s_in = spec[:-2], spec[-2], spec[-1]
        p_spec = _fit_spec(lead + (s_in, s_out, None), value.packed.shape, tp)
        sc_spec = _fit_spec(lead + (s_in, s_out), value.scale.shape, tp)
        return type(value)(packed=_take(value.packed, p_spec, rank, tp),
                           scale=_take(value.scale, sc_spec, rank, tp))
    if hasattr(value, "q"):               # QTensor: scales drop the contraction axis
        return type(value)(q=_take(value.q, spec, rank, tp),
                           scale=_take(value.scale, spec[:-1], rank, tp))
    return _take(value, spec, rank, tp)


def _contiguous(leaf: Any) -> Any:
    if dataclasses.is_dataclass(leaf):
        return type(leaf)(**{f.name: getattr(leaf, f.name).contiguous()
                             for f in dataclasses.fields(leaf)})
    return leaf.contiguous()


def shard_params_for(params, rank: int, tp: int):
    """Rank ``rank`` of ``tp``'s slices of a whole (possibly quantized)
    params tree, each made contiguous: a pure function of its arguments."""
    check_split_layout(params)
    cut = lambda v, spec: _contiguous(shard_leaf(v, spec, rank, tp))  # noqa: E731
    return dataclasses.replace(
        params,
        layers={k: cut(v, LAYER_SPECS[k]) for k, v in params.layers.items()},
        tok_embeddings=cut(params.tok_embeddings, TOP_SPECS["tok_embeddings"]),
        norm=cut(params.norm, TOP_SPECS["norm"]),
        output=cut(params.output, TOP_SPECS["output"]),
        rope_cos=cut(params.rope_cos, TOP_SPECS["rope"]),
        rope_sin=cut(params.rope_sin, TOP_SPECS["rope"]))


def shard_params(params, mesh):
    """This process's slices of a whole params tree, on the mesh's tp axis."""
    return shard_params_for(params, tp_rank(mesh), tp_size(mesh))


def sharding_fn_for(rank: int, tp: int) -> Callable[[str], Optional[Callable[[Any], Any]]]:
    """``sharding_fn(weight_key)`` for the loader: a function that cuts rank
    ``rank``'s slice out of ONE layer of that weight (or the whole top-level
    tensor), on the host, before it moves to the card; ``None`` for a key
    without a spec."""
    def fn(key: str):
        if key in LAYER_SPECS:
            spec = LAYER_SPECS[key][1:]     # the loader cuts a layer at a time
        elif key in TOP_SPECS:
            spec = TOP_SPECS[key]
        else:
            return None
        return lambda leaf: shard_leaf(leaf, spec, rank, tp)

    return fn


def param_sharding_fn(mesh):
    """:func:`sharding_fn_for` this process's rank on the mesh's tp axis."""
    return sharding_fn_for(tp_rank(mesh), tp_size(mesh))


CACHE_SPEC: Spec = (None, "dp", "tp", None, None)   # [L, B, KV, T, hd]


def cache_sharding(mesh=None) -> Spec:
    """The dense cache's spec (the JAX package's ``cache_sharding(mesh)``):
    batch rows on dp, KV heads on tp, replicated on sp. An int8 cache's
    scales take it without the head dim."""
    return CACHE_SPEC


def shard_cache_for(cache, rank: int, tp: int, dp_rank: int = 0, dp: int = 1):
    """The block of a dense cache (bf16, or int8 with scales) at tp rank
    ``rank`` of ``tp`` and dp rank ``dp_rank`` of ``dp``, as a cache of its
    own: a pure function of its arguments."""
    coords = {"tp": (rank, tp), "dp": (dp_rank, dp)}

    def cut(t):
        return None if t is None else cut_block(t, CACHE_SPEC[:t.dim()], coords).clone(
            memory_format=torch.contiguous_format)

    return type(cache)(k=cut(cache.k), v=cut(cache.v), k_scale=cut(cache.k_scale),
                       v_scale=cut(cache.v_scale))


def shard_cache(cache, mesh):
    """This process's rows and KV heads of a whole dense cache."""
    c = mesh_coords(mesh)
    return shard_cache_for(cache, *c["tp"], *c["dp"])


def token_sharding(mesh=None, seq_parallel: bool = False) -> Spec:
    """Tokens ``[B, S]`` (the JAX package's ``token_sharding``): batch rows
    on dp and, with ``seq_parallel``, the prompt's rows on sp (a
    sequence-parallel prefill, ``forward(..., seq_parallel=True)`` or
    ``attn_impl="ring"``)."""
    return ("dp", "sp" if seq_parallel else None)


def shard_tokens(tokens: torch.Tensor, mesh, seq_parallel: bool = False) -> torch.Tensor:
    """This process's block of a whole ``[B, S]`` token tensor (or of any
    tensor whose leading axes are the batch and the sequence, e.g. a ``[B]``
    positions tensor, whose spec is cut to its rank) under
    :func:`token_sharding`, made contiguous."""
    spec = token_sharding(mesh, seq_parallel)[:tokens.dim()]
    return cut_block(tokens, spec, mesh_coords(mesh)).contiguous()


POOL_SPEC: Spec = (None, None, "tp", None, None)    # [L, n_blocks, KV, bs, hd]


def pool_sharding(mesh=None) -> Spec:
    """The paged pool's spec (the JAX package's ``pool_sharding(mesh)``): KV
    heads on tp, no dp axis (the batch lives in the block tables). An int8
    pool's scale pools take it without the head dim."""
    return POOL_SPEC


def shard_pool_for(pool, rank: int, tp: int):
    """Rank ``rank``'s KV heads of a paged pool (bf16, or int8 with scale
    pools), as a pool of its own: a pure function of its arguments."""
    def cut(t):
        return None if t is None else _take(t, POOL_SPEC[:t.dim()], rank, tp).clone(
            memory_format=torch.contiguous_format)

    return type(pool)(k=cut(pool.k), v=cut(pool.v), k_scale=cut(pool.k_scale),
                      v_scale=cut(pool.v_scale))


def shard_pool(pool, mesh):
    """This process's KV heads of a whole paged pool, on the mesh's tp axis
    (the JAX package's ``shard_pool``)."""
    return shard_pool_for(pool, tp_rank(mesh), tp_size(mesh))


def check_tp_shape(cfg, tp: int) -> None:
    """A rank keeps whole heads and whole GQA groups: ``tp`` must divide the
    KV heads (and so the query heads)."""
    if cfg.kv_heads % tp or cfg.n_heads % tp:
        raise ValueError(f"tp={tp} must divide the KV heads ({cfg.kv_heads}) and the "
                         f"query heads ({cfg.n_heads}): each rank keeps whole GQA groups")


def check_split_layout(params) -> None:
    """Tensor parallelism keeps the split weights: the fused decode layout
    is single-device, as in the JAX package."""
    if "wqkv" in params.layers:
        raise ValueError("the fused decode layout is single-device; tensor "
                         "parallelism keeps the split weights")
