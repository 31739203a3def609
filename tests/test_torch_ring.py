"""Sequence parallelism of the PyTorch port on four CPU gloo ranks, against
the JAX package's on the 8-device CPU mesh of tests/conftest.py.

One ``tests/tp_workers.py`` spawn of 4 ranks (importing only the port)
runs every check, each on its own mesh of the same ranks; this process
holds the JAX side, on the same seeded numpy inputs:

  * ``ring_gqa_attention`` on a rank's chunks against JAX's
    ``ring_gqa_attention`` at the sizes of tests/test_ring_attention.py,
    per element within ``2^-7 |ref| + 1e-3``. JAX's ``(sp 4, tp 2)`` case
    needs 8 ranks: the port holds ``(sp 2, tp 2)`` and ``(sp 4, tp 1)``
    instead, each against JAX on a mesh of its own shape; ``(sp 2, tp 1)``
    runs inside ``(dp 2, sp 2, tp 1)`` (each dp group a batch row) against
    JAX's ``(sp 2, tp 1)`` mesh. Causality in global positions: the last
    chunk's V zeroed leaves rows 0-11 bit-equal and moves the later rows;
  * ``forward`` with ``attn_impl="ring"`` and the sequence-parallel
    ``"plain"`` path (and ``"flash"``: K1's plain version on a rank's rows
    from its global start) at ``(sp 2, tp 2)`` and ``(sp 4, tp 1)``, then a
    decode step replicated on sp: logits against JAX's ``forward`` on the
    same mesh (``token_sharding(seq_parallel=True)``) within the bf16 drift
    bar of tests/test_torch_model.py, a relative L2 error under
    ``REL_L2_JAX`` and the same argmax; the plain paths within
    ``REL_L2_SINGLE`` of the port's unsharded forward; every rank's logits
    bit-equal; the cache against JAX's (an int8 one dequantized) within the
    drift bar, and the sp ranks' caches byte-equal;
  * the engine at ``(sp 2, tp 2)`` on the cyclic model: its greedy tokens
    equal the engine's without a mesh and the JAX engine's; both batchers
    at ``(sp 2, tp 2)``: rank 0's streams equal the port's batcher without
    a mesh, every rank's state equal after every step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from llama_nuts_and_bolts_tpu.models.llama import model as jmodel
from llama_nuts_and_bolts_tpu.parallel import make_mesh as jmake_mesh
from llama_nuts_and_bolts_tpu.parallel import shard_cache as jshard_cache
from llama_nuts_and_bolts_tpu.parallel import shard_params as jshard_params
from llama_nuts_and_bolts_tpu.parallel import token_sharding as jtoken_sharding
from llama_nuts_and_bolts_tpu.parallel.ring_attention import (
    ring_gqa_attention as jring_gqa_attention,
)

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import (
    params_from_numpy,
    tensor_from_numpy,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests import tp_workers
from tests.test_torch_continuous import one_torch_thread
from tests.test_torch_quant_model import BF16_DRIFT, leaves
from tests.test_torch_speculative import jax_params as cyclic_params
from tests.test_torch_speculative import models
from tests.test_torch_tp import REL_L2_JAX, REL_L2_SINGLE, SPEC, WIDE, cyclic_engine_job
from tests.test_torch_tp import jax_params, rel_l2
from tests.test_torch_tp_serving import batcher_cases

WORLD = 4
JFWD = jax.jit(jmodel.forward, static_argnums=(1,), static_argnames=("attn_impl", "mesh"))
JRING = jax.jit(jring_gqa_attention, static_argnums=(0,))
JAX_IMPL = {"plain": "xla", "flash": "xla", "ring": "ring"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def bf16(rng, shape):
    return rng.standard_normal(shape).astype(np.float32).astype(jnp.bfloat16)


def reassemble(blocks, spec, shape):
    """A global array from every rank's ``(coords, block)`` under ``spec``."""
    out = np.zeros(shape, np.float32)
    for coords, block in blocks:
        idx = []
        for axis, name in enumerate(spec):
            if name is None:
                idx.append(slice(None))
                continue
            i, n = coords[name]
            size = shape[axis] // n
            idx.append(slice(i * size, (i + 1) * size))
        out[tuple(idx)] = block.float().numpy()
    return out


# ------------------------------------------------------------ ring attention

RING_CASES = {f"sp{sp}_tp{tp}_at{start}": (sp, tp, start)
              for sp, tp, start in ((4, 1, 0), (2, 2, 0), (4, 1, 7), (2, 1, 0))}


def ring_case(sp, tp, start, B=2, S=32, H=8, KV=4, D=16, seed=0, zero_from=None):
    """The port's payload and JAX's ring outputs for one case (with
    ``zero_from``, a second V whose rows from there on are zeroed)."""
    rng = np.random.default_rng(seed)
    q, k, v = bf16(rng, (B, S, H, D)), bf16(rng, (B, KV, S, D)), bf16(rng, (B, KV, S, D))
    vs = [v] if zero_from is None else [v, v.copy()]
    if zero_from is not None:
        vs[1][:, :, zero_from:] = 0
    mesh = jmake_mesh(tp=tp, dp=1, sp=sp)
    put = lambda a, spec: jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))  # noqa: E731
    want = [np.asarray(JRING(mesh, put(q, P("dp", "sp", "tp", None)),
                             put(k, P("dp", "tp", "sp", None)),
                             put(vv, P("dp", "tp", "sp", None)), start), np.float32)
            for vv in vs]
    payload = {"mesh": dict(dp=WORLD // (sp * tp), sp=sp, tp=tp), "start_pos": start,
               "q": tensor_from_numpy(q, "cpu"), "k": tensor_from_numpy(k, "cpu"),
               "vs": [tensor_from_numpy(vv, "cpu") for vv in vs]}
    return payload, want


# ----------------------------------------------------- the sequence-parallel forward

TOKENS = [[3, 14, 15, 92, 65, 35, 89, 79]]
# head_dim 8, as tests/test_ring_attention.py's forward test
RING_SPEC = dict(dim=64, n_layers=2, n_heads=8, n_kv_heads=4, vocab_size=128,
                 multiple_of=32, norm_eps=1e-5, max_sequence_length=64)
FORWARD_CASES = {
    "ring_sp2_tp2": dict(sp=2, tp=2, impl="ring"),
    "ring_sp4_tp1": dict(sp=4, tp=1, impl="ring"),
    "plain_sp2_tp2": dict(sp=2, tp=2, impl="plain"),
    "plain_sp4_tp1": dict(sp=4, tp=1, impl="plain", logits_at=6),
    "ring_kv8_sp2_tp2": dict(sp=2, tp=2, impl="ring", cache="int8", logits_at=7),
    "plain_kv8_sp4_tp1": dict(sp=4, tp=1, impl="plain", cache="int8"),
    # K1's plain version from each rank's global start; K2's in the decode
    "flash_sp2_tp2": dict(spec=WIDE, sp=2, tp=2, impl="flash", T=128),
}


def sp_forward_case(sp, tp, impl, spec=RING_SPEC, cache="bf16", logits_at=None, T=16):
    """JAX's sequence-parallel prefill of TOKENS on a ``(1, sp, tp)`` mesh
    and one greedy decode step after it (tokens replicated), and the port's
    payload for the same: its logits and its whole cache."""
    jcfg, jparams = jax_params(spec, seed=5)
    mesh = jmake_mesh(tp=tp, dp=1, sp=sp)
    jsharded = jshard_params(jparams, mesh)
    jdt, dt = (jnp.int8, torch.int8) if cache == "int8" else (jnp.bfloat16, torch.bfloat16)
    jcache = jshard_cache(jmodel.KVCache.create(jcfg, 1, T, dtype=jdt), mesh)
    toks = jax.device_put(jnp.asarray(TOKENS, jnp.int32), jtoken_sharding(mesh, True))
    jl, jcache = JFWD(jsharded, jcfg, toks, 0, jcache, attn_impl=JAX_IMPL[impl],
                      logits_at=logits_at, mesh=mesh)
    nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    jl2, jcache = JFWD(jsharded, jcfg, jax.device_put(jnp.asarray(nxt), jtoken_sharding(mesh)),
                       len(TOKENS[0]), jcache, attn_impl="xla", mesh=mesh)
    decode_impl = "flash" if impl == "flash" else "plain"
    steps = [(torch.tensor(TOKENS, dtype=torch.int32), 0, impl, True, logits_at),
             (torch.from_numpy(nxt), len(TOKENS[0]), decode_impl, False, None)]
    case = {"mesh": dict(sp=sp, tp=tp), "params": params_from_numpy(leaves(jparams), "cpu"),
            "cfg": ModelArgs(**spec), "batch": 1, "T": T, "cache_dtype": dt, "steps": steps}
    want = {"logits": [np.asarray(jl), np.asarray(jl2)],
            "cache": {f: np.asarray(getattr(jcache, f)) for f in ("k", "v", "k_scale", "v_scale")
                      if getattr(jcache, f) is not None}}
    return case, want


def single_device(case):
    """The case's logits through the port's forward without a mesh (the
    ring's steps on the plain path)."""
    cache = KVCache.create(case["cfg"], case["batch"], case["T"], device="cpu",
                           dtype=case["cache_dtype"])
    out = []
    for tokens, start_pos, impl, _sp, logits_at in case["steps"]:
        logits, cache = forward(case["params"], case["cfg"], tokens, start_pos, cache,
                                attn_impl="plain" if impl == "ring" else impl,
                                logits_at=logits_at)
        out.append(logits)
    return out


def dequantized(cache):
    """A cache's K and V as fp32 values (an int8 one times its scales)."""
    k, v = (np.asarray(cache[f], np.float32) for f in ("k", "v"))
    if "k_scale" in cache:
        k = k * np.asarray(cache["k_scale"], np.float32)[..., None]
        v = v * np.asarray(cache["v_scale"], np.float32)[..., None]
    return k, v


# ------------------------------------------------------------ the one spawn

ENGINE_MESH = dict(sp=2, tp=2)
BATCHER_CASES = ("dense", "paged")


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    ring, ring_want = {}, {}
    for name, (sp, tp, start) in RING_CASES.items():
        ring[name], ring_want[name] = ring_case(sp, tp, start)
    ring["causal"], ring_want["causal"] = ring_case(4, 1, 0, B=1, S=16, H=4, KV=2, D=8,
                                                    seed=1, zero_from=12)
    fwd, fwd_want = {}, {}
    for name, kw in FORWARD_CASES.items():
        fwd[name], fwd_want[name] = sp_forward_case(**kw)
    engine, engine_want = cyclic_engine_job(
        dict(SPEC, vocab_size=512), {"chunk1": dict(sequence_length=48, decode_chunk=1),
                                     "chunk4": dict(sequence_length=48, decode_chunk=4)})
    engine["mesh"] = ENGINE_MESH
    _jmodel, model = models(cyclic_params(step=1))
    cases = {k: v for k, v in batcher_cases().items() if k in BATCHER_CASES}
    results = tp_workers.spawn(
        {"ring": ring, "mesh_forward": fwd, "engine": engine,
         "batchers": {"model": model, "cases": cases, "mesh": ENGINE_MESH}},
        WORLD, tmp_path_factory.mktemp("ring"))
    return dict(results=results, ring_want=ring_want, fwd=fwd, fwd_want=fwd_want,
                engine_want=engine_want, model=model, cases=cases)


def ring_out(spawn, name, i=0):
    blocks = [(r["ring"][name]["coords"], r["ring"][name]["out"][i]) for r in spawn["results"]]
    return reassemble(blocks, tp_workers.Q_SPEC, spawn["ring_want"][name][i].shape)


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_matches_jax_ring(spawn, name):
    """Every element within ``2^-7 |ref| + 1e-3`` of JAX's ring (bf16
    outputs of the same fp32 function: an ulp of rounding, and exp's last
    bits, apart)."""
    want = spawn["ring_want"][name][0]
    got = ring_out(spawn, name)
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-3)


def test_ring_is_causal_in_global_positions(spawn):
    """The last sp chunk's V zeroed: rows 0-11 never see columns 12-15, so
    they stay bit-equal; the later rows change. Both against JAX's ring."""
    out1, out2 = ring_out(spawn, "causal", 0), ring_out(spawn, "causal", 1)
    np.testing.assert_array_equal(out1[:, :12], out2[:, :12])
    assert not np.allclose(out1[:, 12:], out2[:, 12:])
    for got, want in zip((out1, out2), spawn["ring_want"]["causal"]):
        assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-3)


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_sequence_parallel_forward_matches_jax(spawn, name):
    case, want = spawn["fwd"][name], spawn["fwd_want"][name]
    ranks = [r["mesh_forward"][name] for r in spawn["results"]]
    for r in range(1, WORLD):
        for a, b in zip(ranks[0]["logits"], ranks[r]["logits"]):
            assert torch.equal(a, b), f"rank {r}'s logits differ from rank 0's"
    single = single_device(case)
    for step, (tl, jl, sl) in enumerate(zip(ranks[0]["logits"], want["logits"], single)):
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape, (step, tl.shape)
        compare_tensor(tl.numpy(), jl, "bfloat16", tolerance_multiplier=BF16_DRIFT)
        assert rel_l2(tl.numpy(), jl) < REL_L2_JAX, (step, rel_l2(tl.numpy(), jl))
        np.testing.assert_array_equal(tl.numpy().argmax(-1), jl.argmax(-1))
        if case["steps"][0][2] != "ring":
            assert rel_l2(tl.numpy(), sl.numpy()) < REL_L2_SINGLE, step
    # the cache: replicated on sp (byte-equal), heads on tp, as JAX's
    by_sp = {}
    for res in ranks:
        by_sp.setdefault(res["coords"]["tp"][0], []).append(res["cache"])
    for caches in by_sp.values():
        for c in caches[1:]:
            for f in ("k", "v", "k_scale", "v_scale"):
                a, b = getattr(caches[0], f), getattr(c, f)
                assert (a is None and b is None) or torch.equal(a, b), f
    got = {}
    for f in want["cache"]:
        blocks = [(res["coords"], getattr(res["cache"], f)) for res in ranks]
        got[f] = reassemble(blocks, (None, "dp", "tp", None, None)[:want["cache"][f].ndim],
                            want["cache"][f].shape)
    for g, w in zip(dequantized(got), dequantized(want["cache"])):
        compare_tensor(g, w, "bfloat16", tolerance_multiplier=BF16_DRIFT)


def test_engine_under_sp_matches_unsharded(spawn):
    """Every rank of the ``(sp 2, tp 2)`` engine makes the same calls and
    yields the cyclic tokens of the engine without a mesh and of the JAX
    engine (checked against both in ``cyclic_engine_job``), at decode_chunk
    1 and 4."""
    for r, res in enumerate(spawn["results"]):
        for name, stream in res["engine"].items():
            assert stream == spawn["engine_want"], (r, name)


@pytest.mark.parametrize("case", BATCHER_CASES)
def test_batchers_under_sp_in_lockstep(spawn, case):
    """Rank 0 of the ``(sp 2, tp 2)`` mesh steps; the other ranks follow its
    records (the sp replica too). Its streams equal the port's batcher
    without a mesh (greedy, sampled and cancelled requests), and every
    rank's batcher state equals rank 0's after every step."""
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.runtime.continuous import ContinuousBatcher
    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher

    c = spawn["cases"][case]
    eng = InferenceEngine(spawn["model"], InferenceArgs(**c["args"]), device="cpu")
    make = PagedBatcher if c["kind"] == "paged" else ContinuousBatcher
    want = tp_workers.run_script(make(eng, **c["batcher"]), c["script"])
    ranks = [r["batchers"][case] for r in spawn["results"]]
    assert ranks[0]["streams"] == want
    assert len(ranks[0]["snapshots"]) > 3
    for r in range(1, WORLD):
        assert ranks[r]["snapshots"] == ranks[0]["snapshots"], r
