"""Data parallelism of the PyTorch port on four CPU gloo ranks, against the
JAX package's on the 8-device CPU mesh of tests/conftest.py.

One ``tests/tp_workers.py`` spawn of 4 ranks (importing only the port),
each check on a ``(dp 2, tp 2)`` mesh of them; this process holds the JAX
side, on the same seeded numpy inputs:

  * ``forward`` on a rank's batch rows and heads (tests/test_sharding.py's
    ``test_dp_tp_batched``: a batch of 2, then a greedy decode step; int4
    weights with an int8 cache; the kernels' path at head_dim 128, K1's and
    K2's plain versions on a rank's rows) and per-row decode positions cut
    with their rows over a seeded cache (``test_tp_flash_decode_per_row_
    positions``, on the plain path and on K2's plain version): the dp
    ranks' rows joined against JAX's ``forward`` on the same mesh within
    the bf16 drift bar of tests/test_torch_model.py, a relative L2 error
    under ``REL_L2_JAX`` and the same argmax, the tp ranks of a row bit-equal;
    the cache's rows and heads joined against JAX's;
  * the engine under dp: its sequential request is refused with a
    ``ValueError`` naming dp (the JAX engine fails at its cache); both
    batchers run, every rank holding every slot, and rank 0's streams equal
    the port's batcher without a mesh and the JAX batchers on the same
    ``(dp 2, tp 2)`` mesh (cancelled requests aside: the packages pipeline
    their steps apart); every rank's batcher state equals rank 0's after
    every step.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.models.llama import model as jmodel
from llama_nuts_and_bolts_tpu.parallel import make_mesh as jmake_mesh
from llama_nuts_and_bolts_tpu.parallel import shard_cache as jshard_cache
from llama_nuts_and_bolts_tpu.parallel import shard_params as jshard_params
from llama_nuts_and_bolts_tpu.parallel import token_sharding as jtoken_sharding
from llama_nuts_and_bolts_tpu.runtime import InferenceArgs as JInferenceArgs
from llama_nuts_and_bolts_tpu.runtime import InferenceEngine as JInferenceEngine
from llama_nuts_and_bolts_tpu.runtime.continuous import ContinuousBatcher as JContinuous
from llama_nuts_and_bolts_tpu.runtime.paged import PagedBatcher as JPaged

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import (
    params_from_numpy,
    tensor_from_numpy,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.runtime.continuous import ContinuousBatcher
from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests import tp_workers
from tests.test_torch_continuous import one_torch_thread
from tests.test_torch_quant_model import BF16_DRIFT, leaves
from tests.test_torch_ring import dequantized, reassemble
from tests.test_torch_speculative import jax_params as cyclic_params
from tests.test_torch_speculative import models
from tests.test_torch_tp import REL_L2_JAX, SPEC, WIDE, cyclic_engine_job
from tests.test_torch_tp import jax_params, rel_l2
from tests.test_torch_tp_serving import batcher_cases

WORLD = 4
MESH = dict(dp=2, tp=2)
JFWD = jax.jit(jmodel.forward, static_argnums=(1,), static_argnames=("attn_impl", "mesh"))
# tests/test_sharding.py's model (head_dim 8)
DP_SPEC = dict(dim=64, n_layers=2, n_heads=8, n_kv_heads=4, vocab_size=128,
               multiple_of=32, norm_eps=1e-5, max_sequence_length=64)
TOKENS = [[3, 14, 15, 92], [9, 2, 6, 53]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def seeded_cache(jcfg, T, dtype):
    """tests/test_sharding.py's seeded cache (K random, V = K + 0.03), or
    an int8 cache of seeded values and scales."""
    c = jmodel.KVCache.create(jcfg, 2, T)
    full = (jax.random.normal(jax.random.PRNGKey(12), c.k.shape, jnp.float32) * 0.1
            ).astype(jnp.bfloat16)
    if dtype == "bf16":
        return {"k": full, "v": full + 0.03}
    rng = np.random.default_rng(12)
    q = lambda: jnp.asarray(rng.integers(-100, 100, c.k.shape), jnp.int8)  # noqa: E731
    s = lambda: jnp.asarray(rng.uniform(1e-3, 2e-3, c.k.shape[:-1]), jnp.bfloat16)  # noqa: E731
    return {"k": q(), "v": q(), "k_scale": s(), "v_scale": s()}


def dp_case(spec=DP_SPEC, quant=None, cache="bf16", impl="plain", per_row=False, T=32,
            seed=3):
    """JAX's forwards on a ``(dp 2, tp 2)`` mesh and the port's payload for
    them: a prefill of TOKENS then one greedy decode step, or with
    ``per_row`` one decode step at positions [5, 11] over a seeded cache."""
    jcfg, jparams = jax_params(spec, quant=quant, seed=seed)
    mesh = jmake_mesh(tp=MESH["tp"], dp=MESH["dp"])
    jsharded = jshard_params(jparams, mesh)
    dt = torch.int8 if cache == "int8" else torch.bfloat16
    put = lambda a: jax.device_put(jnp.asarray(a, jnp.int32), jtoken_sharding(mesh))  # noqa: E731
    if per_row:
        filled = seeded_cache(jcfg, T, cache)
        jcache = jshard_cache(jmodel.KVCache(**filled), mesh)
        toks, pos = np.array([[9], [13]], np.int32), np.array([5, 11], np.int32)
        jl, jcache = JFWD(jsharded, jcfg, put(toks), jnp.asarray(pos), jcache,
                          attn_impl="xla", mesh=mesh)
        steps = [(torch.from_numpy(toks), torch.from_numpy(pos), impl, False, None)]
        want = [np.asarray(jl)]
        whole = KVCache(**{f: tensor_from_numpy(np.asarray(a), "cpu") for f, a in filled.items()})
    else:
        jdt = jnp.int8 if cache == "int8" else jnp.bfloat16
        jcache = jshard_cache(jmodel.KVCache.create(jcfg, 2, T, dtype=jdt), mesh)
        jl, jcache = JFWD(jsharded, jcfg, put(TOKENS), 0, jcache, attn_impl="xla", mesh=mesh)
        nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
        jl2, jcache = JFWD(jsharded, jcfg, put(nxt), len(TOKENS[0]), jcache,
                           attn_impl="xla", mesh=mesh)
        prefill_impl = "plain" if cache == "int8" else impl
        steps = [(torch.tensor(TOKENS, dtype=torch.int32), 0, prefill_impl, False, None),
                 (torch.from_numpy(nxt), len(TOKENS[0]), impl, False, None)]
        want = [np.asarray(jl), np.asarray(jl2)]
        whole = None
    case = {"mesh": MESH, "params": params_from_numpy(leaves(jparams), "cpu"),
            "cfg": ModelArgs(**spec), "batch": 2, "T": T, "cache_dtype": dt, "steps": steps}
    if whole is not None:
        case["cache"] = whole
    return case, {"logits": want,
                  "cache": {f: np.asarray(getattr(jcache, f)) for f in
                            ("k", "v", "k_scale", "v_scale") if getattr(jcache, f) is not None}}


FORWARD_CASES = {
    "batched": dict(),
    "int4_kv8": dict(spec=WIDE, quant="int4", cache="int8", impl="flash", T=128),
    "flash": dict(spec=WIDE, impl="flash", T=128),
    "per_row": dict(per_row=True),
    "per_row_flash": dict(spec=WIDE, impl="flash", per_row=True, T=128),
    "per_row_kv8_flash": dict(spec=WIDE, impl="flash", per_row=True, cache="int8", T=128),
}
BATCHER_CASES = ("dense", "paged")


def jax_streams(case, jmodel_):
    """The case's streams from the JAX batcher on a ``(dp 2, tp 2)`` mesh,
    None where a request was cancelled."""
    mesh = jmake_mesh(tp=MESH["tp"], dp=MESH["dp"])
    jeng = JInferenceEngine(dataclasses.replace(jmodel_, params=jshard_params(
        jmodel_.params, mesh)), JInferenceArgs(decode_chunk=1, **case["args"]), mesh=mesh)
    kw = dict(case["batcher"], step_quantum=1)
    jb = (JPaged(jeng, attn_impl="xla", **kw) if case["kind"] == "paged"
          else JContinuous(jeng, **kw))
    streams = tp_workers.run_script(jb, case["script"])
    cancelled = {a[1] for a in case["script"] if a[0] == "cancel"}
    return [None if i in cancelled else s for i, s in enumerate(streams)]


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    fwd, fwd_want = {}, {}
    for name, kw in FORWARD_CASES.items():
        fwd[name], fwd_want[name] = dp_case(**kw)
    engine, engine_want = cyclic_engine_job(
        dict(SPEC, vocab_size=512), {"chunk1": dict(sequence_length=48, decode_chunk=1)})
    engine["mesh"] = MESH
    jmodel_, model = models(cyclic_params(step=1))
    cases = {k: v for k, v in batcher_cases().items() if k in BATCHER_CASES}
    results = tp_workers.spawn(
        {"mesh_forward": fwd, "engine": engine,
         "batchers": {"model": model, "cases": cases, "mesh": MESH}},
        WORLD, tmp_path_factory.mktemp("dp"))
    return dict(results=results, fwd=fwd, fwd_want=fwd_want, engine_want=engine_want,
                model=model, jmodel=jmodel_, cases=cases)


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_dp_tp_forward_matches_jax(spawn, name):
    want = spawn["fwd_want"][name]
    ranks = [r["mesh_forward"][name] for r in spawn["results"]]
    by_row = {}
    for res in ranks:
        assert res["coords"]["dp"][1] == 2 and res["coords"]["sp"] == (0, 1)
        by_row.setdefault(res["coords"]["dp"][0], []).append(res)
    for group in by_row.values():
        for res in group[1:]:
            for a, b in zip(group[0]["logits"], res["logits"]):
                assert torch.equal(a, b), "a row's tp ranks hold different logits"
    for step, jl in enumerate(want["logits"]):
        blocks = [(res["coords"], res["logits"][step]) for res in ranks]
        for _, b in blocks:
            assert b.shape[0] == 1, "a dp rank returns its own row"
        tl = reassemble(blocks, ("dp", None, None), jl.shape)
        compare_tensor(tl, jl, "bfloat16", tolerance_multiplier=BF16_DRIFT)
        assert rel_l2(tl, jl) < REL_L2_JAX, (step, rel_l2(tl, jl))
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    got = {}
    for f in want["cache"]:
        blocks = [(res["coords"], getattr(res["cache"], f)) for res in ranks]
        got[f] = reassemble(blocks, (None, "dp", "tp", None, None)[:want["cache"][f].ndim],
                            want["cache"][f].shape)
    for g, w in zip(dequantized(got), dequantized(want["cache"])):
        compare_tensor(g, w, "bfloat16", tolerance_multiplier=BF16_DRIFT)


def test_dp_rows_that_do_not_match_are_refused():
    """Tokens whose rows are not the cache's (a whole batch over a rank's
    block) are refused, in the forward and in the kernel wrappers."""
    import torch.distributed as dist

    from llama_nuts_and_bolts_tpu_torch.models.llama.model import forward, init_random_params
    from llama_nuts_and_bolts_tpu_torch.parallel import initialize_multihost, make_mesh
    from llama_nuts_and_bolts_tpu_torch.parallel.kernel_shard import (
        tp_flash_decode_attention,
        tp_flash_gqa_attention,
    )
    from llama_nuts_and_bolts_tpu_torch.parallel.launch import free_port

    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="gloo")
    try:
        mesh = make_mesh()
        cfg = ModelArgs(**DP_SPEC)
        with pytest.raises(ValueError, match="2 token rows over a cache of 1"):
            forward(init_random_params(cfg, device="cpu"), cfg, torch.zeros((2, 3), dtype=torch.int32), 0,
                    KVCache.create(cfg, 1, 16, device="cpu"), mesh=mesh)
        q = torch.zeros((2, 1, 4, 128), dtype=torch.bfloat16)
        k = torch.zeros((1, 1, 1, 32, 128), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="q holds 2 rows, the cache 1"):
            tp_flash_decode_attention(mesh, q, k, k, torch.tensor([3, 4], dtype=torch.int32),
                                      layer=0)
        with pytest.raises(ValueError, match="the positions 2"):
            tp_flash_decode_attention(mesh, q[:1], k, k, torch.tensor([3, 4], dtype=torch.int32),
                                      layer=0)
        with pytest.raises(ValueError, match="q holds 2 rows, the cache 1"):
            tp_flash_gqa_attention(mesh, q, k[0], k[0], 0)
    finally:
        dist.destroy_process_group()


def test_engine_under_dp_refuses_a_sequential_request(spawn):
    """The JAX engine under a dp mesh fails at its one-row cache; the port's
    engine refuses it there, naming dp, on every rank."""
    for res in spawn["results"]:
        msg = res["engine"]["chunk1"]
        assert isinstance(msg, str) and msg.startswith("ValueError") and "dp=2" in msg, msg


@pytest.mark.parametrize("case", BATCHER_CASES)
def test_batchers_under_dp_match_jax(spawn, case):
    """Rank 0's streams equal the port's batcher without a mesh and, where
    not cancelled, the JAX batcher's on the same ``(dp 2, tp 2)`` mesh;
    every rank's batcher state equals rank 0's after every step."""
    c = spawn["cases"][case]
    eng = InferenceEngine(spawn["model"], InferenceArgs(**c["args"]), device="cpu")
    make = PagedBatcher if c["kind"] == "paged" else ContinuousBatcher
    want = tp_workers.run_script(make(eng, **c["batcher"]), c["script"])
    ranks = [r["batchers"][case] for r in spawn["results"]]
    assert ranks[0]["streams"] == want
    submits = [a for a in c["script"] if a[0] == "submit"]
    for action, stream, jstream in zip(submits, want, jax_streams(c, spawn["jmodel"])):
        if jstream is not None and not action[2].get("temperature"):
            assert stream == jstream
    assert len(ranks[0]["snapshots"]) > 3
    for r in range(1, WORLD):
        assert ranks[r]["snapshots"] == ranks[0]["snapshots"], r
