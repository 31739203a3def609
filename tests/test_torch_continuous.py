"""Continuous batching in the PyTorch port: ``forward`` with a per-row
``[B]`` ``start_pos`` against the JAX package's ``forward`` on the same
weights and cache contents, and the dense ``ContinuousBatcher`` against the
port's sequential engine (itself held to the JAX engine in
tests/test_torch_engine.py). Token streams are compared on a
constructed-cyclic model (wo and w_down zeroed, head rows that walk a fixed
cycle), where the argmax is decisive, so they must be equal."""

import contextlib
import dataclasses
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.io.params import ModelArgs as JModelArgs
from llama_nuts_and_bolts_tpu.models.llama import model as jmodel

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama import KVCache, forward, init_random_params
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import (
    params_from_numpy,
    tensor_from_numpy,
    tensor_to_numpy,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.loader import LoadedModel
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.runtime.continuous import LOGPROBS_K, ContinuousBatcher
from llama_nuts_and_bolts_tpu_torch.runtime.types import GenerationState
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests.test_torch_engine import SPEC, leaves, tokenizers

CYCLE = 7                  # the cyclic model walks 0 -> 1 -> ... -> 6 -> 0
SEQ_LEN = 64
# prompts ending inside the cycle; one shorter than a bucket, one of two
# buckets, one at the context's last admissible length
PROMPTS = [[1, 2, 3], [0] * 20, [4, 5], [6] * 17 + [2], [3] * 9]
EDGE_PROMPT = [5] * (SEQ_LEN - 2)


@contextlib.contextmanager
def one_torch_thread():
    """The tiny models' ops are too small to split: intra-op threads only
    contend with the other test workers (6x slower under pytest-xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def cyclic_model(seed: int = 3) -> LoadedModel:
    ranks, vocab, _ = tokenizers()
    cfg = ModelArgs(**SPEC)
    p = init_random_params(cfg, seed=seed, device="cpu")
    layers = dict(p.layers)
    layers["wo"] = torch.zeros_like(layers["wo"])
    layers["w_down"] = torch.zeros_like(layers["w_down"])
    out = torch.zeros_like(p.output)
    out[:CYCLE] = p.tok_embeddings[(torch.arange(CYCLE) - 1) % CYCLE]
    return LoadedModel(params=dataclasses.replace(p, layers=layers, output=out), cfg=cfg,
                       vocab=vocab, mergeable_ranks=ranks, tensor_meta={})


MODEL = cyclic_model()


def make_engine(seq_len: int = SEQ_LEN, **args) -> InferenceEngine:
    return InferenceEngine(MODEL, InferenceArgs(sequence_length=seq_len, **args),
                           device="cpu")


def sequential(eng, prompt, max_new=None):
    return list(eng.generate_tokens(prompt, max_new_tokens=max_new))


def drain(req):
    return list(req.tokens(timeout=30))


def toks(pairs):
    """The token ids of a stream. With a token cap the sequential engine's
    last state is IN_PROGRESS where a batcher reports the finish."""
    return [t for _, t in pairs]


# ------------------------------------------------- vector-position forward

def jax_params():
    jcfg = JModelArgs(**SPEC)
    return jcfg, jax.jit(jmodel.init_random_params, static_argnums=(0,))(
        jcfg, jax.random.PRNGKey(2))


def random_cache(rng, B, T, int8):
    cfg = ModelArgs(**SPEC)
    shape = (cfg.n_layers, B, cfg.kv_heads, T, cfg.head_dim)
    if not int8:
        k, v = (rng.standard_normal(shape).astype(np.float32).astype(ml_dtypes.bfloat16)
                for _ in range(2))
        return {"k": k, "v": v}
    out = {}
    for name in ("k", "v"):
        f = rng.standard_normal(shape).astype(np.float32)
        s = np.maximum(np.abs(f).max(-1), 1e-8) / np.float32(127.0)
        out[name] = np.clip(np.rint(f / s[..., None]), -127, 127).astype(np.int8)
        out[name + "_scale"] = s.astype(ml_dtypes.bfloat16)
    return out


@pytest.mark.parametrize("S,int8", [(1, False), (3, False), (1, True)])
def test_vector_start_pos_matches_jax_forward(S, int8):
    """Three rows at positions 5, 0 and 9 over a cache with earlier
    contents: logits within the bf16 drift bar of tests/test_torch_model.py,
    and the cache rows written at each row's own offsets."""
    jcfg, jp = jax_params()
    params = params_from_numpy(leaves(jp), "cpu")
    cfg = ModelArgs(**SPEC)
    rng = np.random.default_rng(S + 10 * int8)
    B, T = 3, 16
    bufs = random_cache(rng, B, T, int8)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    pos = np.array([5, 0, 9], np.int32)
    jcache = jmodel.KVCache(**{n: jnp.asarray(a) for n, a in bufs.items()})
    want, jcache = jax.jit(jmodel.forward, static_argnums=(1,))(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(pos), jcache)
    cache = KVCache(**{n: tensor_from_numpy(a, "cpu") for n, a in bufs.items()})
    got, cache = forward(params, cfg, torch.from_numpy(tokens), torch.from_numpy(pos), cache)
    compare_tensor(got.numpy(), np.asarray(want), "bfloat16", tolerance_multiplier=5.0)
    for name in bufs:
        mine = tensor_to_numpy(getattr(cache, name), ml_dtypes.bfloat16).astype(np.float32)
        theirs = np.asarray(getattr(jcache, name)).astype(np.float32)
        for b, p in enumerate(pos):
            untouched = np.ones(T, bool)
            untouched[p:p + S] = False
            # rows outside [p, p+S) keep their contents exactly
            np.testing.assert_array_equal(mine[:, b, :, untouched], bufs[name].astype(
                np.float32)[:, b, :, untouched])
        if bufs[name].dtype == np.int8:
            # rows quantized from k/v that differ by bf16 ulps may land a
            # quantum or two apart: compare what attention reads, the
            # dequantized rows
            s_name = name + "_scale"
            mine = mine * tensor_to_numpy(getattr(cache, s_name),
                                          ml_dtypes.bfloat16).astype(np.float32)[..., None]
            theirs = theirs * np.asarray(getattr(jcache, s_name)).astype(np.float32)[..., None]
        compare_tensor(mine, theirs, "bfloat16", tolerance_multiplier=5.0)


def test_vector_start_pos_equals_scalar_when_rows_agree():
    cfg = MODEL.cfg
    tokens = torch.tensor([[3], [9]], dtype=torch.int32)
    ref, cache_s = forward(MODEL.params, cfg, tokens, 5, KVCache.create(cfg, 2, 16, "cpu"))
    got, cache_v = forward(MODEL.params, cfg, tokens, torch.tensor([5, 5], dtype=torch.int32),
                           KVCache.create(cfg, 2, 16, "cpu"))
    assert torch.equal(got, ref) and torch.equal(cache_v.k, cache_s.k)


def test_vector_start_pos_refusals():
    cfg = MODEL.cfg
    cache = KVCache.create(cfg, 2, 16, "cpu")
    toks = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="vector start_pos"):
        forward(MODEL.params, cfg, toks, torch.tensor([1, 2], dtype=torch.int32), cache,
                attn_impl="flash")
    with pytest.raises(TypeError, match="int32"):
        forward(MODEL.params, cfg, toks, torch.tensor([1, 2]), cache)
    with pytest.raises(ValueError, match="exceed"):
        forward(MODEL.params, cfg, toks, torch.tensor([1, 14], dtype=torch.int32), cache)


# ------------------------------------------------------- scheduler e2e

@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_concurrent_requests_match_sequential(kv):
    """Six requests on two slots (admitted as slots free up): one runs to
    the context's end, the last starts at the context's last admissible
    length. Every stream equals the sequential engine's, finish states
    included where no token cap ends it."""
    eng = make_engine(kv_cache_dtype=kv)
    prompts = PROMPTS + [EDGE_PROMPT]
    caps = (None, 12, 9, 12, 12, None)
    want = [sequential(eng, p, n) for p, n in zip(prompts, caps)]
    cb = ContinuousBatcher(eng, n_slots=2)
    reqs = [cb.submit(p, **({} if n is None else {"max_new_tokens": n}))
            for p, n in zip(prompts, caps)]
    cb.run_until_idle()
    got = [drain(r) for r in reqs]
    for g, w, n in zip(got, want, caps):
        assert (g if n is None else toks(g)) == (w if n is None else toks(w))
    assert want[0][-1][0] == want[-1][-1][0] == GenerationState.FINISHED_BY_REACHING_SEQ_LEN


@pytest.mark.parametrize("quantum", [2, 3])
def test_step_quantum_matches_sequential(quantum):
    eng = make_engine()
    cb = ContinuousBatcher(eng, n_slots=2, step_quantum=quantum)
    reqs = [cb.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, (5, 40, 7, 1, 12))]
    cb.run_until_idle()
    for r, p, n in zip(reqs, PROMPTS, (5, 40, 7, 1, 12)):
        got = drain(r)
        assert [t for _, t in got] == [t for _, t in sequential(eng, p, n)]
        assert len(got) == n and got[-1][0] != GenerationState.IN_PROGRESS


def test_staggered_admission_and_slot_reuse():
    """Requests submitted while others decode, on one slot reused three
    times: each stream equals the sequential engine's."""
    eng = make_engine()
    cb = ContinuousBatcher(eng, n_slots=1)
    first = cb.submit(PROMPTS[0], max_new_tokens=10)
    for _ in range(3):
        cb.step()
    later = [cb.submit(p, max_new_tokens=6) for p in PROMPTS[1:3]]
    cb.run_until_idle()
    assert [t for _, t in drain(first)] == [t for _, t in sequential(eng, PROMPTS[0], 10)]
    for r, p in zip(later, PROMPTS[1:3]):
        assert [t for _, t in drain(r)] == [t for _, t in sequential(eng, p, 6)]
        assert r.slot == 0


def test_cancel_mid_flight_frees_the_slot():
    eng = make_engine()
    cb = ContinuousBatcher(eng, n_slots=1)
    victim = cb.submit(PROMPTS[1])
    for _ in range(4):
        cb.step()
    victim.cancel()
    after = cb.submit(PROMPTS[2], max_new_tokens=5)
    cb.run_until_idle()
    got = drain(victim)
    want = [t for _, t in sequential(eng, PROMPTS[1])]
    assert 0 < len(got) < len(want) and [t for _, t in got] == want[:len(got)]
    assert [t for _, t in drain(after)] == [t for _, t in sequential(eng, PROMPTS[2], 5)]
    cancelled_early = cb.submit(PROMPTS[0])
    cancelled_early.cancel()
    cb.run_until_idle()
    assert drain(cancelled_early) == []


def test_logprobs_are_recorded_per_token():
    eng = make_engine()
    cb = ContinuousBatcher(eng, n_slots=2)
    req = cb.submit(PROMPTS[0], max_new_tokens=4, logprobs=3)
    plain = cb.submit(PROMPTS[2], max_new_tokens=4)
    cb.run_until_idle()
    toks = [t for _, t in drain(req)]
    assert [e[0] for e in req.logprobs] == toks and plain.logprobs == []
    for tok, chosen, tops in req.logprobs:
        assert len(tops) == 3 and tops[0][0] == tok          # greedy: the top token
        assert chosen == pytest.approx(tops[0][1]) and chosen <= 0
    with pytest.raises(ValueError, match="logprobs"):
        cb.submit(PROMPTS[0], logprobs=LOGPROBS_K + 1)


def test_sampled_requests_are_seeded_and_neighbour_independent():
    eng = make_engine()

    def run(prompts, seeds):
        cb = ContinuousBatcher(eng, n_slots=len(prompts))
        reqs = [cb.submit(p, max_new_tokens=12, temperature=1.5, seed=s)
                for p, s in zip(prompts, seeds)]
        cb.run_until_idle()
        return [[t for _, t in drain(r)] for r in reqs]

    alone = run([PROMPTS[0]], [42])[0]
    assert run([PROMPTS[0], PROMPTS[3]], [42, 7])[0] == alone
    assert run([PROMPTS[4], PROMPTS[0], PROMPTS[1]], [1, 42, 9])[1] == alone
    assert run([PROMPTS[0]], [43])[0] != alone


def test_refusals():
    eng = make_engine()
    cb = ContinuousBatcher(eng, n_slots=2)
    for bad in ([], [1] * SEQ_LEN):
        with pytest.raises(ValueError, match="prompt"):
            cb.submit(bad)
    assert not cb.has_work


def test_serve_thread_steps_until_stopped():
    eng = make_engine()
    cb = ContinuousBatcher(eng, n_slots=2)
    thread = cb.serve_forever_in_thread()
    try:
        req = cb.submit(PROMPTS[0], max_new_tokens=6)
        assert [t for _, t in drain(req)] == [t for _, t in sequential(eng, PROMPTS[0], 6)]
    finally:
        cb.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()


# ------------------------------------------------------ spans and counters

def counting_dispatch(cb):
    """Wrap ``cb._dispatch``: the live rows of each dispatched step, as the
    test counts them."""
    live = []
    dispatch = cb._dispatch

    def counted():
        live.append(sum(r is not None for r in cb.slots) * cb.step_quantum)
        dispatch()

    cb._dispatch = counted
    return live


def test_requests_get_distinct_ids_without_a_mesh():
    cb = ContinuousBatcher(make_engine(), n_slots=2)
    a, b = cb.submit(PROMPTS[0]), cb.submit(PROMPTS[2])
    assert a.rid >= 0 and b.rid >= 0 and a.rid != b.rid


@pytest.mark.parametrize("speculate_k,quantum", [(0, 1), (0, 3), (2, None)])
def test_spans_and_counters_of_the_dense_batcher(speculate_k, quantum):
    """Every request's spans, the steps' children inside their steps, and
    the counters against the test's own count: live rows over the decode
    steps, and prefill rows plus padding equal to the buckets."""
    from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    from tests.test_torch_profiling import check_batcher_spans

    cb = ContinuousBatcher(make_engine(), n_slots=2, speculate_k=speculate_k,
                           step_quantum=quantum)
    live = counting_dispatch(cb)
    t0 = time.perf_counter_ns()
    reqs = [cb.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, (5, 14, 7, 1, 12))]
    cb.run_until_idle()
    for r in reqs:
        drain(r)
    spans = SPANS.between(t0, time.perf_counter_ns() + 1)
    steps = check_batcher_spans(spans, reqs)
    counts = [sp[5] or {"rows": 0, "steps": 0} for sp in steps]
    assert cb.rows_stepped == sum(live) == sum(c["rows"] for c in counts)
    assert cb.decode_steps == sum(c["steps"] for c in counts)
    assert (cb.decode_steps > 0) == (speculate_k == 0)
    buckets = sum(prefill_bucket(len(p), SEQ_LEN) for p in PROMPTS)
    assert cb.prefill_tokens == sum(len(p) for p in PROMPTS)
    assert cb.prefill_tokens + cb.prefill_padded_tokens == buckets
    assert cb.prefill_cached_tokens == cb.admission_stalls == 0
    assert cb.admissions == len(PROMPTS)
    queued = [sp for sp in spans if sp[0] == "request.queued"]
    assert cb.queue_wait_s == pytest.approx(sum(sp[2] - sp[1] for sp in queued) / 1e9)
    admits = [sp for sp in spans if sp[0] == "batcher.admit"]
    assert sum(sp[5]["padded"] for sp in admits) == cb.prefill_padded_tokens
