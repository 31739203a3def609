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


_RANDOM: list = []


def random_engine(seq_len: int = SEQ_LEN, **args) -> InferenceEngine:
    """An engine over random weights, where attention matters (the step
    graph's checks), whose vocabulary stops nothing: requests run to their
    caps."""
    if not _RANDOM:
        ranks, vocab, _ = tokenizers()
        vocab.stop_token_ids.clear()
        cfg = ModelArgs(**SPEC)
        _RANDOM.append(LoadedModel(params=init_random_params(cfg, seed=11, device="cpu"),
                                   cfg=cfg, vocab=vocab, mergeable_ranks=ranks,
                                   tensor_meta={}))
    return InferenceEngine(_RANDOM[0], InferenceArgs(sequence_length=seq_len, **args),
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
    assert cb.keys_stepped == sum(c.get("keys", 0) for c in counts) > 0
    assert cb.free_keys_stepped == sum(c.get("free_keys", 0) for c in counts)
    # the CPU runs the step graph's body eagerly: no step is graphed
    assert cb.graph_steps == 0 and all(c["graphed"] == 0 for c in counts if c["steps"])
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


# ------------------------------------------------------------ step graph

def step_graph_checks(cb, eager_step):
    """Watch every plain decode step of ``cb``: the static feed, positions
    and (paged) tables its graph's body ran on, the logits it left, and the
    tokens sampled from them. ``eager_step(feed, positions, tables)`` is the
    step called directly (``paged_decode_step``, or ``forward``). Returns
    ``check()``, which holds the run to it after the requests are drained
    (``streams``: each request's delivered tokens):

      * the body's logits are bit-equal to the eager step's on fresh copies
        of the same inputs;
      * each step's positions are the host's, a free row's is 0, and a live
        row's feed token is its request's token at that position (the
        prefill's first token, or the previous step's);
      * the static tables equal the host's after each dispatch;
      * each step's tokens are the sampler's on the eager logits, with the
        rows' seeds and settings, and each live row's token is the one its
        request delivered next.

    Returns the number of steps checked and the quanta whose block growth
    forced a request to finish."""
    from llama_nuts_and_bolts_tpu_torch.ops.sampling import sample_tokens_batched

    graph = cb._step_graph
    bufs = graph.slot
    steps, fed_rows, tables_equal, forced = [], [], [], []
    advance, replay, sample, dispatch = (cb._advance_quantum, graph.replay, cb._sample,
                                         cb._dispatch)

    def advanced(k):
        fed, epos, force = advance(k)
        fed_rows.extend(fed.copy())
        forced.append(any(any(f) for f in force))
        return fed, epos, force

    def replayed():
        inputs = [None if t is None else t.clone() for t in (bufs.feed, bufs.pos, bufs.tables)]
        replay()
        steps.append({"inputs": inputs, "logits": bufs.logits.clone(),
                      "eager": eager_step(*[None if t is None else t.clone() for t in inputs]),
                      "slots": list(cb.slots), "fed": fed_rows[len(steps)]})

    def sampled(logits, rows, positions):
        out = sample(logits, rows, positions)
        if logits is bufs.logits:
            steps[-1].update(tok=out[0].clone(), rows=list(rows),
                             settings=([cb._seed[r] for r in rows], cb._temp[rows].copy(),
                                       cb._topk[rows].copy(), cb._topp[rows].copy()))
        return out

    def dispatched():
        dispatch()
        if bufs.tables is not None:
            tables_equal.append(np.array_equal(bufs.tables.numpy(), cb.tables))

    cb._advance_quantum, graph.replay, cb._sample, cb._dispatch = (advanced, replayed, sampled,
                                                                   dispatched)

    def check(streams):
        assert steps and all(tables_equal) and (bufs.tables is None) == (not tables_equal)
        for st in steps:
            feed, pos, tables = st["inputs"]
            assert torch.equal(st["logits"], st["eager"])
            assert np.array_equal(pos.numpy(), st["fed"])
            seeds, temp, topk, topp = st["settings"]
            assert torch.equal(st["tok"], sample_tokens_batched(
                st["eager"], seeds, st["fed"], temp, topk, topp))
            for slot, req in enumerate(st["slots"]):
                if req is None:
                    assert st["fed"][slot] == 0, slot
                    continue
                i = int(st["fed"][slot]) - len(req.prompt)
                stream = streams[req.rid]
                if i < len(stream):
                    assert int(feed[slot, 0]) == stream[i], (slot, i)
                if i + 1 < len(stream):
                    assert int(st["tok"][slot]) == stream[i + 1], (slot, i)
        return len(steps), sum(forced)

    return check


@pytest.mark.parametrize("quantum", [1, 2])
def test_the_plain_step_runs_on_the_static_buffers(quantum):
    """The dense batcher's step graph (its body on the CPU) against
    ``forward`` called directly, over random weights, with requests joining
    mid-flight and leaving, greedy and sampled rows mixed
    (:func:`step_graph_checks`); no step is graphed on the CPU."""
    cb = ContinuousBatcher(random_engine(), n_slots=3, step_quantum=quantum)
    params, cfg, cache = cb.engine.model.params, cb.cfg, cb.cache

    def eager(feed, positions, _tables):
        return forward(params, cfg, feed, positions, cache,
                       attn_impl=cb._decode_impl)[0][:, -1]

    check = step_graph_checks(cb, eager)
    reqs = [cb.submit(PROMPTS[1], max_new_tokens=30),
            cb.submit(PROMPTS[0], max_new_tokens=6, temperature=1.2, seed=42)]
    for _ in range(4):
        cb.step()
    reqs += [cb.submit(PROMPTS[3], max_new_tokens=20, temperature=0.9, top_k=40, seed=7),
             cb.submit(PROMPTS[2], max_new_tokens=9)]
    cb.run_until_idle()
    streams = {r.rid: toks(drain(r)) for r in reqs}
    assert [len(streams[r.rid]) for r in reqs] == [30, 6, 20, 9]
    n, _ = check(streams)
    assert n == cb.decode_steps and cb.graph_steps == 0


# ------------------------------------------------- a free slot's position

def recorded_steps(cb):
    """Each replay of ``cb``'s step graph: which slots were free, the fed
    positions and the logits it left."""
    graph = cb._step_graph
    bufs, replay, steps = graph.slot, graph.replay, []

    def replayed():
        replay()
        steps.append(([r is None for r in cb.slots], bufs.pos.clone(), bufs.logits.clone()))

    graph.replay = replayed
    return steps


def climb_free_slots(cb):
    """Feed ``cb``'s free slots climbing positions, as before they were held
    at 0: a step advances every slot by one (capped), and before each
    dispatch the test drives each free slot's position by hand, from the
    middle of the cache up to its last."""
    cap, dispatch, n = cb._pos_cap, cb._dispatch, [0]
    cb._next_positions = lambda pos: np.minimum(pos + 1, cap).astype(np.int32)

    def climbed():
        for slot, req in enumerate(cb.slots):
            if req is None:
                cb._pos[slot] = min(cap // 2 + 3 * n[0] + slot, cap)
        n[0] += 1
        dispatch()

    cb._dispatch = climbed


def mixed_schedule(cb):
    """Requests joining mid-flight and leaving, greedy and sampled rows
    mixed, on a batcher with a slot to spare; each request's tokens."""
    reqs = [cb.submit(PROMPTS[1], max_new_tokens=20),
            cb.submit(PROMPTS[0], max_new_tokens=5, temperature=1.2, seed=42)]
    for _ in range(3):
        cb.step()
    reqs += [cb.submit(PROMPTS[3], max_new_tokens=14, temperature=0.9, top_k=40, seed=7),
             cb.submit(PROMPTS[2], max_new_tokens=6)]
    cb.run_until_idle()
    return [toks(drain(r)) for r in reqs]


def assert_live_rows_bit_equal(make):
    """The same schedule on two batchers from ``make()``, free rows held at
    0 and climbing: every step's live rows get bit-equal logits at the same
    positions, and every request the same tokens."""
    runs = []
    for climb in (False, True):
        cb = make()
        steps = recorded_steps(cb)
        if climb:
            climb_free_slots(cb)
        runs.append((steps, mixed_schedule(cb)))
    (held, streams), (climbed, climbed_streams) = runs
    assert streams == climbed_streams and len(held) == len(climbed) > 0
    moved = 0
    for (free, pos, logits), (free_c, pos_c, logits_c) in zip(held, climbed):
        live = [i for i, f in enumerate(free) if not f]
        assert free == free_c
        assert torch.equal(pos[live], pos_c[live])
        assert torch.equal(logits[live], logits_c[live])
        assert all(int(pos[i]) == 0 for i, f in enumerate(free) if f)
        moved += sum(int(pos_c[i]) > 0 for i, f in enumerate(free) if f)
    assert moved > 0


@pytest.mark.parametrize("quantum", [1, 2])
def test_live_rows_are_bit_equal_with_free_rows_held_or_climbing(quantum):
    """The dense step over random weights (:func:`assert_live_rows_bit_equal`)."""
    assert_live_rows_bit_equal(
        lambda: ContinuousBatcher(random_engine(), n_slots=4, step_quantum=quantum))


def watch_free_positions(cb):
    """Every position ``cb`` feeds a free slot, in plain steps and verifies,
    and for each release the quanta then in flight and the slot's position
    after it."""
    seen, releases = [], []
    advance, verify, release = cb._advance_quantum, cb._verify, cb._release_slot

    def advanced(k):
        free = [r is None for r in cb.slots]
        fed, epos, force = advance(k)
        seen.extend(int(p) for row in fed for p, f in zip(row, free) if f)
        return fed, epos, force

    def verified(tokens, positions):
        seen.extend(int(p) for p, r in zip(positions, cb.slots) if r is None)
        return verify(tokens, positions)

    def released(slot):
        in_flight = cb._quanta_in_flight()
        release(slot)
        releases.append((in_flight, int(cb._pos[slot])))

    cb._advance_quantum, cb._verify, cb._release_slot = advanced, verified, released
    return seen, releases


def free_slot_schedule(cb):
    """Two requests on three slots, a third joining later: every step has a
    free slot, and every stream equals the sequential engine's."""
    eng, caps = cb.engine, (9, 4, 7)
    reqs = [cb.submit(PROMPTS[0], max_new_tokens=9), cb.submit(PROMPTS[4], max_new_tokens=4)]
    for _ in range(3):
        cb.step()
    reqs.append(cb.submit(PROMPTS[2], max_new_tokens=7))
    cb.run_until_idle()
    for r, n in zip(reqs, caps):
        assert toks(drain(r)) == toks(sequential(eng, r.prompt, n))


def assert_free_slots_fed_0(cb, speculate_k):
    seen, releases = watch_free_positions(cb)
    free_slot_schedule(cb)
    assert seen and set(seen) == {0}
    assert len(releases) == 3 and all(pos == 0 for _, pos in releases)
    if not speculate_k:
        assert all(n > 0 for n, _ in releases)          # released with quanta in flight


@pytest.mark.parametrize("quantum,speculate_k", [(1, 0), (3, 0), (1, 2)])
def test_a_free_slot_is_fed_position_0(quantum, speculate_k):
    """Across quanta of 1 and 3 steps, after a release with quanta in
    flight, and in the speculative verify: a free slot is fed position 0,
    and a release leaves it at 0."""
    assert_free_slots_fed_0(ContinuousBatcher(make_engine(), n_slots=3, step_quantum=quantum,
                                              speculate_k=speculate_k), speculate_k)


def seated_after_a_release(make):
    """A request seated into slot 0 the step after its first holder was
    released with quanta in flight (a neighbour decoding in slot 1) streams
    what it streams alone on a fresh batcher."""
    cb = make()
    first = cb.submit(PROMPTS[1], max_new_tokens=7)
    cb.submit(PROMPTS[4], max_new_tokens=30)
    late = cb.submit(PROMPTS[0], max_new_tokens=30)
    _, releases = watch_free_positions(cb)
    cb.run_until_idle()
    assert first.slot == late.slot == 0 and releases[0][0] > 0
    alone = make()
    again = alone.submit(PROMPTS[0], max_new_tokens=30)
    alone.run_until_idle()
    assert again.slot == 0
    got, want = toks(drain(late)), toks(drain(again))
    assert len(got) == 30 and got == want


@pytest.mark.parametrize("quantum", [1, 3])
def test_a_request_seated_after_a_release_in_flight_streams_as_alone(quantum):
    """The dense batcher over random weights (:func:`seated_after_a_release`):
    the released row's position-0 writes and its last request's garbage
    rows never reach the new request."""
    seated_after_a_release(
        lambda: ContinuousBatcher(random_engine(), n_slots=2, step_quantum=quantum))


def hand_counted_keys(cb):
    """One request of 3 prompt tokens and 6 new ones on 3 slots in quanta of
    2: five quanta are dispatched before its last token is read back (two
    in flight behind each delivery), so the live row is fed positions 3 to
    12 and two free rows position 0 ten times: (4 + ... + 13) + 2 x 10 =
    105 keys, 20 of them free."""
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS

    t0 = time.perf_counter_ns()
    req = cb.submit([1, 2, 3], max_new_tokens=6)
    cb.run_until_idle()
    assert len(drain(req)) == 6
    counts = [sp[5] for sp in SPANS.between(t0, time.perf_counter_ns() + 1)
              if sp[0] == "batcher.step" and sp[5]]
    assert cb.decode_steps == 10
    assert cb.keys_stepped == sum(c["keys"] for c in counts) == 105
    assert cb.free_keys_stepped == sum(c["free_keys"] for c in counts) == 20


def test_keys_and_free_keys_on_a_hand_counted_schedule():
    hand_counted_keys(ContinuousBatcher(make_engine(), n_slots=3, step_quantum=2))


def test_a_verify_counts_its_keys_by_hand():
    """Speculating, K = 2, one request of 3 prompt tokens and 4 new ones on 3
    slots: its proposer finds no n-gram to draft, so three verifies feed it
    positions 3, 4, 5 and two free rows position 0: (4 + 5 + 6) + 2 x 3 =
    21 keys, 6 of them free; a verify counts no plain step."""
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS

    cb = ContinuousBatcher(make_engine(), n_slots=3, speculate_k=2)
    t0 = time.perf_counter_ns()
    req = cb.submit([1, 2, 3], max_new_tokens=4)
    cb.run_until_idle()
    assert toks(drain(req)) == [4, 5, 6, 0]
    counts = [sp[5] for sp in SPANS.between(t0, time.perf_counter_ns() + 1)
              if sp[0] == "batcher.step" and sp[5]]
    assert cb.verify_steps == 3 and cb.spec_stats["drafted"] == 0
    assert [(c["keys"], c["free_keys"], c["steps"], c["rows"]) for c in counts] == [
        (6, 2, 0, 0), (7, 2, 0, 0), (8, 2, 0, 0)]
    assert (cb.keys_stepped, cb.free_keys_stepped) == (21, 6)
