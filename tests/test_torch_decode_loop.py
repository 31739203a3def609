"""Decode graphs of the PyTorch port on the CPU, where a graph's body runs
eagerly on the same static buffers it is captured over on a card.

Against the JAX package on the same seeded weights: ``decode_block``,
``generate_block`` and ``generate_tokens_batched`` give the same tokens on
the constructed-cyclic model (exact: attention cannot move its logits).
Port-only, mirroring ``tests/test_streaming.py``'s chunked-decode cases:
``decode_chunk`` k gives the (state, token) stream of k = 1, greedy and
seeded-sampled, through the horizon tail and a mid-chunk end (where the
generator must be left exactly where per-token decoding leaves it); the
graph LRU evicts sampled entries first; two interleaved generators each get
a slot of their own; and the launch-counter arithmetic of capture and
replay holds."""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_nuts_and_bolts_tpu.runtime.batch import (
    generate_tokens_batched as jgenerate_tokens_batched,
)
from llama_nuts_and_bolts_tpu.runtime.device_loop import decode_block as jdecode_block
from llama_nuts_and_bolts_tpu.runtime.device_loop import (
    generate_block as jgenerate_block,
)

from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.runtime import decode_graph
from llama_nuts_and_bolts_tpu_torch.runtime.batch import generate_tokens_batched
from llama_nuts_and_bolts_tpu_torch.runtime.device_loop import (
    decode_block,
    generate_block,
)
from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket
from tests.test_torch_engine import CYCLE, PROMPT, engines


@functools.lru_cache(maxsize=None)
def models(make_cyclic):
    eng, jeng = engines(make_cyclic)
    return eng.model, jeng


def port(seq_len=24, make_cyclic=False, **args):
    return InferenceEngine(models(make_cyclic)[0],
                           InferenceArgs(sequence_length=seq_len, **args), device="cpu")


def stream(eng, prompt, max_new=None):
    return list(eng.generate_tokens(prompt, max_new_tokens=max_new))


# ------------------------------------------------------- against the JAX package


@pytest.mark.parametrize("stop_ids", [None, [0xE2], [0xE2, 101]])
def test_cyclic_decode_block_equals_jax(stop_ids):
    """Two rows at other points of the cycle; with stop ids each row
    repeats its stop token and its count stops, and once both have stopped
    the entries past the longest count are 0, as the JAX loop leaves them."""
    eng, jeng = engines(True)
    prompts = [PROMPT, PROMPT[:-2] + [0x82, 0xAC]]
    n, max_new, cache_len = len(PROMPT), 14, 64
    bucket = prefill_bucket(n, cache_len)
    padded = [p + [0] * (bucket - n) for p in prompts]
    jcache = jeng.new_cache(2, cache_len)
    jlogits, jcache = jeng._fwd(jeng.model.params, jeng.model.cfg,
                                jnp.asarray(padded, jnp.int32), 0, jcache,
                                attn_impl="xla", logits_at=n - 1, mesh=None)
    jfirst = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
    jstops = None if stop_ids is None else jnp.asarray(stop_ids, jnp.int32)
    jtokens, jcount, _ = jdecode_block(jeng.model.params, jeng.model.cfg, jfirst, n,
                                       jcache, max_new, jstops)
    with eng._lease(2, cache_len) as slot:
        logits, _ = eng._forward(padded, 0, slot.cache, logits_at=n - 1)
        first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        tokens, count, cache = decode_block(eng, slot, first, n, max_new, stop_ids)
    assert cache is slot.cache
    assert tokens.tolist() == np.asarray(jtokens).tolist()
    assert count.tolist() == np.asarray(jcount).tolist()
    if stop_ids is not None:
        assert max(count.tolist()) < max_new       # the early exit was reached


@pytest.mark.parametrize("max_new", [1, 5, 20])
def test_cyclic_generate_block_equals_jax(max_new):
    eng, jeng = engines(True)
    assert generate_block(eng, PROMPT, max_new) == jgenerate_block(jeng, PROMPT, max_new)
    # the stop token ends the block, and is included
    stop = next(iter(eng.model.vocab.stop_token_ids))
    eng.model.vocab.stop_token_ids.add(CYCLE[0])
    jeng.model.vocab.stop_token_ids.add(CYCLE[0])
    try:
        ids, finish = generate_block(eng, PROMPT, 20)
        assert (ids, finish) == jgenerate_block(jeng, PROMPT, 20)
        assert finish == "stop" and ids[-1] == CYCLE[0] and stop not in ids
    finally:
        eng.model.vocab.stop_token_ids.discard(CYCLE[0])
        jeng.model.vocab.stop_token_ids.discard(CYCLE[0])


def test_random_generate_block_equals_the_token_stream():
    eng = port(seq_len=48)
    ids, finish = generate_block(eng, [1, 5, 9], 20)
    assert ids == [t for _, t in stream(eng, [1, 5, 9], 20)]
    assert finish == "length"


def collect(gen):
    rows = {}
    for step in gen:
        for r in step:
            rows.setdefault(r.row, []).append(
                (r.position, r.token_id, r.state.name, r.is_prompt_echo))
    return rows


@pytest.mark.parametrize("prompts", [
    [PROMPT, PROMPT],                                   # duplicate prompts
    [PROMPT[:3], PROMPT],                               # ragged: echo suppression
    [PROMPT[:5], PROMPT[2:9], PROMPT]])
def test_cyclic_batched_equals_jax(prompts):
    eng, jeng = engines(True)
    rows = collect(generate_tokens_batched(eng, prompts))
    assert rows == collect(jgenerate_tokens_batched(jeng, prompts))
    for b, p in enumerate(prompts):
        assert rows[b][0][0] == len(p)                   # generation starts at its end
        assert rows[b][-1][2] != "IN_PROGRESS"
    assert not any(r[3] for rr in rows.values() for r in rr)
    if prompts[0] == prompts[1]:
        assert rows[0] == rows[1]


def test_random_batched_row_equals_its_single_run():
    eng = port(seq_len=32)
    rows = collect(generate_tokens_batched(eng, [[1, 5, 9], [2, 7]]))
    assert [(s, t) for _, t, s, _ in rows[0]] == [
        (s.name, t) for s, t in stream(eng, [1, 5, 9])]


def test_batched_refusals():
    eng, jeng = engines(True)
    for bad in ([], [[1], []], [list(range(eng.seq_len))]):
        with pytest.raises(ValueError):
            list(generate_tokens_batched(eng, bad))
        with pytest.raises(ValueError):
            list(jgenerate_tokens_batched(jeng, bad))


# -------------------------------------------------------------- chunked decode


def test_chunked_decode_matches_per_token():
    ref = stream(port(decode_chunk=1), [1, 5, 9])
    assert len(ref) > 16
    for k in (2, 4, 7):
        assert stream(port(decode_chunk=k), [1, 5, 9]) == ref, k


def test_chunked_decode_seq_len_tail():
    for k in (3, 4, 16):
        assert stream(port(12, decode_chunk=k), [2, 4]) == stream(
            port(12, decode_chunk=1), [2, 4]), k


def test_chunked_decode_string_transcript_and_prefix_cache():
    def parts(eng):
        return [(p.decoded_string, p.generation_state) for p in
                eng.generate_string([1, 5, 9, 2, 7])]

    ref = parts(port(decode_chunk=1))
    eng = port(decode_chunk=4)
    assert parts(eng) == ref
    eng.cache_prefix([1, 5, 9])               # the snapshot seeds the slot's cache
    assert parts(eng) == ref
    assert parts(eng) == ref


def test_chunked_decode_dispatch_count():
    eng = port(decode_chunk=4)
    out = stream(eng, [1, 5, 9])
    chunk = eng._chunk_fns[(4, eng.seq_len, "g", 0)]
    assert chunk.replays > 0
    assert chunk.replays <= len(out) // 4 + 2


@pytest.mark.parametrize("params", [{"temperature": 0.8},
                                    {"temperature": 1.3, "top_k": 8, "top_p": 0.9}])
def test_sampled_chunked_decode_matches_per_token(params):
    ref = stream(port(16, decode_chunk=1, seed=5, **params), [1, 2])
    for k in (3, 8):
        assert stream(port(16, decode_chunk=k, seed=5, **params), [1, 2]) == ref, k
    other = stream(port(16, decode_chunk=8, seed=6, **params), [1, 2])
    assert other != ref                         # the generator is really drawn from


def test_sampled_rng_state_exact_after_mid_chunk_end():
    def two_requests(chunk):
        eng = port(32, temperature=0.9, seed=11, decode_chunk=chunk)
        a = stream(eng, [1, 5, 9], 3)
        state = eng._generator.get_state()
        b = stream(eng, [2, 4], 6)
        return a, b, state, eng._generator.get_state()

    a, b, state, end = two_requests(1)
    for k in (4, 8):
        a_k, b_k, state_k, end_k = two_requests(k)
        assert (a_k, b_k) == (a, b), k
        assert torch.equal(state_k, state) and torch.equal(end_k, end), k


def test_chunk_graph_eviction_prefers_sampled():
    eng = port(16, decode_chunk=4)
    g_keys = [(4, 256 * (1 << i), "g", 0) for i in range(4)]
    for key in g_keys:
        eng._chunk_fns[key] = SimpleNamespace(slot=None)
    for i in range(eng.MAX_CHUNK_EXECUTABLES - len(g_keys)):
        eng._chunk_fns[(4, eng.seq_len, "s", i, 0.9, 0)] = SimpleNamespace(slot=None)
    assert len(eng._chunk_fns) == eng.MAX_CHUNK_EXECUTABLES
    eng.args.temperature, eng.args.top_k = 0.7, 999
    graph = eng._decode_chunk(4, sampled=True)
    assert all(key in eng._chunk_fns for key in g_keys)
    key = (4, eng.seq_len, "s", 999, 1.0, graph.slot.index)
    assert eng._chunk_fns[key] is graph
    assert len(eng._chunk_fns) == eng.MAX_CHUNK_EXECUTABLES
    # a hit refreshes the entry: the next victim is another sampled one
    assert eng._decode_chunk(4, sampled=True) is graph
    assert next(iter(eng._chunk_fns)) == g_keys[0]


def test_evicted_graphs_free_their_idle_slots():
    eng = port(16)
    stream(eng, [1, 5, 9])
    (slot,) = eng._slots[(1, 16)]
    eng.MAX_CHUNK_EXECUTABLES = 1
    eng._decode_chunk(1, cache_len=16, slot=eng._new_slot(1, 16))
    assert slot not in eng._slots[(1, 16)]
    assert len(eng._slots[(1, 16)]) == 1


def test_two_interleaved_generators_equal_their_solo_runs():
    eng = port(32, decode_chunk=4)
    solo = [stream(eng, p) for p in ([1, 5, 9], [2, 4])]
    a, b = eng.generate_tokens([1, 5, 9]), eng.generate_tokens([2, 4])
    got = ([], [])
    for pair in zip(a, b):
        for out, item in zip(got, pair):
            out.append(item)
    for out, it in zip(got, (a, b)):
        out.extend(it)
    assert list(got) == solo
    assert len(eng._slots[(1, 32)]) == 2        # a slot (and cache) each


# ------------------------------------------------------------ launch counters


def test_launch_counter_arithmetic_of_capture_and_replay():
    """A capture counts launches that do not run: ``uncounted`` takes them
    back and hands them over, and each replay adds them once."""
    wrappers = decode_graph.KERNEL_WRAPPERS
    saved = decode_graph.launch_counts()
    try:
        for fn in wrappers:
            fn.launches = 5
        with decode_graph.uncounted() as delta:
            wrappers[1].launches += 32          # as a capture of one step would
            wrappers[-1].launches += 225
        assert decode_graph.launch_counts() == (5,) * len(wrappers)
        assert delta[1] == 32 and delta[-1] == 225 and sum(delta) == 257
        decode_graph.add_launches(delta)
        decode_graph.add_launches(delta, times=3)
        assert wrappers[1].launches == 5 + 4 * 32
        assert wrappers[-1].launches == 5 + 4 * 225
        assert wrappers[0].launches == 5
    finally:
        for fn, n in zip(wrappers, saved):
            fn.launches = n


def test_a_dropped_engine_frees_its_graphs_without_the_collector():
    """Graphs hold the model and generator, not their engine: no reference
    cycle, so dropping an engine frees its graphs at once. Left to the
    cyclic collector, a graph's reset could run during another graph's
    capture, which the capturing stream does not permit."""
    import gc
    import weakref

    eng = port(decode_chunk=4)
    stream(eng, [1, 5, 9], 6)
    refs = [weakref.ref(eng)] + [weakref.ref(g) for g in eng._chunk_fns.values()]
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert all(r() is None for r in refs)
    finally:
        if collecting:
            gc.enable()
