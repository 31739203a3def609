"""Profiling of the PyTorch port against the JAX package's
(runtime/profiling.py, tests/test_profiling.py): the narrated forward's
logits, cache and lines against JAX's at ``attn_impl="plain"`` in both
weight layouts, and bit for bit against the port's own ``forward`` (the
same code, a layer at a time) on a bf16 or int8 cache and on quantized
weights; ``device_trace`` writes a trace, a batcher thread's spans in it; the
CLI's ``--narrate`` prints one line a layer plus two; the span recorder
(bounded, selected by time, nested, free of effects on the tokens) and
:func:`check_batcher_spans`, which the batchers' tests run on their spans."""

import json
import os
import re
import threading
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.io.params import ModelArgs as JModelArgs
from llama_nuts_and_bolts_tpu.models.llama import model as jmodel
from llama_nuts_and_bolts_tpu.runtime import profiling as jprofiling

from llama_nuts_and_bolts_tpu_torch.cli.main import main as cli_main
from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import params_from_numpy
from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
from llama_nuts_and_bolts_tpu_torch.quant import quantize_params, quantize_params_q4
from llama_nuts_and_bolts_tpu_torch.runtime.profiling import (
    SPANS,
    SpanRecorder,
    device_trace,
    narrated_forward,
)
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests.test_torch_model import leaves

# tests/test_profiling.py's CFG
SPEC = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=64,
            multiple_of=16, max_sequence_length=32)
LINE = re.compile(r"^Transformer block layer (\d+) / (\d+) was run, took \d+\.\d{4} sec\(s\)$")


def pair(seed, fused):
    jcfg = JModelArgs(**SPEC)
    jparams = jax.jit(jmodel.init_random_params, static_argnums=(0,))(
        jcfg, jax.random.PRNGKey(seed))
    if fused:
        jparams = jmodel.fuse_decode_params(jparams)
    return jcfg, jparams, ModelArgs(**SPEC), params_from_numpy(leaves(jparams), "cpu")


@pytest.mark.parametrize("seed,fused,tokens", [(0, False, [3, 1, 4, 1]),
                                               (2, True, [5, 3, 8])])
def test_narrated_forward_matches_jax_and_forward(seed, fused, tokens):
    jcfg, jparams, cfg, params = pair(seed, fused)
    jlines, lines = [], []
    jlogits, jcache = jprofiling.narrated_forward(
        jparams, jcfg, jnp.asarray([tokens], jnp.int32), 0,
        jmodel.KVCache.create(jcfg, 1, 16), jlines.append)
    tok = torch.tensor([tokens], dtype=torch.int32)
    logits, cache = narrated_forward(params, cfg, tok, 0,
                                     KVCache.create(cfg, 1, 16, device="cpu"),
                                     lines.append, attn_impl="plain")
    # tolerance: the bf16 drift bar of tests/test_torch_model.py
    compare_tensor(logits.numpy(), np.asarray(jlogits), "bfloat16", tolerance_multiplier=5.0)
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16",
                       tolerance_multiplier=5.0)
    # the port narrates its own forward: bit for bit
    ref, ref_cache = forward(params, cfg, tok, 0, KVCache.create(cfg, 1, 16, device="cpu"))
    assert torch.equal(logits, ref) and torch.equal(cache.k, ref_cache.k)
    # the lines: embeddings, one a layer, output -- as JAX's
    assert len(lines) == len(jlines) == cfg.n_layers + 2
    for i, (got, want) in enumerate(zip(lines, jlines)):
        strip = lambda s: re.sub(r"took \d+\.\d+", "took", s)  # noqa: E731
        assert strip(got) == strip(want), (got, want)
        if 0 < i <= cfg.n_layers:
            assert LINE.match(got).groups() == (str(i), str(cfg.n_layers))
    assert lines[0].startswith("embeddings: shape(1, %d, 32) dtype=bfloat16" % len(tokens))


@pytest.mark.parametrize("weights,kv", [("bf16", "int8"), ("int8", "bf16"),
                                        ("int4", "int8")])
def test_narration_runs_the_served_code(weights, kv):
    """Quantized weights and an int8 cache go through the same blocks as
    ``forward``'s: logits and cache bit for bit, one token after a prompt
    too (``start_pos`` > 0, ``logits_at``)."""
    spec = dict(SPEC, dim=256, vocab_size=96, multiple_of=256, max_sequence_length=64)
    jcfg = JModelArgs(**spec)
    jparams = jax.jit(jmodel.init_random_params, static_argnums=(0,))(
        jcfg, jax.random.PRNGKey(5))
    cfg, params = ModelArgs(**spec), params_from_numpy(leaves(jparams), "cpu")
    params = {"bf16": lambda p: p, "int8": quantize_params,
              "int4": quantize_params_q4}[weights](params)
    dtype = torch.int8 if kv == "int8" else torch.bfloat16
    caches = [KVCache.create(cfg, 1, 32, device="cpu", dtype=dtype) for _ in range(2)]
    prompt = torch.tensor([[7, 2, 9, 4, 1]], dtype=torch.int32)
    lines = []
    got, _ = narrated_forward(params, cfg, prompt, 0, caches[0], lines.append)
    want, _ = forward(params, cfg, prompt, 0, caches[1])
    assert torch.equal(got, want)
    step = torch.tensor([[11]], dtype=torch.int32)
    got, _ = narrated_forward(params, cfg, step, 5, caches[0], lines.append, logits_at=0)
    want, _ = forward(params, cfg, step, 5, caches[1], logits_at=0)
    assert torch.equal(got, want) and got.shape == (1, 1, 96)
    for a, b in zip((caches[0].k, caches[0].v, caches[0].k_scale),
                    (caches[1].k, caches[1].v, caches[1].k_scale)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert len(lines) == 2 * (cfg.n_layers + 2)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with device_trace(d) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = [os.path.join(root, f) for root, _, fs in os.walk(d) for f in fs]
    assert len(files) == 1 and files[0].endswith(".json")
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::matmul" in names
    assert any(e.key == "aten::matmul" for e in prof.key_averages())
    with device_trace(d):
        pass
    assert len(os.listdir(d)) == 2             # a second trace, not an overwrite


def test_cli_narrate_prints_one_line_a_layer_and_two(capsys):
    assert cli_main(["--tiny", "--device", "cpu", "--narrate", "--prompt-text", "hello",
                     "--seq-len", "48"]) == 0
    out = capsys.readouterr().out
    narrated = {m.group(0) for m in re.finditer(
        r"(embeddings: shape\(1, \d+, 256\)|Transformer block layer \d / 4 was run|"
        r"output norm\+projection: logits\(1, 1, 512\))", out)}
    assert len(narrated) == 4 + 2
    assert "Finished \x1b[1mby reaching" in out


# ------------------------------------------------------------------ spans

STEP_CHILDREN = {"batcher.admit", "batcher.prepare", "batcher.launch", "batcher.readback",
                 "batcher.deliver"}


def check_batcher_spans(spans, reqs):
    """The spans a batcher recorded while it served ``reqs``, every one
    finished: each request has one ``request.queued`` and one
    ``request.first_token`` under its id, meeting where its admission began;
    every child of a step names a ``batcher.step``
    as its parent and lies inside it. Returns the step spans."""
    by_id = defaultdict(list)
    for sp in spans:
        by_id[sp[3]].append(sp)
    for r in reqs:
        assert r.finished and r.rid >= 0
        mine = {sp[0]: sp for sp in by_id[r.rid] if sp[0].startswith("request")}
        assert sorted(sp[0] for sp in by_id[r.rid] if sp[0].startswith("request")) == [
            "request.first_token", "request.queued"], r.rid
        queued, first = mine["request.queued"], mine["request.first_token"]
        assert queued[1] == r.t_submit and queued[2] == first[1] == r.t_admit
        assert queued[1] <= queued[2] <= first[2]
        admits = [sp for sp in by_id[r.rid] if sp[0] == "batcher.admit"]
        assert admits and admits[-1][1] == r.t_admit and "stalled" not in admits[-1][5]
    steps = {sp[3]: sp for sp in spans if sp[0] == "batcher.step"}
    children = [sp for sp in spans if sp[0] in STEP_CHILDREN]
    assert steps and children
    for sp in children:
        parent = steps[sp[4]]
        assert parent[1] <= sp[1] <= sp[2] <= parent[2], (sp, parent)
    return list(steps.values())


def test_the_span_ring_is_bounded():
    rec = SpanRecorder(maxlen=8)
    for i in range(20):
        with rec.span("x", i=i):
            pass
    rec.add("y", 5, 6)
    kept = rec.between(0, time.perf_counter_ns() + 1)
    assert len(kept) == 8
    assert [sp[5] for sp in kept[:-1]] == [{"i": i} for i in range(13, 20)]
    assert kept[-1] == ("y", 5, 6, 20, None, None)


def test_between_selects_spans_by_their_start():
    rec = SpanRecorder()
    for t0, t1 in ((10, 50), (20, 30), (40, 90), (100, 120)):
        rec.add(f"s{t0}", t0, t1)
    assert [sp[0] for sp in rec.between(20, 100)] == ["s20", "s40"]
    assert [sp[0] for sp in rec.between(0, 11)] == ["s10"]
    assert rec.between(121, 200) == []


def test_spans_nest_and_carry_their_counts():
    rec = SpanRecorder()
    rid = rec.new_id()
    t = time.perf_counter_ns()
    with rec.span("outer", rows=1) as outer:
        with rec.span("inner", id=rid, parent=outer.id):
            pass
        outer.counts["rows"] += 2
    inner, whole = rec.between(t, time.perf_counter_ns() + 1)
    assert inner[:1] == ("inner",) and inner[3:] == (rid, outer.id, None)
    assert whole[0] == "outer" and whole[3] == outer.id != rid and whole[5] == {"rows": 3}
    assert whole[1] == outer.t0 <= inner[1] <= inner[2] <= whole[2]
    assert whole[4] is None


def tiny_paged():
    from tests.test_torch_continuous import make_engine
    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher

    return PagedBatcher(make_engine(), n_slots=2, block_size=8)


PROMPTS = ([1, 2, 3], [0] * 20, [4, 5, 6] * 5)


def test_tokens_are_bit_identical_under_a_profiler(tmp_path):
    """A profiler turns every span into a ``record_function`` range as well;
    the batcher's and the engine's tokens stay bit for bit the same."""
    def run():
        b = tiny_paged()
        reqs = [b.submit(p, max_new_tokens=9, temperature=t, seed=5)
                for p, t in zip(PROMPTS, (0.0, 1.3, 0.0))]
        b.run_until_idle()
        eng = b.engine
        return ([list(r.tokens(timeout=30)) for r in reqs],
                list(eng.generate_tokens(PROMPTS[2], 7)))

    plain = run()
    with device_trace(str(tmp_path / "trace")) as prof:
        traced = run()
    assert traced == plain
    names = {e.key for e in prof.key_averages()}
    assert {"batcher.step", "batcher.launch", "engine.prefill",
            "engine.decode.launch"} <= names


def test_only_device_trace_turns_spans_into_ranges():
    """Under any other profiler (the benchmark's stretch) a span is no
    range: a range's copy on the device's timeline would cover the card's
    idle gaps. The spans are recorded either way."""
    from torch.profiler import ProfilerActivity, profile

    b = tiny_paged()
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        b.submit(PROMPTS[0], max_new_tokens=4)
        b.run_until_idle()
        list(b.engine.generate_tokens(PROMPTS[1], 3))
    names = {e.key for e in prof.key_averages()}
    assert not {n for n in names if n.startswith(("batcher.", "engine.", "request"))}
    spans = {sp[0] for sp in SPANS.between(t0, time.perf_counter_ns() + 1)}
    assert {"batcher.step", "batcher.launch", "engine.prefill"} <= spans


def test_device_trace_shows_a_batcher_threads_spans(tmp_path):
    """A server's batcher steps on a thread that is already running when
    the trace starts: its ``batcher.step`` ranges are in the trace, on its
    own thread."""
    b = tiny_paged()
    thread = b.serve_forever_in_thread()
    try:
        b.submit(PROMPTS[0], max_new_tokens=2)
        deadline = time.time() + 30
        while b.has_work and time.time() < deadline:
            time.sleep(0.01)
        d = str(tmp_path / "trace")
        with device_trace(d):
            req = b.submit(PROMPTS[1], max_new_tokens=6)
            list(req.tokens(timeout=30))
    finally:
        b.stop()
        thread.join(30)
    (path,) = [os.path.join(d, f) for f in os.listdir(d)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("name") == "batcher.step"]
    assert steps and all(e.get("tid") != threading.get_native_id() for e in steps)
    assert any(e.get("name") == "batcher.launch" for e in events)
