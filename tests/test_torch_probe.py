"""The measured attention probe (``attn_impl="probe"``) of the PyTorch port,
mirroring the JAX package's probe tests (tests/test_streaming.py): the
choice is the measured fastest, it is made once per cache bucket and keyed
by it, a prefill keeps the auto rules, the batchers take the auto rules,
and the tokens equal auto's (and the JAX probe engine's on the cyclic
model). On the CPU the probe has one candidate, as the JAX package's has
off-TPU; two candidates are forced on a kernel-shaped model (the wrappers
run their plain versions on CPU tensors) to read the timing loop."""

import dataclasses
import time

import pytest
import torch

from llama_nuts_and_bolts_tpu_torch.models.llama import init_random_params
from llama_nuts_and_bolts_tpu_torch.models.llama.loader import LoadedModel
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.runtime.continuous import ContinuousBatcher
from llama_nuts_and_bolts_tpu_torch.runtime.decode_graph import DecodeGraph
from llama_nuts_and_bolts_tpu_torch.runtime.paged import default_attn_impl
from tests.test_torch_continuous import one_torch_thread
from tests.test_torch_engine import PROMPT, engines, tokenizers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def kernel_shaped_engine(**args):
    """Head_dim 128 and G = 4 (the kernels' shape) at a tiny width: 2
    layers, dim 512, 4 heads over 1 KV head."""
    from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs

    ranks, vocab, _ = tokenizers()
    cfg = ModelArgs(dim=512, n_layers=2, n_heads=4, n_kv_heads=1, vocab_size=512,
                    multiple_of=64, max_sequence_length=256)
    model = LoadedModel(params=init_random_params(cfg, seed=4, device="cpu"), cfg=cfg,
                        vocab=vocab, mergeable_ranks=ranks, tensor_meta={})
    return InferenceEngine(model, InferenceArgs(sequence_length=256, **args), device="cpu")


def test_probe_picks_measured_fastest():
    eng, _ = engines(True, attn_impl="probe")
    chosen = eng.autotune_attn_impl(iters=2)
    assert chosen == min(eng._probe_timings, key=eng._probe_timings.get) == "plain"
    assert eng._probe_timings == {"plain": 0.0}
    assert eng._attn_impl(1) == chosen
    # the prefill keeps the auto rules, not the decode probe
    assert eng._attn_impl(16) == eng._auto_attn_impl(16) == "plain"
    # generation in probe mode equals auto's and the JAX probe engine's
    auto, _ = engines(True)
    _, jeng = engines(True, attn_impl="probe")
    want = list(auto.generate_tokens(PROMPT, max_new_tokens=12))
    assert list(eng.generate_tokens(PROMPT, max_new_tokens=12)) == want
    assert [(s.name, t) for s, t in want] == [
        (s.name, t) for s, t in jeng.generate_tokens(PROMPT, max_new_tokens=12)]


def test_probe_is_one_shot_per_bucket():
    eng, _ = engines(False, attn_impl="probe")
    eng._attn_impl(1)
    first = dict(eng._probed_decode_impl)
    assert set(first) == {eng.seq_len}
    # the same bucket never probes again (a second probe would call None)
    eng.autotune_attn_impl = None
    assert eng._attn_impl(1) == first[eng.seq_len]
    assert eng._attn_impl(1, cache_len=eng.seq_len) == first[eng.seq_len]


def test_probe_keyed_by_cache_bucket():
    """Requests decode at different cache buckets; the probe's result is
    kept per bucket, and a request probes its own bucket before its decode
    graph is made."""
    eng, _ = engines(False, attn_impl="probe")
    eng._attn_impl(1, cache_len=16)
    eng._attn_impl(1, cache_len=96)
    assert set(eng._probed_decode_impl) == {16, 96}
    seen = dict(eng._probed_decode_impl)
    eng.autotune_attn_impl = None
    assert eng._attn_impl(1, cache_len=16) == seen[16]
    assert eng._attn_impl(1, cache_len=96) == seen[96]
    fresh, _ = engines(False, attn_impl="probe")
    list(fresh.generate_tokens(PROMPT, max_new_tokens=4))
    bucket = fresh.cache_bucket(len(PROMPT), 4)
    assert set(fresh._probed_decode_impl) == {bucket}
    assert all(g.impl == fresh._probed_decode_impl[bucket]
               for g in fresh._chunk_fns.values())


@pytest.mark.parametrize("slow", ["plain", "flash"])
def test_probe_follows_the_measurement(monkeypatch, slow):
    """Two candidates (forced here; a card's): each is timed on its own
    one-step graph over a scratch slot at mid-bucket, the faster is kept,
    and the probe leaves no graph or slot behind. The decode graphs then
    take the chosen path, and the tokens equal auto's."""
    eng = kernel_shaped_engine(attn_impl="probe")
    monkeypatch.setattr(InferenceEngine, "_decode_candidates",
                        lambda self, cache_len: ["plain", "flash"])
    seen = []
    replay = DecodeGraph.replay

    def timed_replay(graph):
        seen.append((graph.impl, int(graph.slot.pos[0])))
        if graph.impl == slow:
            time.sleep(0.02)
        replay(graph)

    monkeypatch.setattr(DecodeGraph, "replay", timed_replay)
    choice = eng.autotune_attn_impl(iters=3, cache_len=128)
    assert choice == ("flash" if slow == "plain" else "plain")
    assert set(eng._probe_timings) == {"plain", "flash"}
    assert eng._probe_timings[slow] > eng._probe_timings[choice]
    # two warm-up replays and three timed ones per candidate, all at (128 - 2) // 2
    assert seen == [(impl, 63) for impl in ("plain", "flash") for _ in range(5)]
    assert eng._chunk_fns == {} and eng._slots == {}
    assert eng._probed_decode_impl == {128: choice}
    monkeypatch.setattr(DecodeGraph, "replay", replay)
    want = list(kernel_shaped_engine().generate_tokens(PROMPT, max_new_tokens=6))
    got = list(eng.generate_tokens(PROMPT, max_new_tokens=6))
    bucket = eng.cache_bucket(len(PROMPT), 6)
    assert {g.impl for g in eng._chunk_fns.values()} == {eng._probed_decode_impl[bucket]}
    # the kernels' plain versions round as the plain path does to a few
    # ulps; greedy tokens on these random weights agree where the argmax
    # is decisive, which a 6-token stream at these widths is
    assert [t for _, t in got] == [t for _, t in want]


def test_a_failing_candidate_raises(monkeypatch):
    """The JAX probe skips a candidate that fails; the port's raises, so a
    kernel fault never quietly gives way to the plain path."""
    eng = kernel_shaped_engine(attn_impl="probe")
    monkeypatch.setattr(InferenceEngine, "_decode_candidates",
                        lambda self, cache_len: ["plain", "flash"])
    replay = DecodeGraph.replay

    def failing(graph):
        if graph.impl == "flash":
            raise RuntimeError("planted: the kernel fails")
        replay(graph)

    monkeypatch.setattr(DecodeGraph, "replay", failing)
    with pytest.raises(RuntimeError, match="planted"):
        eng.autotune_attn_impl(cache_len=128)
    assert eng._probed_decode_impl == {}


@pytest.mark.parametrize("kv,shape_fits,want", [
    ("bf16", True, {128: ["plain", "flash"], 200: ["plain", "flash"]}),
    ("int8", True, {128: ["plain", "flash"], 200: ["plain"]}),
    ("bf16", False, {128: ["plain"], 256: ["plain"]})])
def test_probe_candidates_on_a_card(kv, shape_fits, want):
    """The candidates a card would time: the kernels only where ``auto``
    could take them (the model's shape; an int8 cache at a multiple of 128
    slots). The rule is read for a card without running on one."""
    eng, _ = engines(False, kv_cache_dtype=kv)
    eng.device = torch.device("cuda", 0)
    if shape_fits:
        eng.model.cfg = dataclasses.replace(eng.model.cfg, dim=512, n_kv_heads=1)
    for cache_len, candidates in want.items():
        assert eng._decode_candidates(cache_len) == candidates
    eng.device = torch.device("cpu")
    assert eng._decode_candidates(128) == ["plain"]


def test_batchers_keep_the_auto_rules_under_probe():
    """The JAX batchers bypass the probe: it measures one row at one
    position, which does not carry over to an [n_slots]-row step. Neither
    batcher's construction probes."""
    eng, _ = engines(False, attn_impl="probe")
    eng.autotune_attn_impl = None                 # a probe would call None
    assert ContinuousBatcher(eng, n_slots=2)._decode_impl == "plain"
    assert eng._probed_decode_impl == {}
    card, _ = engines(False, attn_impl="probe")
    card.device = torch.device("cuda", 0)
    card.model.cfg = dataclasses.replace(card.model.cfg, dim=512, n_kv_heads=1)
    auto, _ = engines(False)
    auto.device, auto.model.cfg = card.device, card.model.cfg
    for block_size in (32, 12):
        assert default_attn_impl(card, block_size) == default_attn_impl(auto, block_size)
    assert card._auto_attn_impl(1, 256) == auto._attn_impl(1, 256) == "flash"
