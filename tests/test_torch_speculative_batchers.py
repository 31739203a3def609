"""Speculation in the port's dense and paged continuous batchers.

On the constructed-cyclic model (tests/test_torch_speculative.py), where
every argmax is decisive, each batcher's greedy streams equal the port's
sequential engine's, and both its streams and ``spec_stats`` equal the JAX
package's batcher on the same schedule (the JAX package's
``test_continuous.py`` and ``test_paged.py`` ``spec`` cases): n-gram drafts
across block boundaries, greedy beside sampled requests, the sequence cap
under rejected drafts, a pool too small to back the drafts, a proposer that
gets one draft right and the rest wrong every step, and a request admitted
during a neighbour's rejections. On random weights, where attention moves
the logits, the dense batcher's rejected draft rows must leave the cache
rows the sequential engine writes."""

import ml_dtypes
import pytest

from llama_nuts_and_bolts_tpu.runtime import speculative as jspec
from llama_nuts_and_bolts_tpu.runtime.continuous import ContinuousBatcher as JContinuous
from llama_nuts_and_bolts_tpu.runtime.paged import PagedBatcher as JPaged

from llama_nuts_and_bolts_tpu_torch.models.llama.convert import tensor_to_numpy
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.runtime import speculative as spec
from llama_nuts_and_bolts_tpu_torch.runtime.continuous import ContinuousBatcher
from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests.test_torch_continuous import one_torch_thread
from tests.test_torch_speculative import C, CYCLIC_PROMPT, engines, jax_params

BS = 8                     # pool blocks of 8 positions: verify rows cross them


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def batchers(kind, seq_len, n_slots, K, n_blocks=None, **args):
    """The port's and the JAX package's batcher of ``kind`` on the cyclic
    model, and the port's engine."""
    eng, jeng = engines(jax_params(step=1), seq_len, **args)
    if kind == "dense":
        return (ContinuousBatcher(eng, n_slots=n_slots, speculate_k=K),
                JContinuous(jeng, n_slots=n_slots, speculate_k=K, step_quantum=1), eng)
    return (PagedBatcher(eng, n_slots=n_slots, block_size=BS, n_blocks=n_blocks,
                         speculate_k=K),
            JPaged(jeng, n_slots=n_slots, block_size=BS, n_blocks=n_blocks, speculate_k=K,
                   step_quantum=1, attn_impl="xla"), eng)


def run(batcher, submissions, steps_before=()):
    """Submit ``submissions`` ((prompt, kwargs) pairs; those whose index is
    in ``steps_before`` after three steps) and run until idle; returns the
    streams."""
    reqs = []
    for i, (prompt, kw) in enumerate(submissions):
        if i in steps_before:
            for _ in range(3):
                batcher.step()
        reqs.append(batcher.submit(prompt, **kw))
    batcher.run_until_idle()
    return [[(s.name, t) for s, t in r.tokens(timeout=30)] for r in reqs]


def sequential(eng, prompt, max_new=None):
    plain = InferenceEngine(eng.model, InferenceArgs(sequence_length=eng.seq_len,
                                                     kv_cache_dtype=eng.args.kv_cache_dtype),
                            device="cpu")
    return [t for _, t in plain.generate_tokens(prompt, max_new_tokens=max_new)]


def toks(stream):
    return [t for _, t in stream]


def check(kind, subs, seq_len=32, n_slots=3, K=3, n_blocks=None, steps_before=(), **args):
    """Port and JAX batchers on one schedule: equal streams and stats, and
    the greedy streams a prefix of the sequential engine's (the whole of it
    unless the pool ended the request). Returns the port's batcher."""
    cb, jcb, eng = batchers(kind, seq_len, n_slots, K, n_blocks, **args)
    got = run(cb, subs, steps_before)
    want = run(jcb, subs, steps_before)
    assert cb.spec_stats == jcb.spec_stats
    for (prompt, kw), mine, theirs in zip(subs, got, want):
        assert mine[-1][0] != "IN_PROGRESS"
        if kw.get("temperature"):
            continue                     # each package draws its own samples
        assert mine == theirs
        ref = sequential(eng, prompt, kw.get("max_new_tokens"))
        if n_blocks is None:
            assert toks(mine) == ref
        else:
            assert toks(mine) == ref[:len(mine)]
    if kind == "paged":
        assert cb.allocator.available == cb.allocator.n_blocks - 1
    return cb, got


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_batcher_matches_sequential_and_jax(kind):
    cb, _ = check(kind, [(CYCLIC_PROMPT, {}), ([1, 2], {}), ([5, 5, 5, 6], {})])
    assert cb.spec_stats["accepted"] > 0 and cb.verify_steps > 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_batcher_accepts_across_block_boundaries(kind):
    """K = 4 at seq_len 48: accepted chains stride across 8-position blocks."""
    cb, (out,) = check(kind, [([3, 3, 3, 3], {})], seq_len=48, n_slots=2, K=4)
    assert len(out) > 12 and cb.spec_stats["accepted"] > 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_batcher_mixed_greedy_and_sampled(kind):
    """Sampled slots ride the verify steps without drafting: greedy
    neighbours still match; a sampled stream repeats with its seed and is
    the plain batcher's for that seed."""
    subs = [(CYCLIC_PROMPT, {"max_new_tokens": 10}),
            ([1, 2], {"max_new_tokens": 10, "temperature": 1.1, "seed": 4})]
    cb, (_, sampled) = check(kind, subs, n_slots=2)
    again, _, eng = batchers(kind, 32, 2, 3)
    assert run(again, subs[1:]) == [sampled]
    plain = (ContinuousBatcher(eng, n_slots=2) if kind == "dense"
             else PagedBatcher(eng, n_slots=2, block_size=BS))
    assert run(plain, subs[1:]) == [sampled]


def garbage(self, k):
    """Drafts off the cycle: each one is rejected."""
    return [C + (3 + 5 * i) % 200 for i in range(k)]


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("cap", [10, 11, 12])
def test_spec_max_drafts_rejected_at_seq_cap(monkeypatch, kind, cap):
    """K garbage drafts every step while the context runs into the cap: the
    draft rows spill past it and never touch the rows below."""
    for cls in (spec.NgramProposer, jspec.NgramProposer):
        monkeypatch.setattr(cls, "propose", garbage)
    cb, _ = check(kind, [([1, 5, 9, 1, 5], {})], seq_len=cap, n_slots=1, K=4)
    assert cb.spec_stats["accepted"] == 0


def test_paged_spec_pool_starvation_clamps_drafts():
    """Four usable blocks of 8 for two requests drafting 4: the draft count
    is clamped to what the pool backs, requests end gracefully with a prefix
    of their sequential streams, and every block returns."""
    subs = [([1, 2, 3], {"max_new_tokens": 6}), ([4, 5], {"max_new_tokens": 6})]
    cb, _ = check("paged", subs, n_slots=2, K=4, n_blocks=5)
    assert cb.allocator.available == 4


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_accept_then_reject_every_step(monkeypatch, kind):
    """The first draft right, the rest wrong, every step: each step leaves
    K-1 rejected rows right after an accepted one."""
    prompt = [1, 2, 3]

    def one_right(self, k):
        last = self.context[-1]
        return [(last + 1) % C] + [(last + 3 + i) % C for i in range(k - 1)]

    for cls in (spec.NgramProposer, jspec.NgramProposer):
        monkeypatch.setattr(cls, "propose", one_right)
    cb, _ = check(kind, [(prompt, {})], seq_len=24, n_slots=1, K=4)
    assert 0 < cb.spec_stats["accepted"] < cb.spec_stats["drafted"]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_interleaved_admission_with_rejections(monkeypatch, kind):
    """A request admitted while its neighbour's drafts are all rejected."""
    for cls in (spec.NgramProposer, jspec.NgramProposer):
        monkeypatch.setattr(cls, "propose", garbage)
    check(kind, [([1, 5, 9], {}), ([6, 0], {})], seq_len=24, n_slots=2, K=4,
          steps_before=(1,))


def test_dense_rejected_rows_leave_the_sequential_cache_rows(monkeypatch):
    """Random weights: a proposer that drafts the sequential stream's next
    token right and three wrong ones every step. The batcher's tokens are
    the sequential engine's and its slot's cache rows are the engine's
    (bf16 drift bar of tests/test_torch_model.py)."""
    from tests.test_torch_speculative import models

    _, model = models(jax_params(seed=6))
    prompt, n, seq_len = [11, 40, 7, 99, 23, 5], 18, 64
    eng = InferenceEngine(model, InferenceArgs(sequence_length=seq_len), device="cpu")
    truth = [t for _, t in eng.generate_tokens(prompt, max_new_tokens=n)]

    def one_right(self, k):
        e = len(self.context) - len(prompt)
        return truth[e:e + 1] + [(t + 1) % 256 for t in truth[e + 1:e + k]]

    monkeypatch.setattr(spec.NgramProposer, "propose", one_right)
    cb = ContinuousBatcher(eng, n_slots=2, speculate_k=4)
    req = cb.submit(prompt, max_new_tokens=n)
    cb.run_until_idle()
    assert [t for _, t in req.tokens(timeout=30)] == truth
    assert 0 < cb.spec_stats["accepted"] < cb.spec_stats["drafted"]
    rows = slice(0, len(prompt) + n - 1)
    (slot,) = eng._slots[(1, seq_len)]
    for mine, theirs in ((cb.cache.k[:, :1], slot.cache.k), (cb.cache.v[:, :1], slot.cache.v)):
        compare_tensor(tensor_to_numpy(mine[:, :, :, rows], ml_dtypes.bfloat16),
                       tensor_to_numpy(theirs[:, :, :, rows], ml_dtypes.bfloat16),
                       "bfloat16", tolerance_multiplier=5.0)


def test_spec_mode_steps_one_token_at_a_time():
    cb, _, _ = batchers("paged", 32, 2, 3)
    assert cb.step_quantum == 1
    eng = cb.engine
    assert ContinuousBatcher(eng, n_slots=2, speculate_k=2, step_quantum=4).step_quantum == 1
    assert ContinuousBatcher(eng, n_slots=2, speculate_k=2).cache.max_seq == eng.seq_len + 2
