"""Speculative decoding in the PyTorch port against the JAX package.

  * ``NgramProposer`` and ``longest_accepted_prefix`` give exactly the JAX
    outputs on seeded and hypothesis-drawn token lists;
  * ``DraftModelProposer`` drafts exactly what JAX's drafts on a
    constructed-cyclic model (wo and w_down zeroed, head rows that walk a
    fixed cycle, so every argmax is decisive), through a rejection and a
    catch-up of more than one bucket;
  * the sequential speculative engine's token stream and ``spec_stats``
    equal JAX ``_generate_tokens_speculative``'s for k in {1, 2, 4}: n-gram
    drafts, at the sequence-length cap, with an int8 cache, and with draft
    models of the same cycle (everything accepted) and of another cycle
    (every draft rejected);
  * on random weights, where attention moves the logits, a scripted
    reject / accept / no-draft sequence emits the plain greedy stream and
    leaves the plain cache rows, and a planted fault (the slot's position
    not rewound after a rejection) is caught by the same check;
  * the verify graph's body (run eagerly on the CPU) is ``forward`` and an
    argmax; ``paged_decode_step_spec`` against JAX's (logits and pool);
  * ``/metrics`` and ``/health`` of a tiny speculative server, and the two
    CLIs' ``--speculate`` and ``--draft-model``.

The batchers' speculation is in tests/test_torch_speculative_batchers.py."""

import dataclasses
import json
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.io.params import ModelArgs as JModelArgs
from llama_nuts_and_bolts_tpu.models.llama import model as jmodel
from llama_nuts_and_bolts_tpu.models.llama import paged as jpaged
from llama_nuts_and_bolts_tpu.models.llama.loader import LoadedModel as JLoadedModel
from llama_nuts_and_bolts_tpu.runtime import InferenceArgs as JInferenceArgs
from llama_nuts_and_bolts_tpu.runtime import InferenceEngine as JInferenceEngine
from llama_nuts_and_bolts_tpu.runtime import speculative as jspec

from llama_nuts_and_bolts_tpu_torch.cli import main as cli_main
from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama import paged
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import (
    params_from_numpy,
    tensor_to_numpy,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.loader import LoadedModel
from llama_nuts_and_bolts_tpu_torch.models.llama.model import forward
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.runtime import engine as engine_mod
from llama_nuts_and_bolts_tpu_torch.runtime import speculative as spec
from llama_nuts_and_bolts_tpu_torch.runtime.decode_graph import VerifyGraph
from llama_nuts_and_bolts_tpu_torch.serving import __main__ as serving_main
from llama_nuts_and_bolts_tpu_torch.serving.server import LlamaHTTPServer
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests.test_torch_continuous import one_torch_thread
from tests.test_torch_engine import SPEC, leaves, tokenizers

C = 7                        # the cyclic models walk the tokens 0..6
CYCLIC_PROMPT = [3, 4, 5, 6, 0, 1, 2, 3]
JCFG, CFG = JModelArgs(**SPEC), ModelArgs(**SPEC)
_PARAMS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def jax_params(seed: int = 1, step=None):
    """Seeded split-layout JAX params; with ``step`` the cyclic model whose
    greedy successor of token t < C is (t + step) % C."""
    if (seed, step) in _PARAMS:
        return _PARAMS[(seed, step)]
    jp = jax.jit(jmodel.init_random_params, static_argnums=(0,))(JCFG, jax.random.PRNGKey(seed))
    if step is not None:
        layers = dict(jp.layers)
        layers["wo"] = jnp.zeros_like(layers["wo"])
        layers["w_down"] = jnp.zeros_like(layers["w_down"])
        out = np.zeros(jp.output.shape, np.float32)
        emb = np.asarray(jp.tok_embeddings, np.float32)
        for t in range(C):
            out[(t + step) % C] = emb[t]
        jp = dataclasses.replace(jp, layers=layers, output=jnp.asarray(out, jnp.bfloat16))
    _PARAMS[(seed, step)] = jp
    return jp


def models(jp):
    """The same weights as a JAX and a port ``LoadedModel``."""
    ranks, vocab, jvocab = tokenizers()
    return (JLoadedModel(params=jp, cfg=JCFG, vocab=jvocab, mergeable_ranks=ranks,
                         tensor_meta={}),
            LoadedModel(params=params_from_numpy(leaves(jp), "cpu"), cfg=CFG, vocab=vocab,
                        mergeable_ranks=ranks, tensor_meta={}))


def engines(jp, seq_len, draft=None, **args):
    """A port and a JAX engine on ``jp``, with ``draft`` params as the draft."""
    jmodel_, model = models(jp)
    jdraft, pdraft = models(draft) if draft is not None else (None, None)
    eng = InferenceEngine(model, InferenceArgs(sequence_length=seq_len, **args),
                          draft_model=pdraft, device="cpu")
    jeng = JInferenceEngine(jmodel_, JInferenceArgs(sequence_length=seq_len, decode_chunk=1,
                                                    **args), draft_model=jdraft)
    return eng, jeng


def stream(eng, prompt, max_new=None):
    return [(s.name, t) for s, t in eng.generate_tokens(prompt, max_new_tokens=max_new)]


# --------------------------------------------------------------- proposers

def test_ngram_and_prefix_match_jax_on_seeded_lists():
    rng = np.random.default_rng(0)
    for _ in range(300):
        ctx = rng.integers(0, 4, rng.integers(0, 24)).tolist()
        k, n = int(rng.integers(0, 6)), int(rng.integers(1, 5))
        assert spec.NgramProposer(ctx, n).propose(k) == jspec.NgramProposer(ctx, n).propose(k)
        drafts = rng.integers(0, 3, rng.integers(0, 6)).tolist()
        preds = rng.integers(0, 3, len(drafts) + 1).tolist()
        assert (spec.longest_accepted_prefix(drafts, preds)
                == jspec.longest_accepted_prefix(drafts, preds))


@settings(max_examples=150, deadline=None, database=None)
@given(ctx=st.lists(st.integers(0, 5), max_size=30), extra=st.lists(st.integers(0, 5),
                                                                      max_size=6),
       k=st.integers(0, 6), n=st.integers(1, 4))
def test_ngram_matches_jax_on_drawn_lists(ctx, extra, k, n):
    mine, theirs = spec.NgramProposer(ctx, n), jspec.NgramProposer(ctx, n)
    assert mine.propose(k) == theirs.propose(k)
    mine.extend(extra)
    theirs.extend(extra)
    assert mine.propose(k) == theirs.propose(k)


@settings(max_examples=150, deadline=None, database=None)
@given(drafts=st.lists(st.integers(0, 3), max_size=8), preds=st.lists(st.integers(0, 3),
                                                                       max_size=9))
def test_longest_accepted_prefix_matches_jax_on_drawn_lists(drafts, preds):
    assert (spec.longest_accepted_prefix(drafts, preds)
            == jspec.longest_accepted_prefix(drafts, preds))


def test_draft_proposer_matches_jax_through_rejection_and_catch_up():
    """Cyclic draft: drafts equal JAX's and the cycle; after a rejection
    (context extended with other tokens) and after a catch-up of 20 tokens
    (a 32-token bucket) they still equal JAX's and a fresh proposer's."""
    jdraft, draft = models(jax_params(step=1))
    ctx = [1, 2, 3, 4]
    mine = spec.DraftModelProposer(draft, ctx, seq_len=64)
    theirs = jspec.DraftModelProposer(jdraft, ctx, seq_len=64)
    assert mine.propose(3) == theirs.propose(3) == [5, 6, 0]
    for more in ([5, 2], [(3 * i) % C for i in range(20)]):
        mine.extend(more)
        theirs.extend(more)
        ctx = ctx + more
        got = mine.propose(3)
        assert got == theirs.propose(3) == [(more[-1] + 1 + i) % C for i in range(3)]
        assert got == spec.DraftModelProposer(draft, ctx, seq_len=64).propose(3)
    assert mine.propose(64) == [] == theirs.propose(64)        # past the context


# ------------------------------------------------------- sequential engine

ENGINE_CASES = {
    # (params, draft, seq_len, engine args, prompt)
    "ngram": (1, None, 48, {}, CYCLIC_PROMPT),
    "seq_cap": (1, None, 14, {}, CYCLIC_PROMPT),
    "int8_cache": (1, None, 40, {"kv_cache_dtype": "int8"}, CYCLIC_PROMPT),
    "same_cycle_draft": (1, 1, 32, {}, [1, 2]),
    "other_cycle_draft": (1, 2, 32, {}, [1, 2]),
}


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_speculative_engine_equals_jax(case, k):
    """Stream and ``spec_stats`` equal JAX's on the cyclic model, and the
    stream is the plain greedy one."""
    step, draft_step, seq_len, args, prompt = ENGINE_CASES[case]
    draft = None if draft_step is None else jax_params(step=draft_step)
    eng, jeng = engines(jax_params(step=step), seq_len, draft, speculate_k=k, **args)
    got = stream(eng, prompt)
    assert got == stream(jeng, prompt)
    assert eng.spec_stats == jeng.spec_stats
    plain = InferenceEngine(eng.model, InferenceArgs(sequence_length=seq_len, **args),
                            device="cpu")
    assert got == stream(plain, prompt)
    stats = eng.spec_stats
    assert got[-1][0] == "FINISHED_BY_REACHING_SEQ_LEN"
    assert stats["steps"] < len(got) and stats["drafted"] > 0
    if case == "other_cycle_draft":
        assert stats["accepted"] == 0
    elif case != "seq_cap":
        assert stats["accepted"] > 0
    if case == "same_cycle_draft":
        assert stats["accepted"] == stats["drafted"]
    # a cap ends the stream early and leaves the slot free
    assert stream(eng, prompt, 3) == got[:2] + [("IN_PROGRESS", got[2][1])]
    assert not any(s.leased for slots in eng._slots.values() for s in slots)


def test_sampled_requests_ignore_speculate_k():
    eng, jeng = engines(jax_params(step=1), 32, speculate_k=4, temperature=0.7, seed=5)
    plain = InferenceEngine(eng.model, InferenceArgs(sequence_length=32, temperature=0.7,
                                                     seed=5), device="cpu")
    assert stream(eng, [1, 2, 3], 10) == stream(plain, [1, 2, 3], 10)
    assert not hasattr(eng, "spec_stats")


def test_draft_model_refusals():
    _, model = models(jax_params(step=1))
    small = dataclasses.replace(model, cfg=dataclasses.replace(CFG, vocab_size=256))
    with pytest.raises(ValueError, match="draft model vocab"):
        InferenceEngine(model, InferenceArgs(speculate_k=2), draft_model=small, device="cpu")


class PositionNotRewound(VerifyGraph):
    """The planted fault: the position is set at the first verify only, and
    each replay moves it on by k+1 as if every draft had been accepted."""

    def set(self, tokens, position):  # lint: ok (overrides VerifyGraph.set)
        if self.replays == 0:
            super().set(tokens, position)
        else:
            self.feed.copy_(torch.tensor([tokens], dtype=torch.int32))

    def _body(self):
        super()._body()
        self.slot.pos.add_(self.k + 1)


def scripted_run(monkeypatch, graph_cls=VerifyGraph):
    """Random weights, k = 3: a scripted proposer rejects every draft, then
    drafts the plain stream's next three tokens (all accepted), then drafts
    nothing (the one-step graph runs), then one right token and two wrong
    ones, in turn. Returns the tokens, the plain ones, the rows of both
    slots' caches that the plain run wrote, and the stats."""
    jp = jax_params(seed=6)
    _, model = models(jp)
    prompt = [11, 40, 7, 99, 23, 5]
    seq_len, n = 64, 18
    plain = InferenceEngine(model, InferenceArgs(sequence_length=seq_len), device="cpu")
    # three tokens past the cap: the last drafts look that far
    truth = [t for _, t in plain.generate_tokens(prompt, max_new_tokens=n + 3)]
    calls = []

    def scripted(self, k):
        e = len(self.context) - len(prompt)            # tokens emitted so far
        good = truth[e:e + k]
        kind = len(calls) % 4
        calls.append(kind)
        if kind == 0:
            return [(good[0] + 1 + i) % 256 for i in range(k)]
        if kind == 1:
            return good
        if kind == 2:
            return []
        return good[:1] + [(good[1] + 1) % 256] + [good[2]]

    monkeypatch.setattr(spec.NgramProposer, "propose", scripted)
    monkeypatch.setattr(engine_mod, "VerifyGraph", graph_cls)
    eng = InferenceEngine(model, InferenceArgs(sequence_length=seq_len, speculate_k=3),
                          device="cpu")
    got = [t for _, t in eng.generate_tokens(prompt, max_new_tokens=n)]
    truth = truth[:n]
    rows = slice(0, len(prompt) + n - 1)
    (slot,) = eng._slots[(1, seq_len)]
    (ref,) = plain._slots[(1, seq_len)]
    caches = [(c.k[:, :, :, rows], c.v[:, :, :, rows]) for c in (slot.cache, ref.cache)]
    return got, truth, caches, eng.spec_stats, set(calls)


def test_reject_accept_fallback_keeps_the_plain_stream(monkeypatch):
    got, truth, (mine, plain), stats, kinds = scripted_run(monkeypatch)
    assert kinds == {0, 1, 2, 3}
    assert got == truth
    assert 0 < stats["accepted"] < stats["drafted"] and stats["spec_steps"] < stats["steps"]
    for a, b in zip(mine, plain):
        compare_tensor(tensor_to_numpy(a, ml_dtypes.bfloat16),
                       tensor_to_numpy(b, ml_dtypes.bfloat16), "bfloat16",
                       tolerance_multiplier=5.0)


def test_position_not_rewound_is_caught(monkeypatch):
    got, truth, (mine, plain), _, _ = scripted_run(monkeypatch, PositionNotRewound)
    with pytest.raises(AssertionError):
        assert got == truth
        for a, b in zip(mine, plain):
            compare_tensor(tensor_to_numpy(a, ml_dtypes.bfloat16),
                           tensor_to_numpy(b, ml_dtypes.bfloat16), "bfloat16",
                           tolerance_multiplier=5.0)


@pytest.mark.parametrize("k", [1, 4])
def test_verify_graph_body_is_forward_and_argmax(k):
    """On the CPU the verify graph runs its body on the slot's buffers:
    ``forward`` at S = k+1 from the set position, the argmax of every row;
    the slot's cache gets the rows an eager ``forward`` writes."""
    _, model = models(jax_params(seed=6))
    eng = InferenceEngine(model, InferenceArgs(sequence_length=64, speculate_k=k),
                          device="cpu")
    prompt = list(range(20, 33))
    tokens = [7, 91, 4, 200, 31][:k + 1]
    with eng._lease(1, 64) as slot:
        eng._prefill(prompt, 64, cache=slot.cache)
        ref = slot.cache.truncated(64)
        graph = eng._verify_graph(k, slot)
        graph.set(tokens, len(prompt))
        graph.replay()
        got = graph.tokens(graph.fetch())
        logits, ref = forward(model.params, CFG, torch.tensor([tokens], dtype=torch.int32),
                              len(prompt), ref)
        assert got == torch.argmax(logits[0], dim=-1).tolist()
        assert torch.equal(slot.cache.k, ref.k) and torch.equal(slot.cache.v, ref.v)
        assert int(slot.pos[0]) == len(prompt)       # the host moves the position
    assert eng._chunk_fns[("verify", k, 64, slot.index)] is graph


# ------------------------------------------------------ paged verify step

@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_decode_step_spec_matches_jax(kv):
    """Two requests prefilled into their blocks, then one verify step of
    three rows each (the second crossing a block boundary) beside a free
    slot on the trash block at the table's end: logits within the bf16
    drift bar of tests/test_torch_model.py, and every pool block but the
    trash block likewise."""
    jp = jax_params(seed=4)
    params = params_from_numpy(leaves(jp), "cpu")
    int8, bs, n_blocks = kv == "int8", 8, 12
    jpool = jpaged.PagedKVPool.create(JCFG, n_blocks, bs, dtype=jnp.int8 if int8 else
                                      jnp.bfloat16)
    pool = paged.PagedKVPool.create(CFG, n_blocks, bs, torch.int8 if int8 else
                                    torch.bfloat16, device="cpu")
    rng = np.random.default_rng(3)
    tables = np.array([[3, 7, 0, 0], [5, 9, 2, 0], [0, 0, 0, 0]], np.int32)
    prefill = jax.jit(jpaged.paged_prefill, static_argnums=(1,))
    for row, plen in ((0, 6), (1, 14)):
        tokens = np.zeros((1, 16), np.int32)
        tokens[0, :plen] = rng.integers(0, 256, plen)
        _, jpool = prefill(jp, JCFG, jnp.asarray(tokens), plen - 1, jpool,
                           jnp.asarray(tables[row]))
        paged.paged_prefill(params, CFG, torch.from_numpy(tokens), plen - 1, pool,
                            torch.from_numpy(tables[row]))
    tokens = rng.integers(0, 256, (3, 3)).astype(np.int32)
    positions = np.array([6, 14, 31], np.int32)
    jlogits, jpool = jax.jit(jpaged.paged_decode_step_spec, static_argnums=(1,))(
        jp, JCFG, jnp.asarray(tokens), jnp.asarray(positions), jpool, jnp.asarray(tables))
    logits, pool = paged.paged_decode_step_spec(params, CFG, torch.from_numpy(tokens),
                                                torch.from_numpy(positions), pool,
                                                torch.from_numpy(tables))
    assert logits.shape == (3, 3, CFG.vocab_size)
    compare_tensor(logits.numpy(), np.asarray(jlogits), "bfloat16", tolerance_multiplier=5.0)
    for name in ("k", "v"):
        mine = tensor_to_numpy(getattr(pool, name), ml_dtypes.bfloat16).astype(np.float32)
        theirs = np.asarray(getattr(jpool, name)).astype(np.float32)
        if int8:
            mine = mine * tensor_to_numpy(getattr(pool, name + "_scale"),
                                          ml_dtypes.bfloat16).astype(np.float32)[..., None]
            theirs = theirs * np.asarray(getattr(jpool, name + "_scale")).astype(
                np.float32)[..., None]
        compare_tensor(mine[:, 1:], theirs[:, 1:], "bfloat16", tolerance_multiplier=5.0)


# ----------------------------------------------------------- server, CLIs

def get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read().decode()


@pytest.mark.parametrize("paged_blocks", [0, 12])
def test_speculative_server_metrics_and_health(paged_blocks):
    """A tiny speculative server (dense or paged batcher) answers a chat;
    ``/metrics`` carries the ``llama_spec_*`` counters, ``/health``
    ``continuous.speculation``, both from the batcher's counters."""
    _, model = models(jax_params(step=1))
    eng = InferenceEngine(model, InferenceArgs(sequence_length=96, speculate_k=4),
                          device="cpu")
    srv = LlamaHTTPServer(eng, model_name="tiny-spec", continuous_slots=2,
                          paged_blocks=paged_blocks)
    try:
        url = f"http://127.0.0.1:{srv.start_background()}"
        req = srv.batcher.submit(CYCLIC_PROMPT, max_new_tokens=24)
        assert [t for _, t in req.tokens(timeout=30)] == [(4 + i) % C for i in range(24)]
        metrics = {line.split()[0]: float(line.split()[1])
                   for line in get(url + "/metrics").splitlines()
                   if line.startswith("llama_spec_")}
        stats = srv.batcher.spec_stats_snapshot()
        assert metrics == {"llama_spec_drafted_total": stats["drafted"],
                           "llama_spec_accepted_total": stats["accepted"],
                           "llama_spec_verify_steps_total": stats["spec_steps"]}
        assert 0 < stats["accepted"] <= stats["drafted"]
        health = json.loads(get(url + "/health"))["continuous"]["speculation"]
        assert health == {"k": 4, "drafted": stats["drafted"], "accepted": stats["accepted"],
                          "acceptance": round(stats["accepted"] / stats["drafted"], 4)}
    finally:
        srv.shutdown()


def test_speculate_and_draft_model_flags_parse_in_both_clis():
    for parse in (cli_main.parse_args, serving_main.parse_args):
        args = parse(["--speculate", "4", "--draft-model", "drafts/llama-3.2-1b"])
        assert args.speculate == 4 and args.draft_model == "drafts/llama-3.2-1b"
        assert parse([]).speculate == 0 and parse([]).draft_model is None
    for main in (cli_main.main, serving_main.main):
        with pytest.raises(SystemExit, match="--tiny model has none"):
            main(["--tiny", "--device", "cpu", "--speculate", "2", "--draft-model", "d"])


def test_cli_speculate_keeps_the_transcript(capsys):
    """``--speculate 4`` on the tiny CLI prints the Assistant line and the
    finish of the plain run."""
    def assistant(*extra):
        assert cli_main.main(["--tiny", "--device", "cpu", "--prompt-text", "hello",
                              "--seq-len", "48", *extra]) == 0
        out = capsys.readouterr().out
        assert "Finished \x1b[1mby reaching sequence length" in out
        return [line for line in out.splitlines() if "Assistant" in line][-1]

    assert assistant("--speculate", "4") == assistant()


def test_cli_loads_a_draft_checkpoint_of_another_head_dim(tmp_path, capsys, monkeypatch):
    """``--draft-model DIR`` loads a Meta-format checkpoint through the
    port's loader: a 1-layer draft of head_dim 16 (no kernel takes it, and
    none is chosen) beside a target of head_dim 8, on the CPU; the
    transcript is the plain run's."""
    import base64

    from llama_nuts_and_bolts_tpu_torch.models.llama.loader import expected_tensor_shapes

    ranks = [base64.b64encode(bytes([i])).decode() + f" {i}" for i in range(256)]
    dirs = {}
    for name, cfg in (("target", ModelArgs(dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                                           vocab_size=512, multiple_of=16)),
                      ("draft", ModelArgs(dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                                          vocab_size=512, multiple_of=16))):
        d = tmp_path / name
        d.mkdir()
        (d / "tokenizer.model").write_text("\n".join(ranks) + "\n")
        (d / "params.json").write_text(json.dumps({
            "dim": cfg.dim, "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "vocab_size": cfg.vocab_size,
            "multiple_of": cfg.multiple_of, "norm_eps": 1e-5}))
        gen = torch.Generator().manual_seed(len(name))
        torch.save({n: (torch.randn(shape, generator=gen) / 4).to(torch.bfloat16)
                    for n, shape in expected_tensor_shapes(cfg).items()},
                   str(d / "consolidated.00.pth"))
        dirs[name] = str(d)

    def assistant(*extra):
        assert cli_main.main(["--model-dir", dirs["target"], "--device", "cpu",
                              "--prompt-text", "hello", "--seq-len", "40", *extra]) == 0
        out = capsys.readouterr().out
        assert "Finished \x1b[1mby reaching" in out
        return out, [line for line in out.splitlines() if "Assistant" in line][-1]

    drafted = []
    real = spec.DraftModelProposer.propose
    monkeypatch.setattr(spec.DraftModelProposer, "propose",
                        lambda self, k: drafted.append(k) or real(self, k))
    out, spec_line = assistant("--speculate", "3", "--draft-model", dirs["draft"])
    assert f'Draft model "{dirs["draft"]}" was loaded.' in out and drafted
    assert spec_line == assistant()[1]
