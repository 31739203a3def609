"""The port's expert layer (``ops/moe.py``, Mixtral's: top-2 of 8 SwiGLU
experts) against the Mixtral family's plain reference
(``portbench/families/mixtral.py``, imported by path), at a tiny size on
the CPU: dim 256, 4 layers, 8 experts of 512, H/KV 8/2.

  * the expert layer alone, both weight layouts, the plain loop and the
    grouped products (``torch._grouped_mm``, the card's path): the routed
    sets equal the reference's, the outputs agree to float32 rounding; the
    row mask and the recorded ids;
  * float32 weights (the caches stay bf16): ``forward`` on the dense cache,
    split and fused, the paged prefill, a prefix hit's suffix, the paged
    step with a free slot, and both verify steps against the reference's
    logits, with the routed sets equal wherever the reference's margin
    between its 2nd and 3rd expert is wider than the bf16 cache moves it;
  * both batchers' streams and the engine's (fused layout) held to the
    reference's best token; bf16 weights through the paged batcher held to
    it under the routing tie rule (the reference follows the experts the
    batcher logged within ``tau``, measured here as the rule says,
    ``portbench/router_gap.py``), and the rule itself: followed within
    ``tau``, refused beyond it;
  * the batchers' ``expert_rows`` and ``experts_hit`` against hand counts, on
    the steps' and admissions' spans and the counters; their routing log
    holds every served row's experts at its position;
  * a mesh and int8 / int4 weights refuse a model with experts; Mistral's
    ``moe`` block of ``params.json``; a dense model's logits and caches
    bit-equal to the commit before the expert layer (pinned hashes).
"""

import hashlib
import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs, load_model_args
from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel
from llama_nuts_and_bolts_tpu_torch.models.llama import paged
from llama_nuts_and_bolts_tpu_torch.models.llama.model import (
    KVCache,
    LlamaParams,
    forward,
    fuse_decode_params,
    init_random_params,
    rope_tables,
)
from llama_nuts_and_bolts_tpu_torch.ops import moe
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.runtime.continuous import ContinuousBatcher
from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher
from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
from tests.test_torch_continuous import one_torch_thread

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "mixtral_family", ROOT / "portbench" / "families" / "mixtral.py")
mixtral = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mixtral)

CFG = {"dim": 256, "n_layers": 4, "n_heads": 8, "n_kv_heads": 2, "multiple_of": 256,
       "ffn_dim_multiplier": 0.75, "vocab_size": 512, "norm_eps": 1e-5,
       "rope_theta": 1e6, "use_scaled_rope": False, "max_sequence_length": 256,
       "n_experts": 8, "n_experts_per_tok": 2}
ARGS = ModelArgs(**{k: v for k, v in CFG.items() if k != "use_scaled_rope"})
DIMS = mixtral.MixtralDims.from_config(CFG)
CPU = torch.device("cpu")
SEED = 2**31 + 25
# the bf16 caches move the router's logits by a few 1e-3 at this size; a
# margin wider than this is held to the reference's own choice
CACHE_MARGIN = 0.02
# a served token's logit below the reference's best: the bf16 caches' and
# near-tied argmaxes' reach at this size, far under a wrong expert's
SERVED_GAP = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def weights(dtype=torch.float32, seed=SEED):
    return {k: v.to(dtype) for k, v in mixtral.make_weights(DIMS, seed, CPU).items()}


def port_model(w, fused=False) -> LoadedModel:
    """The family's ``program`` over ``w``: the port's params at ARGS."""
    from portbench.entries import synthetic_vocab

    cos, sin = rope_tables(ARGS, CPU)
    params = LlamaParams(tok_embeddings=w["tok_embeddings"],
                         layers={k: w[k] for k in ("attn_norm", "ffn_norm")
                                 + mixtral.ATTN_KEYS + mixtral.EXPERT_KEYS},
                         norm=w["norm"], output=w["output"], rope_cos=cos, rope_sin=sin)
    if fused:
        params = fuse_decode_params(params)
    return LoadedModel(params=params, cfg=ARGS, vocab=synthetic_vocab(DIMS.vocab),
                       mergeable_ranks={}, tensor_meta={})


def prompt(n, seed=1):
    return torch.randint(0, DIMS.vocab, (n,), generator=torch.Generator().manual_seed(seed)
                         ).tolist()


class Recorded:
    """Every call of ``ops.moe.route`` while it is entered: the router's
    float32 logits and the chosen experts (``E`` for a masked row)."""

    def __enter__(self):
        self.calls, self._route = [], moe.route

        def recording(h, router, k, live=None):
            ids, weights = self._route(h, router, k, live)
            self.calls.append((moe.linear(h, router, out_dtype=torch.float32), ids))
            return ids, weights

        moe.route = recording
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def reference(w, tau=0.0):
    ref = mixtral.Reference(w, CFG, tau=tau)
    ref.record = []
    return ref


def ids_buffer(rows, layers=DIMS.n_layers):
    """A forward's routing ids ``[L, rows, 2]``, written by its layers."""
    return torch.zeros((layers, rows, 2), dtype=moe.IDS_DTYPE)


def routed_pairs(ids):
    """The (row, expert) pairs recorded in routing ids (``E`` routes none)."""
    return int((ids < DIMS.n_experts).sum())


@pytest.fixture
def impl(request, monkeypatch):
    """``"plain"``: the CPU's loop over the experts; ``"grouped"``: the
    card's grouped products, run here on CPU tensors in its place."""
    if request.param == "grouped":
        monkeypatch.setattr(moe, "_plain", moe._grouped)
    return request.param


def assert_routed_alike(port_logits, ref_logits, k=2):
    """The top-k sets of the port's and the reference's router logits ``[N,
    E]`` are equal wherever the reference's margin between its k-th and
    (k+1)-th is wider than CACHE_MARGIN; returns the rows compared."""
    top = torch.topk(ref_logits, k + 1).values
    clear = (top[:, k - 1] - top[:, k]) > CACHE_MARGIN
    mine = torch.sort(torch.topk(port_logits, k).indices).values
    theirs = torch.sort(torch.topk(ref_logits, k).indices).values
    assert torch.equal(mine[clear], theirs[clear])
    assert float((port_logits - ref_logits).abs().max()) < CACHE_MARGIN / 2
    return int(clear.sum())


def gaps(ref_rows, tokens):
    """The gaps of ``tokens`` below the best of each reference row."""
    tok = torch.tensor(tokens)
    return ref_rows.max(dim=-1).values - ref_rows.gather(1, tok[:, None])[:, 0]


# ------------------------------------------------------ the layer alone


def reference_layer(h, w):
    """The reference's routing and expert sum for rows ``h [N, dim]``."""
    ref = mixtral.Reference(w, CFG)
    router = h @ w["router"].T
    probs = torch.softmax(router, dim=-1)
    ids = torch.topk(router, 2).indices
    pr = probs.gather(1, ids)
    return ids, ref._experts(h, ids, pr / pr.sum(-1, keepdim=True), w)


def one_layer(w, fused):
    lw = {k: w[k][0] for k in mixtral.EXPERT_KEYS}
    if fused:
        lw = {"router": lw["router"],
              "e_gate_up": torch.cat([lw["e_gate"], lw["e_up"]], 1).transpose(1, 2).contiguous(),
              "e_down": lw["e_down"].transpose(1, 2).contiguous()}
    return lw


@pytest.mark.parametrize("impl", ["plain", "grouped"], indirect=True)
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_the_expert_layer_alone_matches_the_reference(impl, fused):
    w = weights()
    h = torch.randn(3, 11, DIMS.dim, generator=torch.Generator().manual_seed(4))
    ids, want = reference_layer(h.reshape(-1, DIMS.dim),
                                {k: w[k][0] for k in mixtral.EXPERT_KEYS})
    chosen = ids_buffer(33)
    got = moe.expert_ffn(h, one_layer(w, fused), 2, moe.Routing(chosen), layer=1)
    mine, _ = moe.route(h.reshape(-1, DIMS.dim), w["router"][0], 2)
    assert torch.equal(torch.sort(mine).values, torch.sort(ids).values)
    torch.testing.assert_close(got.reshape(-1, DIMS.dim), want, atol=2e-5, rtol=1e-5)
    assert torch.equal(chosen[1].long(), mine)
    assert not chosen[0].any() and not chosen[2:].any()
    assert moe.expert_stats(chosen[1:2].numpy(), 8) == (int(torch.unique(ids).numel()), 66)


@pytest.mark.parametrize("impl", ["plain", "grouped"], indirect=True)
def test_masked_rows_route_nothing_and_give_zero(impl):
    """Rows outside ``live`` take no expert, count nowhere and add 0; the
    live rows' outputs are those they have alone."""
    w = weights(torch.bfloat16)
    lw = one_layer(w, False)
    h = torch.randn(1, 9, DIMS.dim, generator=torch.Generator().manual_seed(5)).bfloat16()
    live = torch.tensor([True, False, True, True, False, False, True, True, False])
    chosen = ids_buffer(9, layers=1)
    got = moe.expert_ffn(h, lw, 2, moe.Routing(chosen, live))
    assert not got[0, ~live].any()
    alone = moe.expert_ffn(h[:, live], lw, 2)
    assert torch.equal(got[:, live], alone)
    ids, _ = moe.route(h[0, live], lw["router"], 2)
    assert routed_pairs(chosen) == 2 * int(live.sum())
    assert torch.equal(chosen[0, live].long(), ids) and (chosen[0, ~live] == 8).all()
    assert moe.expert_stats(chosen.numpy(), 8) == (int(torch.unique(ids).numel()),
                                                   2 * int(live.sum()))


def test_the_grouped_products_equal_the_plain_loop_in_bf16(monkeypatch):
    """The card's path (grouped products over the sorted pairs) and the CPU's
    loop give the same bf16 layer, with a masked row among them, to a bf16
    ulp of each element (and summation-order noise near zero)."""
    w = weights(torch.bfloat16)
    h = torch.randn(2, 13, DIMS.dim, generator=torch.Generator().manual_seed(6)).bfloat16()
    live = torch.ones(26, dtype=torch.bool)
    live[5] = False
    plain = moe._plain
    for fused in (False, True):
        lw = one_layer(w, fused)
        outs = []
        for path in (plain, moe._grouped):
            monkeypatch.setattr(moe, "_plain", path)
            outs.append(moe.expert_ffn(h, lw, 2, moe.Routing(live=live)))
        torch.testing.assert_close(outs[0], outs[1], atol=1e-3, rtol=2 ** -7)


# ------------------------------------------------- the model's functions


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_forward_on_the_dense_cache_matches_the_reference(fused):
    """A 37-token prefill in a 64-row bucket (padding routes nothing), then
    five decode steps, in float32 weights: every compared row's logits and
    every layer's routing against the reference's."""
    w = weights()
    model = port_model(w, fused)
    seq = prompt(42)
    cache = KVCache.create(ARGS, 1, 128, device=CPU)
    padded = torch.zeros((1, 64), dtype=torch.int32)
    padded[0, :37] = torch.tensor(seq[:37])
    rows = []
    with Recorded() as rec:
        chosen = ids_buffer(64)
        logits, _ = forward(model.params, ARGS, padded, 0, cache, logits_at=36,
                            routing=moe.Routing(chosen))
        rows.append(logits[0, 0])
        assert routed_pairs(chosen) == 37 * 2 * DIMS.n_layers
        assert (chosen[:, 37:] == DIMS.n_experts).all()
        for t in range(37, 42):
            logits, _ = forward(model.params, ARGS, torch.tensor([[seq[t]]], dtype=torch.int32),
                                t, cache)
            rows.append(logits[0, 0])
    ref = reference(w)
    want = ref.logits([seq], [36])[0]
    torch.testing.assert_close(torch.stack(rows), want, atol=2e-2, rtol=0)
    compared = 0
    for li in range(DIMS.n_layers):
        port = torch.cat([rec.calls[li][0][:37]]
                         + [rec.calls[DIMS.n_layers * (1 + s) + li][0] for s in range(5)])
        compared += assert_routed_alike(port, ref.record[li])
        assert (rec.calls[li][1][37:] == DIMS.n_experts).all()        # padding
    assert compared > 0.9 * 42 * DIMS.n_layers


def paged_case():
    bs = 8
    pool = paged.PagedKVPool.create(ARGS, 16, bs, device=CPU)
    return bs, pool


def test_the_paged_prefill_suffix_and_step_match_the_reference():
    """Request A (19 tokens) prefills into blocks [3, 7, 2]; B shares A's
    first two blocks and prefills its 7-token suffix into [5]; one step of
    both at positions 19 and 23 beside a free slot at position 0 of an
    all-trash table, its row masked out of routing: logits of the live rows
    against the reference, the step's ids of the live rows only."""
    w = weights()
    params = port_model(w).params
    bs, pool = paged_case()
    a = prompt(20, seed=7)
    b = a[:16] + prompt(8, seed=8)
    table_a = torch.tensor([3, 7, 2, 0], dtype=torch.int32)
    table_b = torch.tensor([3, 7, 5, 0], dtype=torch.int32)

    def padded(tokens, n):
        out = torch.zeros((1, n), dtype=torch.int32)
        out[0, :len(tokens)] = torch.tensor(tokens)
        return out

    got_a, _ = paged.paged_prefill(params, ARGS, padded(a[:19], 24), 18, pool, table_a)
    chosen = ids_buffer(8)
    got_b, _ = paged.paged_prefill_shared(params, ARGS, padded(b[16:23], 8), 16, 6, pool,
                                          table_b, routing=moe.Routing(chosen))
    assert routed_pairs(chosen) == 7 * 2 * DIMS.n_layers
    toks = torch.tensor([[a[19]], [b[23]], [0]], dtype=torch.int32)
    positions = torch.tensor([19, 23, 0], dtype=torch.int32)
    tables = torch.stack([table_a, table_b, torch.zeros(4, dtype=torch.int32)])
    chosen = ids_buffer(3)
    step, _ = paged.paged_decode_step(params, ARGS, toks, positions, pool, tables,
                                      routing=moe.Routing(chosen, positions > 0))
    assert routed_pairs(chosen) == 2 * 2 * DIMS.n_layers
    assert (chosen[:, 2] == DIMS.n_experts).all()
    want = reference(w).logits([a, b], [18, 22])
    torch.testing.assert_close(got_a[0], want[0][0], atol=2e-2, rtol=0)
    torch.testing.assert_close(got_b[0], want[1][0], atol=2e-2, rtol=0)
    torch.testing.assert_close(step[0], want[0][1], atol=2e-2, rtol=0)
    torch.testing.assert_close(step[1], want[1][1], atol=2e-2, rtol=0)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_a_verify_step_matches_the_reference(kind):
    """A verify of 4 rows a slot (the fed token and 3 drafts) at per-row
    positions, on the dense cache (``forward``) and on the pool
    (``paged_decode_step_spec``), beside a free slot masked out of
    routing: every live row's logits against the reference's."""
    w = weights()
    params = port_model(w).params
    seqs = [prompt(21, seed=9), prompt(17, seed=10)]
    lens = [17, 13]                       # prefilled; 4 rows verified from there
    if kind == "dense":
        cache = KVCache.create(ARGS, 3, 64, device=CPU)
        for j, (s, n) in enumerate(zip(seqs, lens)):
            view = KVCache(k=cache.k[:, j:j + 1], v=cache.v[:, j:j + 1])
            forward(params, ARGS, torch.tensor([s[:n]], dtype=torch.int32), 0, view)
    else:
        bs, pool = paged_case()
        tables = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 0], [0, 0, 0, 0]], dtype=torch.int32)
        for j, (s, n) in enumerate(zip(seqs, lens)):
            tok = torch.zeros((1, 24), dtype=torch.int32)
            tok[0, :n] = torch.tensor(s[:n])
            paged.paged_prefill(params, ARGS, tok, n - 1, pool, tables[j])
    toks = torch.tensor([s[n:n + 4] for s, n in zip(seqs, lens)] + [[0] * 4],
                        dtype=torch.int32)
    positions = torch.tensor(lens + [0], dtype=torch.int32)
    chosen = ids_buffer(12)
    live = (positions > 0)[:, None].expand(3, 4).reshape(-1)
    routing = moe.Routing(chosen, live)
    if kind == "dense":
        logits, _ = forward(params, ARGS, toks, positions, cache, routing=routing)
    else:
        logits, _ = paged.paged_decode_step_spec(params, ARGS, toks, positions, pool, tables,
                                                 routing=routing)
    assert routed_pairs(chosen) == 8 * 2 * DIMS.n_layers
    want = reference(w).logits([s[:n + 4] for s, n in zip(seqs, lens)],
                               [n for n in lens])
    for j in range(2):
        torch.testing.assert_close(logits[j], want[j], atol=2e-2, rtol=0)


# ------------------------------------------------------------ the streams


def engine(w, fused=False, seq_len=128):
    return engine_of(port_model(w, fused), seq_len)


def engine_of(model, seq_len=128):
    return InferenceEngine(model, InferenceArgs(sequence_length=seq_len), device=CPU)


REQUESTS = [(prompt(23, seed=11), 9), (prompt(40, seed=12), 14), (prompt(9, seed=13), 6),
            (prompt(31, seed=14), 11)]


def held_to_the_reference(w, streams, tau=0.0, limit=SERVED_GAP, follow=None):
    """Every served token's gap below the reference's best (each request's
    prompt and its served tokens, as ``portbench/correct.py`` compares),
    the reference following ``follow`` within ``tau``."""
    ref = mixtral.Reference(w, CFG, tau=tau, follow=follow)
    seqs = [p + toks[:-1] for (p, _), toks in zip(REQUESTS, streams)]
    rows = ref.logits(seqs, [len(p) - 1 for p, _ in REQUESTS])
    widest = max(float(gaps(r, t).max()) for r, t in zip(rows, streams))
    assert widest <= limit
    return ref


def run_batcher(batcher, requests=REQUESTS):
    reqs = []
    for i, (p, n) in enumerate(requests):
        reqs.append(batcher.submit(p, max_new_tokens=n))
        if i == 1:
            batcher.step()
    batcher.run_until_idle()
    return reqs, [[t for _, t in r.tokens(timeout=30)] for r in reqs]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_the_batchers_streams_hold_to_the_reference(kind):
    """Four requests, two joining after a step, through 3 slots (one waits),
    in float32 weights: every served token at the reference's best."""
    w = weights()
    eng = engine(w)
    b = (ContinuousBatcher(eng, n_slots=3) if kind == "dense"
         else PagedBatcher(eng, n_slots=3, block_size=8))
    _, streams = run_batcher(b)
    assert [len(s) for s in streams] == [n for _, n in REQUESTS]
    held_to_the_reference(w, streams)


def test_the_engine_on_the_fused_layout_holds_to_the_reference():
    w = weights()
    eng = engine(w, fused=True)
    assert "e_gate_up" in eng.model.params.layers
    streams = [[int(t) for _, t in eng.generate_tokens(p, max_new_tokens=n)]
               for p, n in REQUESTS]
    assert [len(s) for s in streams] == [n for _, n in REQUESTS]
    held_to_the_reference(w, streams)


def measured_tau(tmp_path, w_seed=SEED):
    """``tau`` as the rule sets it (``portbench/router_gap.py``), at this
    size on the CPU."""
    import contextlib
    import io

    from portbench import router_gap

    path = tmp_path / "tiny-mixtral.json"
    path.write_text(json.dumps({**CFG, "family": "mixtral"}))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert router_gap.main(["--config", str(path), "--device", "cpu", "--seed",
                                str(w_seed), "--seqs", "2", "--len", "48", "--steps",
                                "8"]) == 0
    return json.loads(out.getvalue())["tau"]


def test_bf16_weights_through_the_paged_batcher_hold_under_the_tie_rule(tmp_path):
    """The served precision: bf16 weights through the paged batcher, held to
    the reference under the routing tie rule at the ``tau`` measured here:
    the reference follows the experts the batcher logged for every served
    row, refuses none of them, and where they differ from its own the
    margin is within ``tau``."""
    tau = measured_tau(tmp_path)
    assert 0 < tau < 1
    w = weights(torch.bfloat16)
    model = port_model(w)
    model.routing_log = moe.RoutingLog()
    _, streams = run_batcher(PagedBatcher(engine_of(model), n_slots=3, block_size=8))
    ref = held_to_the_reference(w, streams, tau=tau, follow=model.routing_log)
    rows = sum(len(p) + n - 1 for p, n in REQUESTS)
    assert ref.stats["recorded"] == rows * DIMS.n_layers
    assert ref.stats["refused"] == 0 and ref.stats["widest_margin"] <= tau


def own_routing(w, seq):
    """The reference's own experts ``[rows, L, 2]`` over ``seq``."""
    ref = reference(w)
    ref.logits([seq], [len(seq) - 1])
    return torch.stack([torch.topk(r, 2).indices for r in ref.record], dim=1)


class Log:
    """A routing log of one request, as ``ops/moe.py::RoutingLog`` reads."""

    def __init__(self, seq, ids):
        self.seq, self.ids = list(seq), ids.numpy()

    def rows(self, prompt, n):
        return self.ids[:n] if self.seq[:len(prompt)] == list(prompt) else None


def test_the_tie_rule_follows_the_program_only_within_tau():
    """The reference follows a program that routed as it does (nothing
    otherwise), takes a program's swap of its 2nd and 3rd expert where its
    margin is under ``tau`` (and then computes another row), and refuses
    choices further off (the bottom two, an expert twice), keeping its own:
    logits equal to those without a log."""
    w = weights()
    seq = prompt(30, seed=15)
    own = own_routing(w, seq)
    plain = reference(w).logits([seq], [24])[0]
    ref = mixtral.Reference(w, CFG, tau=0.5, follow=Log(seq, own))
    assert torch.equal(ref.logits([seq], [24])[0], plain)
    assert ref.stats == {"recorded": 30 * DIMS.n_layers, "otherwise": 0,
                         "widest_margin": 0.0, "refused": 0}
    # the nearest 2nd / 3rd tie of the last layer, at a row whose logits compare
    rec = reference(w)
    rec.logits([seq], [24])
    top = torch.topk(rec.record[-1], 3)
    margins = top.values[:, 1] - top.values[:, 2]
    t = 24 + int(torch.argmin(margins[24:]))
    swapped = own.clone()
    swapped[t, -1, 1] = top.indices[t, 2]
    ref = mixtral.Reference(w, CFG, tau=float(margins[t]) + 1e-4, follow=Log(seq, swapped))
    got = ref.logits([seq], [24])[0]
    assert ref.stats["otherwise"] == 1 and ref.stats["refused"] == 0
    assert ref.stats["widest_margin"] == pytest.approx(float(margins[t]))
    assert not torch.equal(got[t - 24], plain[t - 24])
    assert torch.equal(got[:t - 24], plain[:t - 24])
    # the same swap under a tau below its margin, the bottom two, one expert twice
    ref = mixtral.Reference(w, CFG, tau=float(margins[t]) / 2, follow=Log(seq, swapped))
    assert torch.equal(ref.logits([seq], [24])[0], plain) and ref.stats["refused"] == 1
    bottom = torch.stack([torch.topk(r, 2, largest=False).indices for r in rec.record], dim=1)
    ref = mixtral.Reference(w, CFG, tau=0.1, follow=Log(seq, bottom))
    assert torch.equal(ref.logits([seq], [24])[0], plain)
    assert ref.stats["refused"] == 30 * DIMS.n_layers
    twice = own.clone()
    twice[:, :, 1] = twice[:, :, 0]
    ref = mixtral.Reference(w, CFG, tau=50.0, follow=Log(seq, twice))
    assert torch.equal(ref.logits([seq], [24])[0], plain)
    assert ref.stats["refused"] == 30 * DIMS.n_layers


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_the_batchers_log_each_served_rows_experts(kind):
    """A batcher whose model carries a routing log records every served row
    of every request, prompt rows from the admission's prefill and each
    fed token's row from its step, at its position: in float32 weights the
    logged experts are the reference's own wherever its margin is clear of
    the bf16 caches. On the pool a prefix-cache hit's shared rows stay
    unrecorded."""
    w = weights()
    model = port_model(w)
    model.routing_log = log = moe.RoutingLog()
    eng = engine_of(model)
    b = (ContinuousBatcher(eng, n_slots=3) if kind == "dense"
         else PagedBatcher(eng, n_slots=3, block_size=8))
    requests = list(REQUESTS)
    if kind == "paged":
        requests.append((REQUESTS[1][0][:16] + prompt(5, seed=18), 4))
    _, streams = run_batcher(b, requests)
    seqs = [p + toks[:-1] for (p, _), toks in zip(requests, streams)]
    ref = reference(w)
    ref.logits(seqs, [len(p) - 1 for p, _ in requests])
    start = 0
    for (p, _), seq in zip(requests, seqs):
        rows = torch.from_numpy(log.rows(p, len(seq)))
        recorded = (rows >= 0).all(-1).all(-1)
        cached = 16 if p is requests[-1][0] and kind == "paged" else 0
        assert not recorded[:cached].any() and recorded[cached:].all()
        for li in range(DIMS.n_layers):
            r = ref.record[li][start:start + len(seq)][cached:]
            top = torch.topk(r, 3)
            clear = (top.values[:, 1] - top.values[:, 2]) > CACHE_MARGIN
            mine = torch.sort(rows[cached:, li], dim=-1).values
            assert torch.equal(mine[clear], torch.sort(top.indices[:, :2], dim=-1).values[clear])
        start += len(seq)
    assert log.rows(prompt(7, seed=19), 7) is None


# ------------------------------------------------------- spans, counters


def hand_counts(calls):
    """(routed rows, experts hit) summed over the layers of the recorded
    routing calls."""
    rows = hit = 0
    for _, ids in calls:
        live = ids[ids < DIMS.n_experts]
        rows += live.numel()
        hit += int(torch.unique(live).numel())
    return rows, hit


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_the_batchers_count_routed_rows_and_experts_hit(kind):
    """``expert_rows`` and ``experts_hit`` of every ``batcher.step`` and
    ``batcher.admit`` span, and the batcher's counters, against the routing
    recorded in every forward: each step's routed rows are its live rows x
    2 x the layers."""
    w = weights(torch.bfloat16)
    eng = engine(w)
    b = (ContinuousBatcher(eng, n_slots=3) if kind == "dense"
         else PagedBatcher(eng, n_slots=3, block_size=8))
    t0 = time.perf_counter_ns()
    with Recorded() as rec:
        run_batcher(b)
        # the quanta still in flight when the last request ended are read back
        # (and their routing counted) at the batcher's next step
        b.step()
    spans = SPANS.between(t0, time.perf_counter_ns() + 1)
    steps = [sp[5] for sp in spans if sp[0] == "batcher.step" and sp[5]]
    admits = [sp[5] for sp in spans if sp[0] == "batcher.admit" and sp[5]]
    rows, hit = hand_counts(rec.calls)
    assert (b.expert_rows, b.experts_hit) == (rows, hit) and rows > 0
    for name, total in (("expert_rows", rows), ("experts_hit", hit)):
        assert sum(c.get(name, 0) for c in steps + admits) == total
    assert all(c["expert_rows"] == c["rows"] * 2 * DIMS.n_layers
               for c in steps if c.get("steps"))
    assert sum(c["expert_rows"] for c in admits) == 2 * DIMS.n_layers * sum(
        len(p) for p, _ in REQUESTS)
    assert all(c["experts_hit"] <= DIMS.n_layers * DIMS.n_experts for c in steps if c.get("steps"))


def test_a_dense_batcher_counts_no_experts():
    from tests.test_torch_continuous import random_engine

    b = PagedBatcher(random_engine(), n_slots=2)
    r = b.submit([5, 6, 7], max_new_tokens=4)
    b.run_until_idle()
    assert len(list(r.tokens(timeout=30))) == 4
    assert b.expert_rows == b.experts_hit == 0 and b._step_graph.slot.ids is None
    assert b._routing_log is None


# --------------------------------------------------- refusals, the config


def test_meshes_and_quantized_weights_refuse_a_model_with_experts():
    from llama_nuts_and_bolts_tpu_torch.parallel.sharding import check_tp_shape
    from llama_nuts_and_bolts_tpu_torch.quant import quantize_params
    from llama_nuts_and_bolts_tpu_torch.quant.int4 import (
        init_random_params_q4,
        quantize_params_q4,
    )
    from llama_nuts_and_bolts_tpu_torch.quant.quantize import init_random_params_q8

    params = port_model(weights(torch.bfloat16)).params
    for call, what in ((lambda: check_tp_shape(ARGS, 1), "mesh"),
                       (lambda: check_tp_shape(ARGS, 2), "mesh"),
                       (lambda: quantize_params(params), "int8"),
                       (lambda: init_random_params_q8(ARGS, device="cpu"), "int8"),
                       (lambda: quantize_params_q4(params), "int4"),
                       (lambda: init_random_params_q4(ARGS, device="cpu"), "int4")):
        with pytest.raises(ValueError, match=f"{what}.*experts"):
            call()
    check_tp_shape(ARGS.with_(n_experts=0), 2)


def test_the_loader_refuses_a_checkpoint_with_experts():
    from llama_nuts_and_bolts_tpu_torch.models.llama.loader import (
        build_params_from_checkpoint,
    )

    with pytest.raises(ValueError, match="experts"):
        build_params_from_checkpoint({}, ARGS, device="cpu")


def test_params_json_reads_mistrals_moe_block(tmp_path):
    path = tmp_path / "params.json"
    path.write_text(json.dumps({"dim": 4096, "n_layers": 32, "n_heads": 32,
                                "n_kv_heads": 8, "vocab_size": 32000, "rope_theta": 1e6,
                                "moe": {"num_experts": 8, "num_experts_per_tok": 2}}))
    cfg = load_model_args(str(path))
    assert (cfg.n_experts, cfg.n_experts_per_tok) == (8, 2)
    path.write_text(json.dumps({"dim": 64, "n_layers": 2, "n_heads": 2, "n_experts": 4,
                                "n_experts_per_tok": 1}))
    assert load_model_args(str(path)).n_experts == 4
    path.write_text(json.dumps({"dim": 64, "n_layers": 2, "n_heads": 2}))
    assert load_model_args(str(path)).n_experts == 0


def test_the_configuration_is_mixtrals_and_the_family_takes_it():
    """``portbench/configs/mixtral-8x7b-v0.1.json`` read by the port's loader:
    Mixtral's widths (14336 a expert), 8 experts, 2 a token, 16 of 32
    layers; the family's program builds the port's model over it."""
    path = ROOT / "portbench" / "configs" / "mixtral-8x7b-v0.1.json"
    cfg = load_model_args(str(path), max_sequence_length=2048)
    raw = json.loads(path.read_text())
    assert cfg.ffn_hidden_dim == raw["published"]["intermediate_size"] == 14336
    assert (cfg.n_experts, cfg.n_experts_per_tok, cfg.n_layers) == (8, 2, 16)
    assert cfg.head_dim == 128 and cfg.n_heads // cfg.kv_heads == 4
    assert set(raw["reduced"]) == {"n_layers", "max_sequence_length"}
    d = mixtral.dims(raw)
    assert d.n_layers * (d.attn_params + d.n_experts * d.expert_params) * 2 / 1e9 \
        == pytest.approx(46.4, abs=0.1)


# ------------------------------------------------ a dense model unchanged

# sha256 (first 16 hex digits) of a dense tiny model's bytes, one CPU
# thread, read on the commit before the expert layer: forward's prefill and
# decode logits and cache, the paged prefill's and step's logits and pool
PINNED_DENSE = "de656976db0eb7b3"


def dense_bytes_digest():
    cfg = ModelArgs(dim=256, n_layers=2, n_heads=8, n_kv_heads=2, vocab_size=512,
                    multiple_of=64, max_sequence_length=128)
    h = hashlib.sha256()
    for fused in (False, True):
        params = init_random_params(cfg, seed=3, device="cpu", fused=fused)
        cache = KVCache.create(cfg, 1, 64, device="cpu")
        tok = torch.tensor([prompt(20, seed=16)], dtype=torch.int32)
        a, _ = forward(params, cfg, tok, 0, cache)
        b, _ = forward(params, cfg, tok[:, :1], 20, cache)
        for t in (a, b, cache.k, cache.v):
            h.update(t.float().numpy().tobytes())
    params = init_random_params(cfg, seed=3, device="cpu")
    pool = paged.PagedKVPool.create(cfg, 8, 8, device="cpu")
    table = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    tok = torch.tensor([prompt(24, seed=17)], dtype=torch.int32)
    a, _ = paged.paged_prefill(params, cfg, tok, 19, pool, table)
    b, _ = paged.paged_decode_step(params, cfg, tok[:, :1], torch.tensor([20], dtype=torch.int32),
                                   pool, table[None])
    for t in (a, b, pool.k, pool.v):
        h.update(t.float().numpy().tobytes())
    return h.hexdigest()[:16]


def test_a_dense_model_is_bit_equal_to_the_commit_before_the_expert_layer():
    assert dense_bytes_digest() == PINNED_DENSE
