"""The Mixtral family on the CPU at a tiny size: a cell ``tiny.moe`` of a
tiny Mixtral configuration (the tests' tiny widths with 8 experts, top-2)
under the tiny serve mix, through the whole harness.

  * a sound run is ``correct`` under the routing tie rule, and each fault
    planted in the port's expert layer makes a whole run not correct: the
    top 2 taken from the bottom, no renormalisation, the second expert
    dropped, every row sent to expert 0; so does the float8 control;
  * the family refuses a port without an expert layer, at once;
  * the four readers return numbers where their cell finds something to
    read, and nothing where they say so (no card, another entry, a model
    without experts, no counts).
"""

import json
import time
from types import SimpleNamespace

import pytest
import torch

import llama_nuts_and_bolts_tpu_torch.ops.moe as moe
from portbench.bench import Bench
from portbench.cell import run_cell
from portbench.tests.conftest import TINY_CONFIG

CPU = torch.device("cpu")
SEED = 2**31 + 23
MOE_CONFIG = {**TINY_CONFIG, "family": "mixtral", "n_experts": 8, "n_experts_per_tok": 2}
READERS = ("expert_hit_share.moe", "step_roofline.moe", "step_mfu.moe", "prefill_mfu.moe")
# read on the CPU at this size under the tie rule (TAU): the program's widest
# gap 0 to 0.0144 over seeds 2^31 + 20..25, the float8 control's 0.784 and
# 1.003 over 2^31 + 20, 21, the planted faults' 1.56 to 3.40
MOE_LIMITS = {"logit_gap": {"limit": 0.1}, "tokens_compared": {"limit": 48}}


@pytest.fixture
def moe_root(tiny_root):
    bench = tiny_root / "portbench"
    (bench / "configs" / "tiny-moe.json").write_text(json.dumps(MOE_CONFIG))
    (bench / "limits" / "tiny.moe.json").write_text(json.dumps(MOE_LIMITS))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-moe", "source": "a test size",
                            "file": "portbench/configs/tiny-moe.json", "reduced": [],
                            "why": "tests"})
    spec["workloads"].append({"name": "tiny.moe", "config": "tiny-moe",
                              "traffic": "tiny-serve", "chips": 1, "why": "tests"})
    # the metrics the Mixtral cell reports, as BENCHMARK.json lists them
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "mixtral-8x7b.serve-chat" in m.get("workloads", []):
            m["workloads"].append("tiny.moe")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_root


def run(root, trace=False, control=False, seed=SEED):
    return run_cell(Bench(root), "tiny.moe", seed, 1.0, trace, CPU, time.perf_counter(),
                    control=control)


def top_from_the_bottom(mp):
    def route(h, router, k, live=None):
        probs = torch.softmax(moe.linear(h, router, out_dtype=torch.float32), dim=-1)
        top, ids = torch.topk(probs, k, dim=-1, largest=False)
        if live is not None:
            ids = torch.where(live[:, None], ids, router.shape[0])
        return ids, top / top.sum(dim=-1, keepdim=True)

    mp.setattr(moe, "route", route)


def changed_route(change):
    def plant(mp):
        route = moe.route

        def changed(h, router, k, live=None):
            ids, weights = route(h, router, k, live)
            return change(ids, weights, h, router)

        mp.setattr(moe, "route", changed)

    return plant


def not_renormalised(ids, weights, h, router):
    probs = torch.softmax(moe.linear(h, router, out_dtype=torch.float32), dim=-1)
    return ids, probs.gather(1, ids.clamp(max=router.shape[0] - 1))


def second_dropped(ids, weights, h, router):
    return ids, torch.stack([weights[:, 0], torch.zeros_like(weights[:, 1])], dim=1)


def all_to_expert_0(ids, weights, h, router):
    return torch.where(ids < router.shape[0], 0, ids), weights


FAULTS = {"bottom": top_from_the_bottom, "unnormalised": changed_route(not_renormalised),
          "second_dropped": changed_route(second_dropped),
          "expert_0": changed_route(all_to_expert_0)}


def test_a_sound_run_is_correct_under_the_tie_rule(moe_root):
    r = run(moe_root)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) >= {"output_tok_s", "ttft_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_in_the_expert_layer_is_not_correct(moe_root, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    r = run(moe_root)
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["logit_gap"]["value"] > r["checks"]["logit_gap"]["limit"]


def test_the_control_is_not_correct(moe_root):
    r = run(moe_root, control=True)
    limit = r["checks"]["logit_gap"]["limit"]
    assert r["correct"] is False, r["checks"]
    assert r["program_gap"] <= limit < r["checks"]["logit_gap"]["value"]


def test_the_family_refuses_a_port_without_experts(moe_root, monkeypatch):
    import llama_nuts_and_bolts_tpu_torch.io.params as params

    @__import__("dataclasses").dataclass(frozen=True)
    class Dense:
        dim: int = 4096

    monkeypatch.setattr(params, "ModelArgs", Dense)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="no expert layer"):
        run(moe_root)
    assert time.perf_counter() - t0 < 5


def test_a_traced_run_reads_the_counter_and_leaves_the_card_shares_out(moe_root):
    """On the CPU the expert hit share reads the program's counts; the three
    shares of the card's peaks read nothing."""
    r = run(moe_root, trace=True)
    share = r["metrics"]["expert_hit_share.moe"]["value"]
    assert 0 < share <= 100
    assert not set(r["metrics"]) & {"step_roofline.moe", "step_mfu.moe", "prefill_mfu.moe"}


def reader(root, name):
    return Bench(root).reader(name)


def planted_window(d, steps, admits):
    """A window ahead of every span recorded so far holding ``steps`` (the
    counts of ``batcher.step`` spans) and ``admits`` (of seated
    ``batcher.admit`` spans, each with a 20 ms ``request.first_token``), and
    the benchmark's spans around ``step()``, 10 ms each."""
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS

    t = time.perf_counter_ns() + 10**12
    rid = t % 10**9
    spans = []
    for i, counts in enumerate(steps):
        t0 = t + i * 10**7
        SPANS.add("batcher.step", t0, t0 + 10**7, **counts)
        spans.append(SimpleNamespace(t0=t0 / 1e9, t1=(t0 + 10**7) / 1e9))
    for i, counts in enumerate(admits):
        t0 = t + i * 10**7 + 1000
        SPANS.add("batcher.admit", t0, t0 + 500, id=rid + i, **counts)
        SPANS.add("request.first_token", t0, t0 + 2 * 10**7, id=rid + i)
    end = t + len(steps) * 10**7 + 10**6
    return SimpleNamespace(entry="paged_batcher", dims=d, window=(t / 1e9, end / 1e9),
                           spans_in=lambda lo, hi: [s for s in spans
                                                    if s.t0 >= lo and s.t1 <= hi])


def test_the_readers_by_hand(moe_root, monkeypatch):
    """The four readers on planted spans, with a card pretended: each a hand
    count of the family's work over the planted walls."""
    from portbench.families.mixtral import MixtralDims
    from portbench.yardstick import BF16, BF16_FLOPS_PER_S, HBM_BYTES_PER_S

    d = MixtralDims(dim=8, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=4, ffn=16, vocab=10,
                    n_experts=4, top_k=2)
    steps = [dict(rows=3, steps=1, graphed=1, keys=40, free_keys=1, experts_hit=5,
                  expert_rows=12),
             dict(rows=2, steps=1, graphed=1, keys=30, free_keys=2, experts_hit=4,
                  expert_rows=8)]
    admits = [dict(prompt=6, cached=0, computed=6, padded=2, flash=1, experts_hit=6,
                   expert_rows=24)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    rec = planted_window(d, steps, admits)
    get = {name: reader(moe_root, name)(rec) for name in READERS}
    assert get["expert_hit_share.moe"] == pytest.approx(100 * 9 / (2 * 2 * 4))
    # attention 2*8*8 + 2*4*8 = 192, router 32, norms 16 a layer; head 80, norm 8
    dense = BF16 * (2 * (192 + 32 + 16) + 80 + 8)
    assert d.dense_bytes == dense
    expert = BF16 * 3 * 16 * 8
    kv = BF16 * 2 * 4 * 2
    least = ((dense + 5 * expert + 39 * kv) + (dense + 4 * expert + 28 * kv)) / HBM_BYTES_PER_S
    flops_admit = (2 * 2 * (192 + 32) * 6 + 4 * 2 * 4 * 2 * 21 + 2 * 384 * 24 + 2 * 8 * 10)
    least += max((dense + 6 * expert) / HBM_BYTES_PER_S, flops_admit / BF16_FLOPS_PER_S)
    assert get["step_roofline.moe"] == pytest.approx(100 * least / 0.02)
    flops_steps = sum(2 * 2 * (192 + 32) * c["rows"] + 4 * 2 * 4 * 2 * (c["keys"] - c["free_keys"])
                      + 2 * 384 * c["expert_rows"] + 2 * 8 * 10 * c["rows"] for c in steps)
    assert get["step_mfu.moe"] == pytest.approx(
        100 * (flops_steps + flops_admit) / (0.02 * BF16_FLOPS_PER_S))
    assert get["prefill_mfu.moe"] == pytest.approx(
        100 * flops_admit / (0.02 * BF16_FLOPS_PER_S))


def test_the_readers_read_nothing_where_they_say(moe_root, monkeypatch):
    from portbench.families.mixtral import MixtralDims
    from portbench.yardstick import Dims

    moe_dims = MixtralDims(dim=8, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=4, ffn=16,
                           vocab=10, n_experts=4, top_k=2)
    steps = [dict(rows=3, steps=1, graphed=1, keys=40, free_keys=1)]
    admits = [dict(prompt=6, cached=0, computed=6, padded=2, flash=1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    no_counts = planted_window(moe_dims, steps, admits)
    dense = planted_window(Dims(dim=8, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=4,
                                ffn=16, vocab=10), steps, admits)
    engine = SimpleNamespace(**{**vars(no_counts), "entry": "engine"})
    for name in READERS:
        read = reader(moe_root, name)
        assert read(no_counts) is None and read(dense) is None and read(engine) is None, name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    counted = planted_window(moe_dims, [dict(steps[0], experts_hit=3, expert_rows=6)],
                             [dict(admits[0], experts_hit=4, expert_rows=12)])
    for name in READERS[1:]:
        assert reader(moe_root, name)(counted) is None, name
    assert reader(moe_root, READERS[0])(counted) == pytest.approx(100 * 3 / 8)
