"""The whole run but the look for a card, on the CPU at a tiny size: the
harness finds a configuration, a mix and a metric that are new files, each
entry runs through its window and reports its metrics, and ``correct``
holds on sound runs."""

import json

import pytest

from portbench.bench import Bench
from portbench.tests.conftest import run
from portbench.tests.test_portbench_spans import CPU_READ, SPAN_METRICS


def test_a_new_config_mix_entry_and_metric_are_found_by_name(tiny_root):
    bench = tiny_root / "portbench"
    (bench / "metrics" / "tokens_seen.chat.py").write_text(
        "def read(rec):\n    return sum(len(s.tokens) for s in rec.served) or None\n")
    (bench / "entries" / "counting_engine.py").write_text(
        "from pathlib import Path\n\n"
        "from portbench.entries.engine import EngineEntry\n\n\n"
        "class CountingEngine(EngineEntry):\n"
        "    def run(self, *args):\n"
        "        Path(__file__).with_suffix('.ran').write_text('ran')\n"
        "        return super().run(*args)\n\n\n"
        "ENTRY = CountingEngine\n")
    mix = json.loads((bench / "mixes" / "tiny-chat.json").read_text())
    (bench / "mixes" / "tiny-counted.json").write_text(json.dumps({**mix,
                                                                  "entry": "counting_engine"}))
    (bench / "limits" / "tiny.counted.json").write_text(
        (bench / "limits" / "tiny.chat.json").read_text())
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "tokens_seen.chat", "unit": "tokens", "better": "higher",
                              "source": "host_clock", "layer": "tests",
                              "moves": "output_tok_s", "workloads": ["tiny.chat"]})
    spec["workloads"].append({"name": "tiny.counted", "config": "tiny",
                              "traffic": "tiny-counted", "chips": 1, "why": "tests"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    b = Bench(tiny_root)
    assert {"tiny.chat", "tiny.serve", "tiny.shared"} <= set(b.cell_names)
    cell = b.cell("tiny.chat")
    assert cell.config["dim"] == 512 and cell.mix["entry"] == "engine"
    assert "tokens_seen.chat" in [m.name for m in cell.per_layer]
    r = run(tiny_root, "tiny.chat", trace=True)
    assert r["metrics"]["tokens_seen.chat"]["value"] > 0
    entry = b.entry("counting_engine")
    r = run(tiny_root, "tiny.counted")
    assert entry.__name__ == "CountingEngine" and r["correct"] is True
    assert (bench / "entries" / "counting_engine.ran").exists()
    assert r["attempted"] > 0 and set(r["metrics"]) == {"output_tok_s", "itl_p95_ms",
                                                         "setup_s"}


def test_a_per_layer_metric_must_list_its_cells(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    del spec["per_layer"][0]["workloads"]
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="lists no workloads"):
        Bench(tiny_root).cell("tiny.chat")


@pytest.mark.parametrize("cell, e2e", [
    ("tiny.chat", {"output_tok_s", "itl_p95_ms", "ttft_p50_ms", "setup_s"}),
    ("tiny.serve", {"output_tok_s", "itl_p95_ms", "ttft_p95_ms", "setup_s"}),
    ("tiny.shared", {"output_tok_s", "itl_p95_ms", "ttft_p95_ms", "setup_s"}),
])
def test_a_sound_run_reports_its_metrics_and_is_correct(tiny_root, cell, e2e):
    r = run(tiny_root, cell)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == e2e
    assert r["attempted"] > 0 and r["failed"] == 0
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert r["checks"]["tokens_compared"]["value"] >= r["checks"]["tokens_compared"]["limit"]
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.serve"])
def test_a_traced_run_reports_what_the_cpu_can_read(tiny_root, cell):
    # the rooflines need the card's kernels and graph_step_share the card's
    # step graph: on the CPU their readers find nothing and the line leaves
    # them out; every other reader, the program's spans' too, reads
    r = run(tiny_root, cell, trace=True)
    assert r["correct"] is True
    assert set(r["metrics"]) == CPU_READ[cell] | SPAN_METRICS[cell]
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_the_shared_mix_hits_the_prefix_cache(tiny_root):
    r = run(tiny_root, "tiny.shared", trace=True)
    assert r["metrics"]["prefix_hit_share.serve"]["value"] > 50
    r = run(tiny_root, "tiny.serve", trace=True)
    assert r["metrics"]["prefix_hit_share.serve"]["value"] == 0
