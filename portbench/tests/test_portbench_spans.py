"""The per-layer metrics that read the program's own spans
(``runtime/profiling.py``'s ``SPANS``), on the CPU at a tiny size: each
returns a number in a traced run of its cell; a request's queue wait and
first-token lag add up to the benchmark's TTFT once the client's lateness
is taken off; against a program without spans each returns nothing and
raises nothing."""

from pathlib import Path

import pytest

from portbench.bench import Bench
from portbench.tests.conftest import run

SEED = 2**31 + 11
SECONDS = 5.0            # whole requests in the window on a loaded CPU too
SPAN_METRICS = {
    "tiny.serve": {"queue_wait_ms.serve", "first_token_lag_ms.serve", "step_launch_ms.serve",
                   "step_readback_ms.serve", "batch_rows.serve", "prefill_pad_share.serve",
                   "idle_in_launch_share.serve"},
    # graph_capture_s.chat reads the card's captures: the CPU captures none
    "tiny.chat": {"decode_wait_ms.chat", "prefill_pad_share.chat"},
}
CPU_READ = {
    "tiny.serve": {"step_ms.serve", "prefix_hit_share.serve", "step_mfu.serve",
                   "step_idle_share.serve"},
    "tiny.chat": {"decode_ms.chat", "step_mfu.chat", "prefill_mfu.chat", "idle_share.chat"},
}


def records(monkeypatch):
    """The records the readers are handed, as a run hands them."""
    seen = []
    reader = Bench.reader

    def keeping(self, metric):
        read = reader(self, metric)

        def kept(rec):
            seen.append(rec)
            return read(rec)

        return kept

    monkeypatch.setattr(Bench, "reader", keeping)
    return seen


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.chat"])
def test_each_span_metric_reads_a_number_in_a_traced_run(tiny_root, cell):
    r = run(tiny_root, cell, trace=True, seed=SEED, seconds=SECONDS)
    assert r["correct"] is True
    assert set(r["metrics"]) == CPU_READ[cell] | SPAN_METRICS[cell]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    if cell == "tiny.serve":
        assert 0 <= m["prefill_pad_share.serve"] < 100
        assert 0 < m["batch_rows.serve"] <= 4                     # the mix's slots
        assert m["step_launch_ms.serve"] + m["step_readback_ms.serve"] <= m["step_ms.serve"]
        assert 0 <= m["idle_in_launch_share.serve"] <= 100
    else:
        assert m["decode_wait_ms.chat"] <= m["decode_ms.chat"]
        assert 0 <= m["prefill_pad_share.chat"] < 100


def test_graph_capture_s_sums_the_captures_up_to_the_windows_end():
    """The card's captures, as the decode graphs record them: those before
    the window's end count, a later one does not; none, nothing."""
    import importlib.util
    import time
    from types import SimpleNamespace

    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS

    spec = importlib.util.spec_from_file_location(
        "graph_capture", Path(__file__).parents[1] / "metrics" / "graph_capture_s.chat.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    now = time.perf_counter_ns()
    rec = SimpleNamespace(entry="engine", window=((now + 10**9) / 1e9, (now + 2 * 10**9) / 1e9))
    before = reader.read(rec) or 0.0
    SPANS.add("engine.graph_capture", now + 10**9, now + 10**9 + 250_000_000, bytes=1)
    SPANS.add("engine.graph_capture", now + 3 * 10**9, now + 4 * 10**9, bytes=1)
    assert reader.read(rec) == pytest.approx(before + 0.25)
    assert reader.read(SimpleNamespace(entry="paged_batcher", window=rec.window)) is None


def test_queue_wait_and_first_token_lag_make_the_ttft(tiny_root, monkeypatch):
    """Per request due in the window: ``request.queued`` plus
    ``request.first_token`` is the benchmark's TTFT (due to the first
    token's stamp) less the client's lateness (due to submit), within
    2 ms."""
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS

    seen = records(monkeypatch)
    run(tiny_root, "tiny.serve", trace=True, seed=SEED + 1, seconds=SECONDS)
    rec = seen[0]
    w0, w1 = rec.window
    spans = SPANS.between(int((w0 - 1) * 1e9), int((w1 + 60) * 1e9))
    queued = {s[3]: s for s in spans if s[0] == "request.queued"}
    first = {s[3]: s for s in spans if s[0] == "request.first_token"}
    due = [s for s in rec.served if w0 <= s.start < w1 and s.first is not None]
    assert due
    for s in due:
        # the request's first token: the span that ended at its stamp
        rid = min(first, key=lambda i: abs(first[i][2] / 1e9 - s.first))
        q, f = queued[rid], first[rid]
        late = q[1] / 1e9 - s.start
        assert late >= 0
        parts = (q[2] - q[1] + f[2] - f[1]) / 1e9
        assert abs((s.first - s.start) - late - parts) < 2e-3


def test_without_spans_the_readers_read_nothing(tiny_root, monkeypatch):
    """A program without the recorder (the parent of the change that added
    it): the new readers return nothing and the run reports the rest."""
    from llama_nuts_and_bolts_tpu_torch.runtime import profiling

    monkeypatch.delattr(profiling, "SPANS")
    for cell in ("tiny.serve", "tiny.chat"):
        r = run(tiny_root, cell, trace=True, seed=SEED + 2, seconds=SECONDS)
        assert set(r["metrics"]) == CPU_READ[cell]

