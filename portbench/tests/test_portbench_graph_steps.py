"""``graph_step_share.serve``, the share of the batcher's plain decode steps
replayed from its captured step graph, read from ``batcher.step`` spans
planted in a window: the steps' ``graphed`` over their ``steps``; nothing
where the steps count no ``graphed`` (a program without a step graph), on a
machine without a card, or for another entry."""

import importlib.util
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch


def reader():
    spec = importlib.util.spec_from_file_location(
        "graph_step_share",
        Path(__file__).parents[1] / "metrics" / "graph_step_share.serve.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def window(steps):
    """A window ahead of every span recorded so far, holding one
    ``batcher.step`` span for each entry of ``steps`` (its counts), and one
    after the window that must not count."""
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS

    t = time.perf_counter_ns() + 10**12
    for i, counts in enumerate(steps):
        SPANS.add("batcher.step", t + i * 1000, t + i * 1000 + 500, **counts)
    SPANS.add("batcher.step", t + 10**9, t + 10**9 + 1, rows=4, steps=1, graphed=0)
    return SimpleNamespace(entry="paged_batcher",
                           window=(t / 1e9, (t + len(steps) * 1000 + 1000) / 1e9))


def test_the_share_of_graphed_steps_in_the_window(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    read = reader().read
    rec = window([{"rows": 3, "steps": 2, "graphed": 2}, {},
                  {"rows": 1, "steps": 1, "graphed": 1}, {"stalled": 1}])
    assert read(rec) == pytest.approx(100.0)
    rec = window([{"rows": 3, "steps": 2, "graphed": 2}, {"rows": 2, "steps": 2, "graphed": 0}])
    assert read(rec) == pytest.approx(50.0)
    assert read(SimpleNamespace(entry="engine", window=rec.window)) is None
    assert read(window([{}])) is None                 # no decode step in the window


def test_nothing_without_the_counter_or_without_a_card(monkeypatch):
    read = reader().read
    rec = window([{"rows": 3, "steps": 2, "graphed": 2}])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert read(rec) is None                          # the body runs eagerly
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert read(window([{"rows": 3, "steps": 2}])) is None      # the parent's counts
