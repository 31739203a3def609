"""``free_key_share.serve``, the free slots' share of the keys the batcher's
decode attention is handed, read from ``batcher.step`` spans planted in a
window: the steps' ``free_keys`` over their ``keys``; nothing where the steps
count no keys (a program before the count), on a machine without a card, or
for another entry."""

import importlib.util
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch


def reader():
    spec = importlib.util.spec_from_file_location(
        "free_key_share", Path(__file__).parents[1] / "metrics" / "free_key_share.serve.py")
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
    SPANS.add("batcher.step", t + 10**9, t + 10**9 + 1, rows=1, steps=1, graphed=1,
              keys=40, free_keys=40)
    return SimpleNamespace(entry="paged_batcher",
                           window=(t / 1e9, (t + len(steps) * 1000 + 1000) / 1e9))


def test_the_free_slots_share_of_the_keys_in_the_window(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    read = reader().read
    rec = window([{"rows": 2, "steps": 1, "graphed": 1, "keys": 1200, "free_keys": 30}, {},
                  {"stalled": 1},
                  {"rows": 0, "steps": 0, "graphed": 0, "keys": 800, "free_keys": 10}])
    assert read(rec) == pytest.approx(2.0)
    rec = window([{"rows": 1, "steps": 1, "graphed": 1, "keys": 4, "free_keys": 3}])
    assert read(rec) == pytest.approx(75.0)
    assert read(SimpleNamespace(entry="engine", window=rec.window)) is None
    assert read(window([{}])) is None                 # no decode step in the window


def test_nothing_without_the_counts_or_without_a_card(monkeypatch):
    read = reader().read
    rec = window([{"rows": 3, "steps": 2, "graphed": 2, "keys": 90, "free_keys": 2}])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert read(rec) is None                          # the pool's gather path
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert read(window([{"rows": 3, "steps": 2, "graphed": 2}])) is None   # the parent's


def test_nothing_without_spans(monkeypatch):
    from llama_nuts_and_bolts_tpu_torch.runtime import profiling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    rec = window([{"rows": 3, "steps": 2, "graphed": 2, "keys": 90, "free_keys": 2}])
    monkeypatch.delattr(profiling, "SPANS")
    assert reader().read(rec) is None
