"""``prefill_mfu.serve`` and ``prefill_flash_share.serve``, read from
``batcher.admit`` and ``request.first_token`` spans planted in a window:
the seated admissions' model FLOPs over their first-token walls against
the card's bf16 peak, worked out here by hand; the share of seated
admissions that count ``flash``; nothing for another entry, without a
card, or (the share) where the admissions count no ``flash``."""

import importlib.util
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench.yardstick import Dims

# one layer's GEMMs: q 8x8, k and v 4x8, o 8x8, gate and up 16x8, down 8x16:
# 576 weights, and the two norms' 16
DIMS = Dims(dim=8, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=4, ffn=16, vocab=10)


def reader(metric):
    spec = importlib.util.spec_from_file_location(
        metric.replace(".", "_"), Path(__file__).parents[1] / "metrics" / f"{metric}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def window(admits, walls_ms):
    """A window ahead of every span recorded so far: for each entry of
    ``admits`` (its counts), a ``batcher.admit`` span under a fresh id and,
    where ``walls_ms`` gives one, that request's ``request.first_token``
    span of that many ms from the admission's start; one seated admission
    after the window, which must not count."""
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS

    t = time.perf_counter_ns() + 10**12
    rid = t % 10**9
    for i, (counts, wall) in enumerate(zip(admits, walls_ms)):
        t0 = t + i * 1000
        SPANS.add("batcher.admit", t0, t0 + 500, id=rid + i, **counts)
        if wall is not None:
            SPANS.add("request.first_token", t0, t0 + int(wall * 1e6), id=rid + i)
    late = t + 10**9
    SPANS.add("batcher.admit", late, late + 1, id=rid + len(admits), prompt=64, cached=0,
              computed=64, padded=0, flash=0)
    SPANS.add("request.first_token", late, late + 10**6, id=rid + len(admits))
    return SimpleNamespace(entry="paged_batcher", dims=DIMS,
                           window=(t / 1e9, (t + len(admits) * 1000 + 1000) / 1e9))


def seated(prompt, cached, computed, bucket, flash=None):
    counts = dict(prompt=prompt, cached=cached, computed=computed, padded=bucket - computed)
    if flash is not None:
        counts["flash"] = flash
    return counts


def test_prefill_mfu_is_the_hand_computed_share(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    read = reader("prefill_mfu.serve")
    # a fresh prompt of 5 rows (15 keys), and a hit of 3 rows after 4 cached
    # (3 x 4 + 6 = 18 keys); a stalled attempt and a request with no first
    # token yet count nothing
    rec = window([seated(5, 0, 5, 8, 1), {"prompt": 9, "stalled": 1}, seated(7, 4, 3, 8, 1),
                  seated(9, 0, 9, 16, 1)], [2.0, None, 3.0, None])
    layer_params = 576 + 16
    flops_a = 2 * 2 * layer_params * 5 + 4 * 2 * 4 * 2 * 15 + 2 * 8 * 10
    flops_b = 2 * 2 * layer_params * 3 + 4 * 2 * 4 * 2 * 18 + 2 * 8 * 10
    assert (flops_a, flops_b) == (12960, 8416)
    assert read(rec) == pytest.approx(100.0 * (flops_a + flops_b) / (5e-3 * 989e12))
    assert read(SimpleNamespace(entry="engine", window=rec.window)) is None
    assert read(window([{"prompt": 9, "stalled": 1}], [None])) is None


def test_prefill_mfu_reads_nothing_without_a_card(monkeypatch):
    rec = window([seated(5, 0, 5, 8, 1)], [2.0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert reader("prefill_mfu.serve")(rec) is None


def test_prefill_flash_share_counts_the_seated_admissions(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    read = reader("prefill_flash_share.serve")
    rec = window([seated(5, 0, 5, 8, 1), {"prompt": 9, "stalled": 1}, seated(7, 4, 3, 8, 1)],
                 [2.0, None, 3.0])
    assert read(rec) == pytest.approx(100.0)
    rec = window([seated(5, 0, 5, 8, 1), seated(7, 4, 3, 8, 0), seated(7, 0, 7, 8, 0),
                  seated(7, 0, 7, 8, 1)], [2.0, 3.0, 1.0, 1.0])
    assert read(rec) == pytest.approx(50.0)
    assert read(SimpleNamespace(entry="engine", window=rec.window)) is None
    assert read(window([{"prompt": 9, "stalled": 1}], [None])) is None


def test_prefill_flash_share_reads_nothing_without_the_count_or_a_card(monkeypatch):
    read = reader("prefill_flash_share.serve")
    rec = window([seated(5, 0, 5, 8, 1)], [2.0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert read(rec) is None                           # K1's plain version
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert read(window([seated(5, 0, 5, 8)], [2.0])) is None      # the parent's counts
