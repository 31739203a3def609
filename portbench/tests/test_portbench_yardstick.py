"""The frozen work counts and peaks at shapes whose answers are known:
the smoke's readings at Llama-3.1-8B's attention widths (PERF.md's kernel
table), the published sizes of the benchmark's two configurations, and
small cases counted by hand."""

import json

import pytest

from portbench import yardstick as ys
from portbench.tests.conftest import BENCH

H, KV, D = 32, 8, 128


def ms(work):
    return ys.bound_s(*work)[0] * 1e3


def test_k1_bound_at_4096_is_the_smokes():
    t, kind = ys.bound_s(*ys.k1_work(4096, 4096, 0, H, KV, D))
    assert kind == "operations"
    assert t * 1e3 == pytest.approx(0.1390, abs=5e-5)


def test_k2_bound_at_position_3000_is_the_smokes():
    t, kind = ys.bound_s(*ys.k2_work([3000], 4096, H, KV, D))
    assert kind == "bytes"
    assert t * 1e3 == pytest.approx(0.0037, abs=5e-5)


def test_paged_bound_at_four_rows_is_the_smokes():
    assert ms(ys.paged_work([114] * 4, H, KV, D)) == pytest.approx(0.000582, abs=5e-7)
    assert ms(ys.paged_work([114] * 4, H, KV, D, int8=True)) == pytest.approx(0.000305,
                                                                              abs=5e-7)


def test_k1_counts_by_hand():
    # 3 rows from position 2 over a cache of 4: keys 3, 4, 4
    nbytes, ops = ys.k1_work(3, 4, 2, H=2, KV=1, D=8)
    assert ops == 4.0 * 2 * 8 * (3 + 4 + 4)
    assert nbytes == 2 * 3 * 2 * 8 * 2 + 2 * 1 * 4 * 8 * 2


def test_attention_keys_and_model_flops():
    assert ys.attention_keys(0, 4) == 1 + 2 + 3 + 4
    assert ys.attention_keys(10, 2) == 11 + 12
    d = ys.Dims(dim=8, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=4, ffn=16, vocab=10)
    layer = 8 * 8 + 2 * 4 * 8 + 8 * 8 + 3 * 16 * 8 + 2 * 8
    assert d.layer_params == layer
    assert ys.model_flops(d, 3, 6, 1) == 2.0 * 2 * layer * 3 + 4.0 * 2 * 4 * 2 * 6 + 2.0 * 8 * 10


@pytest.mark.parametrize("name, ffn, params, weight_gb", [
    ("mistral-7b-v0.3", 14336, 7.248e9, 14.50),
    ("phi-3-medium-4k", 17920, 13.96e9, 27.92),
])
def test_configurations_have_their_published_sizes(name, ffn, params, weight_gb):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    d = ys.Dims.from_config(cfg)
    assert d.ffn == ffn == cfg["published"]["intermediate_size"]
    assert d.head_dim == 128 and d.n_heads // d.n_kv_heads == 4
    n = d.n_layers * d.layer_params + 2 * d.vocab * d.dim + d.dim
    assert n == pytest.approx(params, rel=2e-3)
    assert 2 * n / 1e9 == pytest.approx(weight_gb, rel=2e-3)


def test_gemm_bound_splits_by_kind():
    d = ys.Dims(dim=4096, n_layers=32, n_heads=32, n_kv_heads=8, head_dim=128,
                ffn=14336, vocab=32768)
    one = ys.gemm_ideal_s(d, 1, 1)
    assert one["operations"] == 0 and one["total"] == pytest.approx(one["bytes"])
    # a decode step reads every projection and the head once (14.2 GB:
    # the embedding is gathered, not multiplied) at 3.35 TB/s
    gemm_bytes = 2 * (d.n_layers * sum(o * i for o, i in d.linears()) + d.vocab * d.dim)
    assert one["total"] == pytest.approx(gemm_bytes / ys.HBM_BYTES_PER_S, rel=1e-3)
    big = ys.gemm_ideal_s(d, 4096, 1)
    assert big["operations"] > big["bytes"]
