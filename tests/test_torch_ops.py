"""Ops of the PyTorch port against the JAX package's ops: the same seeded
numpy inputs go through both, compared with compare_tensor at bf16
tolerance (1e-2) unless the result must be bit-equal."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.models.llama import rope as jrope
from llama_nuts_and_bolts_tpu.models.llama.model import attention_mask as jmask
from llama_nuts_and_bolts_tpu.ops import gqa_attention as jgqa_attention
from llama_nuts_and_bolts_tpu.ops import greedy as jgreedy
from llama_nuts_and_bolts_tpu.ops import linear as jlinear
from llama_nuts_and_bolts_tpu.ops import linear_t as jlinear_t
from llama_nuts_and_bolts_tpu.ops import rms_norm as jrms_norm
from llama_nuts_and_bolts_tpu.ops import swiglu as jswiglu

from llama_nuts_and_bolts_tpu_torch.models.llama import rope
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import tensor_from_numpy
from llama_nuts_and_bolts_tpu_torch.ops import (
    attention_mask,
    gqa_attention,
    greedy,
    linear,
    linear_t,
    rms_norm,
    sample_token,
    swiglu,
)
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor

BF16 = ml_dtypes.bfloat16


def bf16(rng, *shape, scale=1.0):
    """Seeded bf16 numpy array: the one input both packages receive."""
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(BF16)


def both(arr):
    return jnp.asarray(arr), tensor_from_numpy(arr, "cpu")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, w = bf16(rng, 2, 5, 64), bf16(rng, 64)
    (jx, tx), (jw, tw) = both(x), both(w)
    got = rms_norm(tx, tw, 1e-5)
    assert got.dtype == torch.bfloat16
    compare_tensor(f32(got), f32(jrms_norm(jx, jw, 1e-5)), "bfloat16")


@pytest.mark.parametrize("out_dtype", [None, "float32"])
def test_linear_and_linear_t_match_jax(out_dtype):
    rng = np.random.default_rng(1)
    x, w = bf16(rng, 3, 7, 48), bf16(rng, 40, 48, scale=0.2)
    (jx, tx), (jw, tw) = both(x), both(w)
    jdt = None if out_dtype is None else jnp.float32
    tdt = None if out_dtype is None else torch.float32
    got = linear(tx, tw, out_dtype=tdt)
    assert got.dtype == (tdt or torch.bfloat16)
    compare_tensor(f32(got), f32(jlinear(jx, jw, out_dtype=jdt)), "bfloat16")
    wt = np.ascontiguousarray(w.T)
    got_t = linear_t(tx, tensor_from_numpy(wt, "cpu"), out_dtype=tdt)
    compare_tensor(f32(got_t), f32(jlinear_t(jx, jnp.asarray(wt), out_dtype=jdt)),
                   "bfloat16")
    # fp32 accumulation with one rounding: the fp32 head output is exact
    # against a float64 product of the same bf16 values
    if out_dtype == "float32":
        ref = x.astype(np.float64) @ w.astype(np.float64).T
        compare_tensor(f32(got), ref, "float32")


def test_swiglu_matches_jax():
    rng = np.random.default_rng(2)
    x = bf16(rng, 2, 3, 32)
    wg, wu, wd = bf16(rng, 48, 32, scale=0.3), bf16(rng, 48, 32, scale=0.3), bf16(rng, 32, 48, scale=0.3)
    args = [both(a) for a in (x, wg, wu, wd)]
    got = swiglu(*[t for _, t in args])
    compare_tensor(f32(got), f32(jswiglu(*[j for j, _ in args])), "bfloat16")


def test_attention_mask_equals_jax():
    for S, T, start in ((5, 16, 0), (3, 20, 9), (1, 8, 7)):
        got = attention_mask(S, T, start).numpy()
        np.testing.assert_array_equal(got, np.asarray(jmask(S, T, start)))


@pytest.mark.parametrize("S,start", [(6, 0), (1, 13)])
def test_gqa_attention_matches_jax(S, start):
    rng = np.random.default_rng(3)
    B, H, KV, D, T = 2, 8, 2, 16, 24
    q, k, v = bf16(rng, B, S, H, D), bf16(rng, B, KV, T, D), bf16(rng, B, KV, T, D)
    (jq, tq), (jk, tk), (jv, tv) = both(q), both(k), both(v)
    got = gqa_attention(tq, tk, tv, attention_mask(S, T, start)[None])
    want = jgqa_attention(jq, jk, jv, jmask(S, T, start)[None])
    compare_tensor(f32(got), f32(want), "bfloat16")


def test_rope_tables_bit_equal_and_rotation_matches_jax():
    cos, sin = rope.precompute_rope_tables(32, 64, 500000.0, use_scaled=True)
    jcos, jsin = jrope.precompute_rope_tables(32, 64, 500000.0, use_scaled=True)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    rng = np.random.default_rng(4)
    x = bf16(rng, 2, 5, 4, 32)
    jx, tx = both(x)
    got = rope.apply_rope(tx, torch.from_numpy(cos[3:8]), torch.from_numpy(sin[3:8]))
    want = jrope.apply_rope(jx, jnp.asarray(jcos[3:8]), jnp.asarray(jsin[3:8]))
    compare_tensor(f32(got), f32(want), "bfloat16")


def test_greedy_takes_lowest_index_on_ties_like_jax():
    logits = np.array([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0],
                       [-1.0, -2.0, -1.0, -3.0]], np.float32)
    got = greedy(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgreedy(jnp.asarray(logits))))
    np.testing.assert_array_equal(got, [1, 0, 0])


def test_sample_token_greedy_limits_and_support():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    top = torch.argmax(logits, -1).to(torch.int32)
    gen = torch.Generator().manual_seed(0)
    # temperature 0, top_k=1, and a tiny top_p all reduce to the argmax
    assert torch.equal(sample_token(logits, gen, 0.0), top)
    assert torch.equal(sample_token(logits, gen, 1.0, top_k=1), top)
    assert torch.equal(sample_token(logits, gen, 1.0, top_p=1e-6), top)
    # top_k=5 draws stay inside the 5 largest logits of each row
    allowed = torch.topk(logits, 5, dim=-1).indices
    for _ in range(20):
        draw = sample_token(logits, gen, 1.0, top_k=5)
        assert all(int(draw[r]) in allowed[r].tolist() for r in range(4))
    # the draw frequencies follow softmax(logits / T): 4000 draws of a
    # two-way choice with p = 0.731 stay within 5 sigma
    two = torch.tensor([[1.0, 0.0]])
    hits = sum(int(sample_token(two, gen, 1.0)) == 0 for _ in range(4000))
    p = 1 / (1 + np.exp(-1.0))
    assert abs(hits / 4000 - p) < 5 * np.sqrt(p * (1 - p) / 4000)
