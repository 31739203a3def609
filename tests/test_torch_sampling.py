"""Batched sampling of the PyTorch port against the JAX package's
``sample_tokens_batched`` / ``top_logprobs_batched`` on the same seeded
numpy logits. Greedy rows and the top-k / top-p masks must be equal; the
draws cannot be (threefry against torch generators), so the port is held to
the JAX sampler's properties instead: a row's token depends only on its
seed, position and logits, and the draws follow the masked distribution."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.ops import sampling as jsampling

from llama_nuts_and_bolts_tpu_torch.ops import sampling

# (temperature, top_k, top_p) per row: greedy, temperature only, top-k,
# top-p, both, top-k 1, a sharp top-p, top-k past the vocabulary
ROWS = [(0.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.3, 0, 0.9), (0.5, 10, 0.8),
        (1.0, 1, 1.0), (2.0, 50, 0.3), (0.9, 999, 0.95)]


def row_settings(rows=ROWS):
    temp = np.array([r[0] for r in rows], np.float32)
    top_k = np.array([r[1] for r in rows], np.int32)
    top_p = np.array([r[2] for r in rows], np.float32)
    return temp, top_k, top_p


def logits_for(seed, B=len(ROWS), V=64):
    return (np.random.default_rng(seed).standard_normal((B, V)) * 3).astype(np.float32)


def jax_call(logits, temp, top_k, top_p, positions=None):
    B = logits.shape[0]
    keys = np.zeros((B, 2), np.uint32)
    positions = np.arange(B, dtype=np.int32) if positions is None else positions
    return np.asarray(jsampling.sample_tokens_batched(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(positions),
        jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p)))


def port_call(logits, temp, top_k, top_p, seeds=None, positions=None):
    B = logits.shape[0]
    seeds = [0] * B if seeds is None else seeds
    positions = list(range(B)) if positions is None else positions
    return sampling.sample_tokens_batched(torch.from_numpy(logits), seeds, positions,
                                          temp, top_k, top_p).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_rows_equal_jax(seed):
    logits = logits_for(seed)
    temp = np.zeros(len(ROWS), np.float32)
    _, top_k, top_p = row_settings()
    want = jax_call(logits, temp, top_k, top_p)
    got = port_call(logits, temp, top_k, top_p)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    # sampled rows beside greedy ones leave the greedy rows' argmax alone
    temp, top_k, top_p = row_settings()
    mixed = port_call(logits, temp, top_k, top_p)
    assert mixed[0] == want[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_equal_jax(seed, monkeypatch):
    """JAX's draw sees the masked row; a categorical that returns the number
    of finite logits reads the size of its mask. The port's mask must have
    the same size and be a threshold set of the scaled logits (everything
    kept is above everything dropped), so the two sets are equal. One
    difference is by design: at top-p 1 JAX's fp32 running sum can reach
    1.0 before the last tokens and cut them; the port keeps them (top-p >= 1
    means no top-p). Those rows are held to JAX's mask being a subset of the
    port's whose dropped tokens carry under 1e-6 of the probability."""
    logits = logits_for(seed)
    temp, top_k, top_p = row_settings()
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, row: jnp.sum(jnp.isfinite(row)).astype(jnp.int32))
    want = jax_call(logits, temp, top_k, top_p)
    masked = sampling.masked_scaled_logits(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(top_k).long(), torch.from_numpy(top_p)).numpy()
    kept = np.isfinite(masked)
    for b, (t, k, p) in enumerate(ROWS):
        if t <= 0:
            continue
        scaled = logits[b] / t
        assert scaled[kept[b]].min() > scaled[~kept[b]].max(initial=-np.inf)
        np.testing.assert_allclose(masked[b][kept[b]], scaled[kept[b]], rtol=1e-6)
        if p < 1.0:
            assert kept[b].sum() == want[b], (b, ROWS[b])
            continue
        assert want[b] <= kept[b].sum()
        probs = np.exp(masked[b] - masked[b].max())
        probs /= probs.sum()
        assert np.sort(probs)[:kept[b].sum() - want[b]].sum() < 1e-6
    assert kept[5].sum() == 1 and kept[2].sum() == 5          # top-k 1 and 5


def test_logprobs_match_jax():
    """fp32 log-softmax on both sides: equal up to fp32 rounding (1e-5)."""
    logits = logits_for(3, B=4, V=300)
    chosen = np.array([0, 7, 299, 150], np.int32)
    want = jsampling.top_logprobs_batched(jnp.asarray(logits), jnp.asarray(chosen), 5)
    got = sampling.top_logprobs_batched(torch.from_numpy(logits),
                                        torch.from_numpy(chosen), 5)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].dtype == torch.int32


def test_row_depends_only_on_seed_position_and_logits():
    logits = logits_for(4)
    temp, top_k, top_p = row_settings()
    seeds = [11, 12, 13, 14, 15, 16, 17, 18]
    positions = [40, 41, 42, 43, 44, 45, 46, 47]
    first = port_call(logits, temp, top_k, top_p, seeds, positions)
    assert np.array_equal(first, port_call(logits, temp, top_k, top_p, seeds, positions))
    # row 3 alone, and row 3 among other neighbours in another order
    alone = port_call(logits[3:4], temp[3:4], top_k[3:4], top_p[3:4], [14], [43])
    assert alone[0] == first[3]
    order = [3, 0, 7, 1]
    shuffled = port_call(logits[order], temp[order], top_k[order], top_p[order],
                         [seeds[i] for i in order], [positions[i] for i in order])
    np.testing.assert_array_equal(shuffled, first[order])


def test_seed_and_position_change_the_draws():
    logits = np.zeros((64, 32), np.float32)              # uniform: every token likely
    temp, top_k, top_p = (np.ones(64, np.float32), np.zeros(64, np.int32),
                          np.ones(64, np.float32))
    a = port_call(logits, temp, top_k, top_p, [1] * 64, list(range(64)))
    b = port_call(logits, temp, top_k, top_p, [2] * 64, list(range(64)))
    assert (a != b).sum() > 32
    assert len(set(a.tolist())) > 10                    # positions give fresh draws
    assert sampling.row_seed(1, 5) != sampling.row_seed(5, 1)


@pytest.mark.parametrize("top_k", [0, 3])
def test_draws_follow_the_masked_distribution(top_k):
    """4000 draws over a vocabulary of 8, one per position: each token's
    frequency within 5 standard errors of its probability under the
    temperature-scaled, top-k-masked softmax, and masked tokens never drawn."""
    N, V, t = 4000, 8, 0.8
    row = np.array([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.2], np.float32)
    logits = np.tile(row, (N, 1))
    got = port_call(logits, np.full(N, t, np.float32), np.full(N, top_k, np.int32),
                    np.ones(N, np.float32), [7] * N, list(range(N)))
    scaled = row / t
    if top_k:
        scaled = np.where(scaled >= np.sort(scaled)[-top_k], scaled, -np.inf)
    p = np.exp(scaled - scaled.max())
    p /= p.sum()
    freq = np.bincount(got, minlength=V) / N
    se = np.sqrt(p * (1 - p) / N)
    assert np.all(np.abs(freq - p) <= 5 * se + 1e-12), (freq, p)
    assert np.all(freq[p == 0] == 0)
