"""Kernels K1/K2 of the PyTorch port on the CPU: their plain versions (what
the wrappers run for CPU tensors) against the JAX package's Pallas kernels
in interpret mode, the launch arithmetic shared with the CUDA kernels, and
the wrappers' refusals. The CUDA kernels themselves are held against the
plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import math

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.kernels.attention import (
    flash_gqa_attention as jax_flash_gqa_attention,
)
from llama_nuts_and_bolts_tpu.kernels.decode_attention import (
    flash_decode_attention as jax_flash_decode_attention,
)

from llama_nuts_and_bolts_tpu_torch.kernels import attention as k1
from llama_nuts_and_bolts_tpu_torch.kernels import decode_attention as k2
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import tensor_from_numpy
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor

D = 128


def bf16(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32).astype(ml_dtypes.bfloat16)


def to_torch(arr):
    return tensor_from_numpy(arr, "cpu")


@pytest.mark.parametrize("S,start_pos", [(40, 57), (64, 0)])
def test_k1_plain_matches_pallas_interpret(S, start_pos):
    """History (start_pos > 0) and a ragged S that is not a multiple of the
    q tile, against flash_gqa_attention(interpret=True)."""
    rng = np.random.default_rng(S)
    B, H, KV, T = 2, 8, 2, 128
    q, k, v = bf16(rng, B, S, H, D), bf16(rng, B, KV, T, D), bf16(rng, B, KV, T, D)
    want = jax_flash_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   start_pos, interpret=True)
    before = k1.flash_gqa_attention.launches
    got = k1.flash_gqa_attention(to_torch(q), to_torch(k), to_torch(v), start_pos)
    assert k1.flash_gqa_attention.launches == before     # CPU: no kernel launch
    compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")


def test_k2_plain_matches_pallas_interpret_stacked_layer_positions():
    """A stacked [L,B,KV,T,D] cache read at layer 1 with per-row [B]
    positions, against flash_decode_attention(interpret=True, layer=...)."""
    rng = np.random.default_rng(7)
    L, B, H, KV, T = 3, 3, 8, 2, 128
    q = bf16(rng, B, 1, H, D)
    k, v = bf16(rng, L, B, KV, T, D), bf16(rng, L, B, KV, T, D)
    pos = np.array([5, 127, 64], np.int32)
    want = jax_flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pos), block_k=32, layer=1,
                                      interpret=True)
    before = k2.flash_decode_attention.launches
    got = k2.flash_decode_attention(to_torch(q), to_torch(k), to_torch(v),
                                    torch.from_numpy(pos), layer=1)
    assert k2.flash_decode_attention.launches == before
    compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")
    # an int position broadcasts to every row, a 4-D cache is one layer
    one = k2.flash_decode_attention(to_torch(q), to_torch(k[2]), to_torch(v[2]), 9)
    again = k2.flash_decode_attention(to_torch(q), to_torch(k), to_torch(v),
                                      torch.full((B,), 9, dtype=torch.int32), layer=2)
    assert torch.equal(one, again)


@pytest.mark.parametrize("H,KV,S,T,start_pos", [
    (32, 8, 512, 2048, 0), (32, 8, 333, 2048, 700), (8, 8, 5, 70, 64),
    (16, 1, 100, 100, 0)])
def test_k1_launch_geometry(H, KV, S, T, start_pos):
    geo = k1.k1_geometry(2, S, H, KV, T, start_pos)
    G = H // KV
    assert geo.block_q * G == k1.K1_ROWS
    assert geo.grid == (math.ceil(S / geo.block_q), KV, 2)
    for i in range(geo.grid[0]):
        # the last key any (real or padded) row of q tile i may see
        last_key = min(T - 1, start_pos + (i + 1) * geo.block_q - 1)
        assert geo.last_visible_tile(i) == last_key // k1.K1_BLOCK_K
        # the Pallas kernel's own count (attention.py: num_k_blocks)
        last_visible = start_pos + (i + 1) * geo.block_q
        pallas = min(-(-last_visible // k1.K1_BLOCK_K), -(-T // k1.K1_BLOCK_K))
        assert geo.k_tiles[i] == pallas


@pytest.mark.parametrize("T,positions", [(8192, [0, 511, 512, 4095, 8191]),
                                         (100, [99, 150, 63])])
def test_k2_launch_geometry(T, positions):
    geo = k2.k2_geometry(len(positions), 8, T, positions)
    assert geo.grid == (8, len(positions))
    for b, p in enumerate(positions):
        # decode_attention.py kv_index: tiles past the row re-map to
        # start_pos // block_k, the last one that is read
        assert geo.last_visible_tile(b) == min(p, T - 1) // k2.K2_BLOCK_K
        assert geo.k_tiles[b] * k2.K2_BLOCK_K >= min(p + 1, T)


def test_wrappers_refuse_what_k1_k2_do_not_compute():
    rng = np.random.default_rng(0)
    q1 = to_torch(bf16(rng, 1, 1, 8, D))
    k = to_torch(bf16(rng, 1, 1, 2, 64, D))
    with pytest.raises(NotImplementedError, match="K4"):
        k2.flash_decode_attention(q1, k, k, 3, layer=0, fold_heads=True)
    with pytest.raises(NotImplementedError, match="K5"):
        k2.flash_decode_attention(q1, k, k, 3, layer=0, blocked=False)
    with pytest.raises(NotImplementedError, match="K3"):
        k2.flash_decode_attention(q1, k.to(torch.int8), k.to(torch.int8), 3, layer=0)
    with pytest.raises(ValueError, match="layer"):
        k2.flash_decode_attention(q1, k, k, 3, layer=1)
    with pytest.raises(TypeError, match="int32"):
        k2.flash_decode_attention(q1, k, k, torch.tensor([3]), layer=0)
    q64 = to_torch(bf16(rng, 1, 4, 8, 64))
    k64 = to_torch(bf16(rng, 1, 2, 64, 64))
    with pytest.raises(ValueError, match="head_dim"):
        k1.flash_gqa_attention(q64, k64, k64, 0)
    q = to_torch(bf16(rng, 1, 4, 8, D))
    with pytest.raises(TypeError, match="bf16"):
        k1.flash_gqa_attention(q.float(), k[0].float(), k[0].float(), 0)
    with pytest.raises(ValueError, match="start_pos"):
        k1.flash_gqa_attention(q, k[0], k[0], torch.tensor(0))
    # a tensor on neither the CPU nor a card: raise, never run the plain path
    qm, km = q.to("meta"), k[0].to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        k1.flash_gqa_attention(qm, km, km, 0)
