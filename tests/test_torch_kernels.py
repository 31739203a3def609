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
from llama_nuts_and_bolts_tpu_torch.kernels import k2_breakdown
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import tensor_from_numpy
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor

D = 128


def bf16(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32).astype(ml_dtypes.bfloat16)


def to_torch(arr):
    return tensor_from_numpy(arr, "cpu")


@pytest.mark.parametrize("S,start_pos,T", [(40, 57, 128), (64, 0, 128), (200, 100, 384)])
def test_k1_plain_matches_pallas_interpret(S, start_pos, T):
    """History (start_pos > 0) and a ragged S that is not a multiple of the
    q tile, against flash_gqa_attention(interpret=True); at T=384 the later
    q tiles stream three key tiles, full ones before the diagonal."""
    rng = np.random.default_rng(S)
    B, H, KV = 2, 8, 2
    assert max(k1.k1_geometry(B, S, H, KV, T, start_pos).k_tiles) == -(-T // k1.K1_BLOCK_K)
    q, k, v = bf16(rng, B, S, H, D), bf16(rng, B, KV, T, D), bf16(rng, B, KV, T, D)
    want = jax_flash_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   start_pos, interpret=True)
    before = k1.flash_gqa_attention.launches
    got = k1.flash_gqa_attention(to_torch(q), to_torch(k), to_torch(v), start_pos)
    assert k1.flash_gqa_attention.launches == before     # CPU: no kernel launch
    compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")


@pytest.mark.parametrize("T,positions,block_k", [
    (128, [5, 127, 64], 32),                 # one split of two tiles
    # 128-key splits: a row with one active split, one ending on a split's
    # last key, one on the next split's first key, one with all 8 active
    (1024, [5, 127, 128, 1023], 256)])
def test_k2_plain_matches_pallas_interpret_stacked_layer_positions(T, positions, block_k):
    """A stacked [L,B,KV,T,D] cache read at layer 1 with per-row [B]
    positions, against flash_decode_attention(interpret=True, layer=...):
    the plain version runs K2's split key walk and its combine."""
    rng = np.random.default_rng(7)
    L, B, H, KV = 3, len(positions), 8, 2
    geo = k2.k2_geometry(B, KV, T, positions)
    assert geo.split_k == 128 and max(geo.active_splits) == geo.grid[0]
    q = bf16(rng, B, 1, H, D)
    k, v = bf16(rng, L, B, KV, T, D), bf16(rng, L, B, KV, T, D)
    pos = np.array(positions, np.int32)
    want = jax_flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pos), block_k=block_k, layer=1,
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
    n_q = math.ceil(S / geo.block_q)
    assert geo.grid == (KV, n_q, 2)
    # a later q tile never streams fewer key tiles, so the kernel's
    # descending launch order starts the heaviest first
    assert all(a <= c for a, c in zip(geo.k_tiles, geo.k_tiles[1:]))
    for i in range(n_q):
        # the last key any (real or padded) row of q tile i may see
        last_key = min(T - 1, start_pos + (i + 1) * geo.block_q - 1)
        assert geo.last_visible_tile(i) == last_key // k1.K1_BLOCK_K
        # the Pallas kernel's own count (attention.py: num_k_blocks)
        last_visible = start_pos + (i + 1) * geo.block_q
        pallas = min(-(-last_visible // k1.K1_BLOCK_K), -(-T // k1.K1_BLOCK_K))
        assert geo.k_tiles[i] == pallas


@pytest.mark.parametrize("T,positions", [(8192, [0, 511, 512, 4095, 8191]),
                                         (100, [99, 150, 63]), (4096, [3000]),
                                         (2048, [3, 700, 2047, 1000])])
def test_k2_launch_geometry(T, positions):
    B, KV = len(positions), 8
    geo = k2.k2_geometry(B, KV, T, positions)
    split = k2.k2_split_k(B, KV, T)
    assert geo.split_k == split and split % k2.K2_BLOCK_K == 0
    assert geo.grid == (-(-T // split), KV, B)
    # the split depends on the shapes only: other positions, the same launch
    other = k2.k2_geometry(B, KV, T, [0] * B)
    assert (other.split_k, other.grid) == (geo.split_k, geo.grid)
    assert B * KV * geo.grid[0] <= 2 * k2.K2_TARGET_BLOCKS or split >= T
    assert geo.grid[0] <= k2.K2_MAX_SPLITS
    for b, p in enumerate(positions):
        # the active splits cover the visible keys once, in order, each
        # non-empty; the splits after them would start past the position
        spans = [geo.split_keys(b, s) for s in range(geo.active_splits[b])]
        # decode_attention.py kv_index: tiles past the row re-map to
        # start_pos // block_k, the last one that is read
        assert (spans[-1][1] - 1) // k2.K2_BLOCK_K == min(p, T - 1) // k2.K2_BLOCK_K
        assert spans[0][0] == 0 and spans[-1][1] == min(p + 1, T)
        assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
        assert all(lo < hi for lo, hi in spans)
        assert geo.active_splits[b] * split >= min(p + 1, T) > (geo.active_splits[b] - 1) * split


@pytest.mark.parametrize("variant", [n for n, e in k2_breakdown.VARIANTS.items() if e])
def test_k2_breakdown_builds_apply_to_the_kernel_source(variant):
    """Each stripped build of K2's source that k2_breakdown times finds the
    text it replaces exactly once, so an edited kernel cannot silently time
    another function."""
    src = (k2_breakdown.CSRC / "decode_attention.cu").read_text()
    for old, new in k2_breakdown.VARIANTS[variant]:
        assert src.count(old) == 1 and new != old


@pytest.mark.parametrize("B,KV,T,want", [
    (1, 8, 4096, 128), (1, 8, 8192, 256), (4, 8, 2048, 256), (1, 8, 256, 128),
    (64, 8, 2048, 2048), (3, 2, 100, 128), (1, 1, 131072, 512)])
def test_k2_split_rule(B, KV, T, want):
    """About two blocks per SM of 132 when every split is active: request B's
    decode step (T=4096) splits its rows at 128 keys, 256 blocks; two tiles
    at least; never more splits a row than the kernel's combine takes."""
    split = k2.k2_split_k(B, KV, T)
    assert split == want
    assert -(-T // split) <= k2.K2_MAX_SPLITS


def test_wrappers_refuse_what_k1_k2_do_not_compute():
    rng = np.random.default_rng(0)
    q1 = to_torch(bf16(rng, 1, 1, 8, D))
    k = to_torch(bf16(rng, 1, 1, 2, 64, D))
    # K3 (int8 cache) and K4 (fold_heads) are ported: tests/test_torch_kernels_int8.py
    with pytest.raises(ValueError, match="blocked=True"):   # K5 is single-layer
        k2.flash_decode_attention(q1, k, k, 3, layer=0, blocked=False)
    with pytest.raises(ValueError, match="k_scale"):      # int8 without its scales
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
