"""Paged KV pool of the PyTorch port against the JAX package.

  * K6 (bf16 and int8 pools), K7 and K5: the plain versions (what the
    wrappers run for CPU tensors) against the Pallas kernels in interpret
    mode on the same seeded numpy inputs, the span rule, the refusals;
  * ``paged_prefill``, ``paged_prefill_shared`` and ``paged_decode_step``
    (bf16 and int8 pools, both attention paths) against the JAX functions on
    the same weights: logits and pool contents;
  * ``PagedBatcher`` against the port's sequential engine on the
    constructed-cyclic model (tests/test_torch_continuous.py): exact streams
    through the prefix cache, pool starvation, cancellation, quanta, an int8
    pool and K6's path;
  * the admission prefill on K1 (``attn_impl="flash"``, its tiled plain
    version on the CPU) against the plain path at head_dim 128, in the
    model functions and through a batcher."""

import time
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.io.params import ModelArgs as JModelArgs
from llama_nuts_and_bolts_tpu.kernels.decode_attention import (
    flash_decode_attention as jax_flash_decode_attention,
)
from llama_nuts_and_bolts_tpu.kernels.paged_attention import (
    paged_flash_decode as jax_paged_flash_decode,
)
from llama_nuts_and_bolts_tpu.models.llama import model as jmodel
from llama_nuts_and_bolts_tpu.models.llama import paged as jpaged

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.kernels import decode_attention as dk
from llama_nuts_and_bolts_tpu_torch.kernels import paged_attention as pa
from llama_nuts_and_bolts_tpu_torch.models.llama import paged
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import (
    params_from_numpy,
    tensor_from_numpy,
    tensor_to_numpy,
)
from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher, default_attn_impl
from llama_nuts_and_bolts_tpu_torch.runtime.types import GenerationState
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests.test_torch_continuous import (
    EDGE_PROMPT,
    PROMPTS,
    drain,
    make_engine,
    one_torch_thread,
    sequential,
    toks,
)
from tests.test_torch_engine import SPEC, leaves
from tests.test_torch_kernels_int8 import assert_int8_dots_close, int8_cache

D = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def bf16(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32).astype(ml_dtypes.bfloat16)


def t(a):
    return tensor_from_numpy(a, "cpu")


def pool_case(seed, L=2, n_blocks=20, KV=2, bs=8, B=3, M=6, H=8, quantized=False):
    """A stacked pool with a seeded scatter of blocks: row b's table is a
    slice of one permutation of blocks 1..n_blocks-1."""
    rng = np.random.default_rng(seed)
    shape = (L, n_blocks, KV, bs, D)
    if quantized:
        (k, ks), (v, vs) = int8_cache(rng, shape), int8_cache(rng, shape)
    else:
        k, v, ks, vs = bf16(rng, *shape), bf16(rng, *shape), None, None
    tables = (rng.permutation(n_blocks - 1)[:B * M] + 1).reshape(B, M).astype(np.int32)
    return bf16(rng, B, 1, H, D), k, v, ks, vs, tables


def launches():
    return (pa.paged_flash_decode.launches, pa.paged_flash_decode_int8.launches,
            pa.paged_flash_decode_per_head.launches,
            dk.flash_decode_attention_whole_head.launches)


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("M,pos", [(6, [0, 17, 47]), (4, [8, 31, 7])])
def test_k6_plain_matches_pallas_interpret(M, pos):
    """Stacked pool read at layer 1, scattered tables, positions on a block
    edge and in the table's last block; M=6 gives spans of 6 blocks, M=4 of
    4. The plain version follows the Pallas span: bf16 tolerance (the fp32
    sums come in another order)."""
    q, k, v, _, _, tables = pool_case(M, M=M)
    pos = np.array(pos, np.int32)
    want = jax_paged_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(tables), jnp.asarray(pos), layer=1,
                                  interpret=True)
    before = launches()
    got = pa.paged_flash_decode(t(q), t(k), t(v), torch.from_numpy(tables),
                                torch.from_numpy(pos), layer=1)
    assert launches() == before                       # CPU: no kernel launch
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")


def test_k6_int8_plain_matches_pallas_interpret():
    """The int8 mode's numerics follow the Pallas kernel's per-block
    quantization of p: one bf16 ulp."""
    q, k, v, ks, vs, tables = pool_case(3, quantized=True)
    pos = np.array([5, 40, 16], np.int32)
    want = jax_paged_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(tables), jnp.asarray(pos), layer=0,
                                  pool_ks=jnp.asarray(ks), pool_vs=jnp.asarray(vs),
                                  interpret=True)
    got = pa.paged_flash_decode(t(q), t(k), t(v), torch.from_numpy(tables),
                                torch.from_numpy(pos), layer=0, pool_ks=t(ks),
                                pool_vs=t(vs))
    assert_int8_dots_close(got, want)


def test_k7_plain_matches_pallas_interpret():
    q, k, v, _, _, tables = pool_case(7, L=1)
    pos = np.array([0, 23, 47], np.int32)
    want = jax_paged_flash_decode(jnp.asarray(q), jnp.asarray(k[0]), jnp.asarray(v[0]),
                                  jnp.asarray(tables), jnp.asarray(pos),
                                  fold_heads=False, interpret=True)
    got = pa.paged_flash_decode(t(q), t(k[0]), t(v[0]), torch.from_numpy(tables),
                                torch.from_numpy(pos), fold_heads=False)
    compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")


# Forced splits of the table walk (entries a split takes), each with positions
# on a split's first and last key and rows with 1, 2 and 3 active splits. At
# M=6, bs=8 the Pallas span is all 6 entries, so every split edge lies inside
# a span: p is rounded relative to the split's running max, and the splits
# combine in fp32.
SPLIT_CASES = [(2, [5, 16, 47]), (2, [15, 31, 32]), (3, [23, 24, 47]), (3, [0, 8, 40])]


def rel_l2(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("split,pos", SPLIT_CASES)
def test_k6_split_plain_matches_pallas_interpret(split, pos):
    """The kernel's partition against the Pallas kernel's single walk: spans
    cut at the split's edges change where p is rounded to bf16, and the
    combine changes the order of the fp32 sums. Both move an output by about
    one bf16 rounding: the bf16 tolerance of the unsplit test (1e-2 absolute
    and relative per element), and 3e-3 relative L2. Read here: at most
    7.8e-3 absolute (one ulp at |x| ~ 1) and 1.2e-3 relative L2, where the
    unsplit walk is bit-equal to the JAX kernel."""
    q, k, v, _, _, tables = pool_case(20 + split)
    pos = np.array(pos, np.int32)
    want = jax_paged_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(tables), jnp.asarray(pos), layer=1,
                                  interpret=True)
    got = pa.paged_flash_decode(t(q), t(k), t(v), torch.from_numpy(tables),
                                torch.from_numpy(pos), layer=1, split=split)
    geo = pa.paged_geometry(3, 2, 6, 8, pos.tolist(), pa.paged_chunk(6, 8), split)
    assert sorted(set(geo.active_splits)) == sorted(set(-(-(p // 8 + 1) // split)
                                                        for p in pos.tolist()))
    assert max(geo.active_splits) > 1
    assert rel_l2(got, want) <= 3e-3
    compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")


@pytest.mark.parametrize("split,pos", SPLIT_CASES)
def test_k6_int8_split_plain_matches_pallas_interpret(split, pos):
    """A split's edge is a pool block's, so p's quantization rows stay the
    Pallas kernel's and only the fp32 combine is new: against the unsplit
    walk, one bf16 ulp per element (read here: the same bits). Against the
    JAX kernel, where XLA's and PyTorch's exp may round an fp32 p to
    neighbouring values that quantize to neighbouring int8 steps, one step
    of p_i moves an output by up to ~4e-3 and its row by up to ~4e-3
    relative L2: the bf16 tolerance per element (1e-2) and 2e-3 relative L2
    over the output (read here: at most 3.9e-3 absolute, 3.8e-3 in the row
    with a flipped step, 6.4e-4 overall: the unsplit walk's own drift)."""
    q, k, v, ks, vs, tables = pool_case(30 + split, quantized=True)
    pos = np.array(pos, np.int32)
    want = jax_paged_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(tables), jnp.asarray(pos), layer=0,
                                  pool_ks=jnp.asarray(ks), pool_vs=jnp.asarray(vs),
                                  interpret=True)
    args = (t(q), t(k), t(v), torch.from_numpy(tables), torch.from_numpy(pos))
    got = pa.paged_flash_decode(*args, layer=0, pool_ks=t(ks), pool_vs=t(vs), split=split)
    whole = pa.paged_flash_decode(*args, layer=0, pool_ks=t(ks), pool_vs=t(vs))
    torch.testing.assert_close(got.float(), whole.float(), rtol=2.0 ** -7, atol=1e-6)
    compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")
    assert rel_l2(got, want) <= 2e-3


@pytest.mark.parametrize("split,pos", SPLIT_CASES)
def test_k7_split_plain_matches_pallas_interpret(split, pos):
    """K7 updates once per block on both sides; the splits add only the fp32
    combine, which moves an output by about one bf16 rounding: the bf16
    tolerance and 3e-3 relative L2 (read here: at most 3.9e-3 absolute and
    1.3e-3 relative L2)."""
    q, k, v, _, _, tables = pool_case(40 + split, L=1)
    pos = np.array(pos, np.int32)
    want = jax_paged_flash_decode(jnp.asarray(q), jnp.asarray(k[0]), jnp.asarray(v[0]),
                                  jnp.asarray(tables), jnp.asarray(pos),
                                  fold_heads=False, interpret=True)
    got = pa.paged_flash_decode(t(q), t(k[0]), t(v[0]), torch.from_numpy(tables),
                                torch.from_numpy(pos), fold_heads=False, split=split)
    assert rel_l2(got, want) <= 3e-3
    compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")


def test_one_split_is_the_unsplit_walk():
    """A split covering the whole table is the Pallas walk: the rule's
    choice at the tests' tiny shapes, and forced, give the same bits."""
    q, k, v, _, _, tables = pool_case(11)
    args = (t(q), t(k), t(v), torch.from_numpy(tables), torch.tensor([3, 30, 47],
                                                                      dtype=torch.int32))
    assert pa.paged_split(3, 2, 6, 8) == 6
    assert torch.equal(pa.paged_flash_decode(*args, layer=0),
                       pa.paged_flash_decode(*args, layer=0, split=6))
    assert not torch.equal(pa.paged_flash_decode(*args, layer=0),
                           pa.paged_flash_decode(*args, layer=0, split=1))


@pytest.mark.parametrize("B,M,bs,want", [(1, 64, 32, 2), (4, 64, 32, 8), (16, 64, 32, 32),
                                         (64, 64, 32, 64), (1, 256, 32, 8), (3, 6, 8, 6),
                                         (1, 4096, 32, 128), (2, 100, 16, 8), (1, 8, 64, 1)])
def test_paged_split_rule(B, M, bs, want):
    """From 64 keys up, doubled until the B * KV heads reach about 256
    blocks and no row has more than 256 splits; never more than M."""
    KV = 8
    split = pa.paged_split(B, KV, M, bs)
    assert split == want
    assert 1 <= split <= M and -(-M // split) <= pa.PAGED_MAX_SPLITS
    floor = max(1, 64 // bs)
    # the rule stops at its floor, at M, or where half the split would
    # exceed the target
    assert split in (min(M, floor), M) or (split // 2) * dk.K2_TARGET_BLOCKS < B * KV * M


@pytest.mark.parametrize("split", [None, 1, 3])
def test_paged_geometry_from_shapes_only(split):
    """The grid comes from the shapes alone, whatever the positions; the
    active splits of a row cover its used entries exactly, and each span
    lies inside one Pallas span and one split."""
    B, KV, M, bs = 4, 8, 64, 32
    chunk = pa.paged_chunk(M, bs)
    rows = [[-1, 0, 31, 32], [2047, 114, 1850, 64], [9000, 63, 95, 96]]
    geos = [pa.paged_geometry(B, KV, M, bs, p, chunk, split) for p in rows]
    assert len({(g.split, g.grid) for g in geos}) == 1
    for geo, pos in zip(geos, rows):
        assert geo.grid == (-(-M // geo.split), KV, B)
        for b, p in enumerate(pos):
            used = 0 if p < 0 else min(p // bs, M - 1) + 1
            assert geo.n_entries[b] == used
            assert geo.active_splits[b] == max(1, -(-used // geo.split))
            assert geo.active_splits[b] <= geo.grid[0]
            entries = []
            for s in range(geo.active_splits[b]):
                lo, hi = geo.split_entries(b, s)
                for a, a1 in geo.spans(b, s):
                    assert lo <= a < a1 <= hi
                    assert a // chunk == (a1 - 1) // chunk
                    entries += range(a, a1)
            assert entries == list(range(used))
    with pytest.raises(ValueError, match="splits"):
        pa.paged_geometry(B, KV, 512, bs, rows[0], chunk, 1)


def test_paged_block_size_refusal_and_rule():
    """The kernel copies 16-byte runs, so it takes pool blocks of a multiple
    of 8 positions up to 64: the wrapper refuses others before a launch, the
    default rule sends them to the gather path, and a forced ``flash`` on a
    card is refused when the batcher is built."""
    assert [bs for bs in range(1, 80) if pa.paged_kernel_takes(bs)] == list(range(8, 65, 8))
    q = torch.zeros((1, 1, 8, D), dtype=torch.bfloat16)
    for bs, ok in ((4, False), (12, False), (72, False), (8, True), (32, True)):
        pool = torch.zeros((1, 3, 2, bs, D), dtype=torch.bfloat16)
        if ok:
            pa._require_kernel_shape(q, (pool, pool))
        else:
            with pytest.raises(ValueError, match="multiple of 8"):
                pa._require_kernel_shape(q, (pool, pool))

    def engine(impl="auto"):
        return types.SimpleNamespace(
            device=torch.device("cuda"), _kernels_viable=lambda: True,
            args=types.SimpleNamespace(kv_cache_dtype="bf16", attn_impl=impl))

    assert default_attn_impl(engine(), 32) == "flash"
    assert default_attn_impl(engine(), 12) == "plain"
    assert default_attn_impl(engine(), 128) == "plain"
    with pytest.raises(ValueError, match="multiple of 8"):
        PagedBatcher(engine(), block_size=12, attn_impl="flash")
    with pytest.raises(ValueError, match="multiple of 8"):
        PagedBatcher(engine("flash"), block_size=4)


@pytest.mark.parametrize("quantized", [False, True])
def test_k5_plain_matches_pallas_interpret(quantized):
    """blocked=False over a single-layer cache: the Pallas kernel's tiles are
    min(512, T) keys, the port's K2's 64, so the sums come in another order:
    bf16 tolerance."""
    rng = np.random.default_rng(5)
    B, H, KV, T = 3, 8, 2, 256
    q = bf16(rng, B, 1, H, D)
    pos = np.array([0, 100, 255], np.int32)
    if quantized:
        (k, ks), (v, vs) = int8_cache(rng, (B, KV, T, D)), int8_cache(rng, (B, KV, T, D))
        jscales = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        scales = dict(k_scale=t(ks), v_scale=t(vs))
    else:
        k, v = bf16(rng, B, KV, T, D), bf16(rng, B, KV, T, D)
        jscales, scales = {}, {}
    want = jax_flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pos), blocked=False, interpret=True,
                                      **jscales)
    before = launches()
    got = dk.flash_decode_attention(t(q), t(k), t(v), torch.from_numpy(pos),
                                    blocked=False, **scales)
    assert launches() == before
    compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")


@pytest.mark.parametrize("M,bs", [(64, 32), (6, 8), (4, 8), (7, 32), (1, 64), (10, 1024)])
def test_span_rule_matches_jax(M, bs):
    """paged_attention.py:256-259 of the JAX package."""
    chunk = max(1, min(M, 512 // bs))
    while M % chunk:
        chunk -= 1
    assert pa.paged_chunk(M, bs) == chunk


def test_paged_wrapper_refusals():
    q, k, v, ks, vs, tables = pool_case(9, quantized=True)
    q, k, v, ks, vs, tbl = t(q), t(k), t(v), t(ks), t(vs), torch.from_numpy(tables)
    with pytest.raises(ValueError, match="S=1"):
        pa.paged_flash_decode(torch.cat([q, q], 1), k, v, tbl, 3, layer=0, pool_ks=ks,
                              pool_vs=vs)
    with pytest.raises(ValueError, match="fold_heads"):
        pa.paged_flash_decode(q, k, v, tbl, 3, layer=0, fold_heads=False, pool_ks=ks,
                              pool_vs=vs)
    with pytest.raises(ValueError, match="int8 pools"):
        pa.paged_flash_decode(q, k[0], v[0], tbl, 3, fold_heads=False, pool_ks=ks[0],
                              pool_vs=vs[0])
    with pytest.raises(ValueError, match="pool_ks"):           # int8 without scales
        pa.paged_flash_decode(q, k, v, tbl, 3, layer=0)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_flash_decode(q, k, v, tbl.long(), 3, layer=0, pool_ks=ks, pool_vs=vs)
    with pytest.raises(ValueError, match="layer"):
        pa.paged_flash_decode(q, k, v, tbl, 3, layer=2, pool_ks=ks, pool_vs=vs)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_flash_decode(q.to("meta"), k.to("meta"), v.to("meta"), tbl.to("meta"),
                              3, layer=0, pool_ks=ks.to("meta"), pool_vs=vs.to("meta"))


# ----------------------------------------------------------- paged model

JCFG = JModelArgs(**SPEC)
CFG = ModelArgs(**SPEC)
BS = 8


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(jmodel.init_random_params, static_argnums=(0,))(JCFG, jax.random.PRNGKey(4))
    return jp, params_from_numpy(leaves(jp), "cpu")


def pool_values(pool, name, numpy_of):
    """A pool buffer as fp32, dequantized for an int8 pool."""
    vals = numpy_of(getattr(pool, name)).astype(np.float32)
    if getattr(pool, name).dtype in (torch.int8, jnp.int8):
        vals = vals * numpy_of(getattr(pool, name + "_scale")).astype(np.float32)[..., None]
    return vals


def port_np(x):
    return tensor_to_numpy(x, ml_dtypes.bfloat16)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_model_functions_match_jax(weights, kv):
    """Request A (13 tokens) prefills into blocks [3, 7]; request B shares
    A's first block and prefills only its 5-token suffix into [5]; then one
    decode step of both rows at position 13, on the gather path and on K6's
    (the Pallas kernel in interpret mode on JAX's side). Logits within the
    bf16 drift bar of tests/test_torch_model.py, pools likewise (dequantized
    for int8: rows quantized from values an ulp apart may differ by a
    quantum)."""
    jp, params = weights
    int8 = kv == "int8"
    n_blocks = 12
    jpool = jpaged.PagedKVPool.create(JCFG, n_blocks, BS, dtype=jnp.int8 if int8 else
                                      jnp.bfloat16)
    pool = paged.PagedKVPool.create(CFG, n_blocks, BS, torch.int8 if int8 else
                                    torch.bfloat16, device="cpu")
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, 13).astype(np.int32)
    b = np.concatenate([a[:8], rng.integers(0, 256, 5).astype(np.int32)])
    table_a = np.array([3, 7, 2, 0], np.int32)
    table_b = np.array([3, 5, 9, 0], np.int32)

    def padded(tokens, n):
        out = np.zeros((1, n), np.int32)
        out[0, :len(tokens)] = tokens
        return out

    want = jax.jit(jpaged.paged_prefill, static_argnums=(1,))(
        jp, JCFG, jnp.asarray(padded(a, 16)), 12, jpool, jnp.asarray(table_a))
    jpool = want[1]
    got = paged.paged_prefill(params, CFG, torch.from_numpy(padded(a, 16)), 12, pool,
                              torch.from_numpy(table_a))
    compare_tensor(got[0].numpy(), np.asarray(want[0]), "bfloat16", tolerance_multiplier=5.0)
    want = jax.jit(jpaged.paged_prefill_shared, static_argnums=(1,))(
        jp, JCFG, jnp.asarray(padded(b[8:], 8)), 8, 4, jpool, jnp.asarray(table_b))
    jpool = want[1]
    got = paged.paged_prefill_shared(params, CFG, torch.from_numpy(padded(b[8:], 8)), 8, 4,
                                     pool, torch.from_numpy(table_b))
    compare_tensor(got[0].numpy(), np.asarray(want[0]), "bfloat16", tolerance_multiplier=5.0)

    toks = np.array([[a[-1]], [b[-1]]], np.int32)
    positions = np.array([13, 13], np.int32)
    tables = np.stack([table_a, table_b])
    step = jax.jit(jpaged.paged_decode_step, static_argnums=(1, 6))
    for jimpl, impl in (("xla", "plain"), ("pallas", "flash")):
        jlogits, jpool_after = step(jp, JCFG, jnp.asarray(toks), jnp.asarray(positions),
                                    jpool, jnp.asarray(tables), jimpl)
        snapshot = paged.PagedKVPool(*(x.clone() for x in pool.buffers()))
        logits, after = paged.paged_decode_step(params, CFG, torch.from_numpy(toks),
                                                torch.from_numpy(positions), snapshot,
                                                torch.from_numpy(tables), impl)
        compare_tensor(logits.numpy(), np.asarray(jlogits), "bfloat16",
                       tolerance_multiplier=5.0)
        for name in ("k", "v"):
            compare_tensor(pool_values(after, name, port_np),
                           pool_values(jpool_after, name, np.asarray),
                           "bfloat16", tolerance_multiplier=5.0)


def test_paged_refusals(weights):
    _, params = weights
    pool = paged.PagedKVPool.create(CFG, 4, BS, device="cpu")
    with pytest.raises(ValueError, match="multiple of the block size"):
        paged.paged_prefill(params, CFG, torch.zeros((1, 12), dtype=torch.int32), 3, pool,
                            torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="one request"):
        paged.paged_prefill(params, CFG, torch.zeros((2, 8), dtype=torch.int32), 3, pool,
                            torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="attn_impl"):
        paged.paged_decode_step(params, CFG, torch.zeros((1, 1), dtype=torch.int32),
                                torch.zeros(1, dtype=torch.int32), pool,
                                torch.zeros((1, 4), dtype=torch.int32), "pallas")
    for fn, args in ((paged.paged_prefill, (3,)), (paged.paged_prefill_shared, (8, 3))):
        with pytest.raises(ValueError, match="attn_impl"):
            fn(params, CFG, torch.zeros((1, 8), dtype=torch.int32), *args, pool,
               torch.zeros(4, dtype=torch.int32), attn_impl="pallas")
    with pytest.raises(ValueError, match="trash"):
        paged.PagedKVPool.create(CFG, 1, BS, device="cpu")


# ------------------------------------------------------------- scheduler

def make_paged(n_slots=2, n_blocks=None, kv="bf16", **kw):
    return PagedBatcher(make_engine(kv_cache_dtype=kv), n_slots=n_slots, n_blocks=n_blocks,
                        block_size=BS, **kw)


@pytest.mark.parametrize("kv,impl", [("bf16", None), ("bf16", "flash"), ("int8", None),
                                     ("int8", "flash")])
def test_paged_batcher_matches_sequential(kv, impl):
    """Greedy streams on two slots equal the sequential engine's, on the
    gather path and on K6's (its plain version on the CPU), for bf16 and
    int8 pools: one runs to the context's end, growing a block every 8
    tokens, one starts at the context's last admissible length (finish
    states included for both); every block returns to the pool."""
    cb = make_paged(kv=kv, attn_impl=impl)
    assert cb.attn_impl == (impl or "plain")
    eng = cb.engine
    prompts = PROMPTS + [EDGE_PROMPT]
    caps = (None, 12, 9, 12, 12, None)
    reqs = [cb.submit(p, **({} if n is None else {"max_new_tokens": n}))
            for p, n in zip(prompts, caps)]
    cb.run_until_idle()
    for r, p, n in zip(reqs, prompts, caps):
        got, want = drain(r), sequential(eng, p, n)
        assert (got if n is None else toks(got)) == (want if n is None else toks(want))
    assert cb.allocator.available + cb.allocator.stats["cached_blocks"] \
        >= cb.allocator.n_blocks - 1


def test_prefix_cache_hit_outputs_identical():
    """The second request shares a 17-token prefix (two full blocks) with
    the first: it revives both blocks, prefills only its suffix, and streams
    what the sequential engine streams; prefix caching off gives the same."""
    base = [0, 1, 2, 3, 4, 5, 6] * 2 + [0, 1, 2]
    prompts = [base + [3, 4], base + [5, 6, 0], base[:16] + [1]]
    outs = {}
    for prefix_cache in (True, False):
        cb = make_paged(n_slots=1, prefix_cache=prefix_cache)
        reqs = [cb.submit(p, max_new_tokens=10) for p in prompts]
        cb.run_until_idle()
        outs[prefix_cache] = [toks(drain(r)) for r in reqs]
        hits = cb.allocator.stats["prefix_hits"]
        assert hits == (4 if prefix_cache else 0)   # two blocks each, twice
    assert outs[True] == outs[False] == [toks(sequential(cb.engine, p, 10)) for p in prompts]


def test_pool_starvation_finishes_gracefully_then_recovers():
    """Five usable blocks of 8 for two 40-token streams: requests end early
    (FINISHED_BY_REACHING_SEQ_LEN) with a prefix of the sequential stream,
    FIFO admission waits for frees, and every block comes back."""
    cb = make_paged(n_slots=2, n_blocks=6, prefix_cache=False)
    eng = cb.engine
    reqs = [cb.submit(p) for p in (PROMPTS[1], PROMPTS[3], PROMPTS[0])]
    cb.run_until_idle()
    for r, p in zip(reqs, (PROMPTS[1], PROMPTS[3], PROMPTS[0])):
        got = drain(r)
        want = sequential(eng, p)
        assert got and toks(got) == toks(want[:len(got)]) and len(got) < len(want)
        assert got[-1][0] == GenerationState.FINISHED_BY_REACHING_SEQ_LEN
    assert cb.allocator.available == 5
    late = cb.submit(PROMPTS[2], max_new_tokens=8)
    cb.run_until_idle()
    assert toks(drain(late)) == toks(sequential(eng, PROMPTS[2], 8))


def test_submit_refuses_a_prompt_the_pool_never_holds():
    cb = make_paged(n_blocks=3)
    with pytest.raises(ValueError, match="KV blocks"):
        cb.submit([1] * 17)                  # needs 3 blocks, the pool has 2
    cb.submit([1] * 15)


@pytest.mark.parametrize("quantum", [2, 3])
def test_paged_step_quantum_matches_sequential(quantum):
    cb = make_paged(step_quantum=quantum)
    caps = (5, 40, 7, 1, 12)
    reqs = [cb.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, caps)]
    cb.run_until_idle()
    for r, p, n in zip(reqs, PROMPTS, caps):
        assert toks(drain(r)) == toks(sequential(cb.engine, p, n))


def test_cancel_releases_slot_and_blocks():
    cb = make_paged(n_slots=1, prefix_cache=False)
    req = cb.submit(PROMPTS[1])
    for _ in range(5):
        cb.step()
    assert cb.allocator.available < cb.allocator.n_blocks - 1
    req.cancel()
    cb.run_until_idle()
    got = drain(req)
    assert 0 < len(got) < len(sequential(cb.engine, PROMPTS[1]))
    assert cb.allocator.available == cb.allocator.n_blocks - 1
    assert (cb.tables == paged.TRASH_BLOCK).all()


def test_default_attention_rule():
    """By default bf16 pools take K6 on a card whose model fits the kernels;
    int8 pools and the CPU take the gather path (the JAX package's rule)."""
    def engine(device, kv, viable=True, impl="auto"):
        return types.SimpleNamespace(
            device=torch.device(device), _kernels_viable=lambda: viable,
            args=types.SimpleNamespace(kv_cache_dtype=kv, attn_impl=impl))

    assert default_attn_impl(engine("cuda", "bf16")) == "flash"
    # a forced engine forces the pool's path: K6's int8 mode with "flash"
    assert default_attn_impl(engine("cuda", "int8", impl="flash")) == "flash"
    assert default_attn_impl(engine("cuda", "bf16", impl="plain")) == "plain"
    assert default_attn_impl(engine("cpu", "bf16", impl="flash_folded")) == "flash"
    assert default_attn_impl(engine("cuda", "int8")) == "plain"
    assert default_attn_impl(engine("cuda", "bf16", viable=False)) == "plain"
    assert default_attn_impl(engine("cpu", "bf16")) == "plain"
    with pytest.raises(ValueError, match="attn_impl"):
        make_paged(attn_impl="pallas")


# ------------------------------------------------------ spans and counters

@pytest.mark.parametrize("speculate_k", [0, 2])
def test_spans_and_counters_of_the_paged_batcher(speculate_k):
    """Requests sharing a 20-token system prompt: the later ones revive its
    two whole blocks, which ``prefill_cached_tokens`` counts; prefill rows
    plus padding equal the block-rounded buckets the test computes; every
    request's spans and the steps' children check out
    (tests/test_torch_profiling.py), and ``rows_stepped`` is the test's own
    count of live rows."""
    from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    from tests.test_torch_continuous import SEQ_LEN, counting_dispatch
    from tests.test_torch_profiling import check_batcher_spans

    system = [0, 1, 2, 3, 4, 5, 6] * 2 + [0, 1, 2, 3, 4, 5]
    prompts = [system + [3, 4], system + [5, 6, 0], system + [1] * 9, PROMPTS[1]]
    cb = make_paged(n_slots=2, speculate_k=speculate_k)
    live = counting_dispatch(cb)
    t0 = time.perf_counter_ns()
    first = cb.submit(prompts[0], max_new_tokens=6)
    cb.step()                                       # the system prompt is resident
    reqs = [first] + [cb.submit(p, max_new_tokens=n) for p, n in zip(prompts[1:], (9, 4, 7))]
    cb.run_until_idle()
    for r in reqs:
        drain(r)
    spans = SPANS.between(t0, time.perf_counter_ns() + 1)
    steps = check_batcher_spans(spans, reqs)
    cached = [0, 16, 16, 0]                         # the system prompt's whole blocks
    buckets = [min(-(-prefill_bucket(len(p) - c, SEQ_LEN) // BS) * BS, SEQ_LEN)
               for p, c in zip(prompts, cached)]
    assert cb.prefill_cached_tokens == sum(cached)
    assert cb.prefill_tokens == sum(len(p) - c for p, c in zip(prompts, cached))
    assert cb.prefill_tokens + cb.prefill_padded_tokens == sum(buckets)
    counts = [sp[5] or {"rows": 0, "steps": 0} for sp in steps]
    assert cb.rows_stepped == sum(live) == sum(c["rows"] for c in counts)
    assert cb.decode_steps == sum(c["steps"] for c in counts)
    assert cb.keys_stepped == sum(c.get("keys", 0) for c in counts) > 0
    assert cb.free_keys_stepped == sum(c.get("free_keys", 0) for c in counts)
    # the CPU runs the step graph's body eagerly: no step is graphed
    assert cb.graph_steps == 0 and all(c["graphed"] == 0 for c in counts if c["steps"])
    admits = {sp[3]: sp[5] for sp in spans if sp[0] == "batcher.admit"}
    for r, c, b, p in zip(reqs, cached, buckets, prompts):
        assert admits[r.rid] == {"prompt": len(p), "cached": c, "computed": len(p) - c,
                                 "padded": b - len(p) + c, "flash": 0}
    assert cb.admissions == 4 and cb.admission_stalls == 0


def test_a_pool_starved_admission_stays_queued():
    """Two blocks for two requests that need two each: the second waits
    for the first's blocks. Its stalled attempts are counted and spanned
    (``stalled``); its queue wait runs to the attempt that seats it."""
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS
    from tests.test_torch_profiling import check_batcher_spans

    cb = make_paged(n_slots=2, n_blocks=3, prefix_cache=False)
    t0 = time.perf_counter_ns()
    reqs = [cb.submit([1] * 9, max_new_tokens=3), cb.submit([2] * 9, max_new_tokens=3)]
    cb.run_until_idle()
    for r in reqs:
        drain(r)
    spans = SPANS.between(t0, time.perf_counter_ns() + 1)
    check_batcher_spans(spans, reqs)
    stalled = [sp for sp in spans if sp[0] == "batcher.admit" and sp[3] == reqs[1].rid
               and sp[5].get("stalled")]
    assert cb.admission_stalls == len(stalled) > 0 and cb.admissions == 2
    queued = next(sp for sp in spans if sp[0] == "request.queued" and sp[3] == reqs[1].rid)
    assert queued[2] > max(sp[2] for sp in stalled)


# ------------------------------------------------------------ step graph

@pytest.mark.parametrize("quantum", [1, 2])
def test_the_plain_paged_step_runs_on_the_static_buffers(quantum):
    """The paged batcher's step graph (its body on the CPU) against
    ``paged_decode_step`` called directly, over random weights
    (tests/test_torch_continuous.py's ``step_graph_checks``): requests join
    mid-flight and leave, greedy and sampled rows mix, rows grow blocks
    across block boundaries, and a pool of 9 blocks runs dry, forcing a
    request to finish; the static tables equal the host's after each
    dispatch; no step is graphed on the CPU."""
    from tests.test_torch_continuous import random_engine, step_graph_checks

    cb = PagedBatcher(random_engine(), n_slots=3, n_blocks=10, block_size=BS,
                      prefix_cache=False, step_quantum=quantum)
    params, cfg, pool = cb.engine.model.params, cb.cfg, cb.pool

    def eager(feed, positions, tables):
        return paged.paged_decode_step(params, cfg, feed, positions, pool, tables,
                                       cb.attn_impl)[0]

    check = step_graph_checks(cb, eager)
    reqs = [cb.submit(PROMPTS[1], max_new_tokens=40),
            cb.submit(PROMPTS[0], max_new_tokens=6, temperature=1.2, seed=42)]
    for _ in range(4):
        cb.step()
    reqs += [cb.submit(PROMPTS[3], max_new_tokens=30, temperature=0.9, top_k=40, seed=7),
             cb.submit(PROMPTS[2], max_new_tokens=9)]
    cb.run_until_idle()
    streams = {r.rid: toks(drain(r)) for r in reqs}
    n, forced = check(streams)
    assert n == cb.decode_steps and cb.graph_steps == 0
    short = [len(streams[r.rid]) < r.max_new_tokens for r in reqs]
    assert forced > 0 and any(short)
    assert cb.allocator.available == cb.allocator.n_blocks - 1


# ------------------------------------------------- a free slot's position

@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_paged_live_rows_are_bit_equal_with_free_rows_held_or_climbing(impl):
    """The paged step over random weights, on the gather path and on K6's
    plain version (tests/test_torch_continuous.py's
    ``assert_live_rows_bit_equal``): a free row's all-trash table walked to
    its climbing position or to 0 changes no live row's logits."""
    from tests.test_torch_continuous import assert_live_rows_bit_equal, random_engine

    assert_live_rows_bit_equal(lambda: PagedBatcher(
        random_engine(), n_slots=4, block_size=BS, prefix_cache=False, attn_impl=impl))


@pytest.mark.parametrize("quantum,speculate_k", [(1, 0), (3, 0), (1, 2)])
def test_a_free_paged_slot_is_fed_position_0(quantum, speculate_k):
    """The paged batcher's plain steps, quanta of 3 and verifies feed a free
    slot position 0 (tests/test_torch_continuous.py's
    ``assert_free_slots_fed_0``); its table stays all trash."""
    from tests.test_torch_continuous import assert_free_slots_fed_0

    cb = make_paged(n_slots=3, step_quantum=quantum, speculate_k=speculate_k)
    assert_free_slots_fed_0(cb, speculate_k)
    assert (cb.tables == paged.TRASH_BLOCK).all() and not cb._pos.any()


@pytest.mark.parametrize("impl,quantum", [("plain", 1), ("flash", 1), ("flash", 3)])
def test_a_paged_request_seated_after_a_release_in_flight_streams_as_alone(impl, quantum):
    """The paged batcher over random weights (tests/test_torch_continuous.py's
    ``seated_after_a_release``): blocks freed with quanta in flight and
    taken again by the next request, the trash block's position-0 writes,
    never reach it."""
    from tests.test_torch_continuous import random_engine, seated_after_a_release

    seated_after_a_release(lambda: PagedBatcher(
        random_engine(), n_slots=2, block_size=BS, prefix_cache=False, attn_impl=impl,
        step_quantum=quantum))


def test_paged_keys_and_free_keys_on_a_hand_counted_schedule():
    """The dense batcher's hand count (tests/test_torch_continuous.py's
    ``hand_counted_keys``) holds for the pool: 105 keys, 20 free."""
    from tests.test_torch_continuous import hand_counted_keys

    hand_counted_keys(make_paged(n_slots=3, step_quantum=2))


# ------------------------------------------------ the admission prefill on K1

# head_dim 128 and G = 4: the shape K1 takes
K1_SPEC = dict(dim=512, n_layers=2, n_heads=4, n_kv_heads=1, vocab_size=512,
               multiple_of=32, norm_eps=1e-5, max_sequence_length=256)
K1_BS = 32
K1_TABLE = [3, 7, 2, 9, 11, 4, 5, 6]


@pytest.fixture(scope="module")
def k1_model():
    from llama_nuts_and_bolts_tpu_torch.models.llama import init_random_params

    cfg = ModelArgs(**K1_SPEC)
    return cfg, init_random_params(cfg, seed=5, device="cpu")


def k1_pool(cfg, kv):
    return paged.PagedKVPool.create(cfg, 12, K1_BS, torch.int8 if kv == "int8" else
                                    torch.bfloat16, device="cpu")


def assert_prefill_paths_agree(got, want, pool_got, pool_want):
    """Logits within the bf16 drift bar the K1-versus-plain model tests use
    (tests/test_torch_model.py); layer 0 of the pool bit-equal (its rows are
    projected before any attention), the later layers' rows within the same
    bar (they follow the earlier layers' attention), nothing else written."""
    compare_tensor(got.numpy(), want.numpy(), "bfloat16", tolerance_multiplier=5.0)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(pool_got, name), getattr(pool_want, name)
        if a is None:
            continue
        assert torch.equal(a[0], b[0]), name
        written = [t.reshape(t.shape[0], t.shape[1], -1).ne(0).any(-1) for t in (a, b)]
        assert torch.equal(*written), name
    for name in ("k", "v"):
        compare_tensor(pool_values(pool_got, name, port_np), pool_values(pool_want, name, port_np),
                       "bfloat16", tolerance_multiplier=5.0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("bucket", [32, 64, 256])
def test_paged_prefill_on_k1_matches_plain(k1_model, bucket, kv):
    """A fresh prompt of ``bucket - 3`` tokens padded to its bucket: K1 from
    position 0 over the bucket's rows (an int8 pool's dequantized ones)
    against the fp32 oracle, one key tile or several."""
    cfg, params = k1_model
    n = bucket - 3
    tokens = torch.zeros((1, bucket), dtype=torch.int32)
    tokens[0, :n] = torch.from_numpy(np.random.default_rng(bucket).integers(0, 512, n))
    table = torch.tensor(K1_TABLE, dtype=torch.int32)
    want_pool, got_pool = k1_pool(cfg, kv), k1_pool(cfg, kv)
    want, _ = paged.paged_prefill(params, cfg, tokens, n - 1, want_pool, table)
    got, _ = paged.paged_prefill(params, cfg, tokens, n - 1, got_pool, table,
                                 attn_impl="flash")
    assert_prefill_paths_agree(got, want, got_pool, want_pool)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_prefill_shared_on_k1_matches_plain(k1_model, kv):
    """A prefix-cache hit: a 64-key prefix resident in the table row's first
    two blocks, a 64-row suffix bucket (60 real rows). K1 from ``start_pos``
    64 over the gathered prefix and the suffix against the oracle's masked
    gather of every table entry, and against K1's prefill of the whole
    prompt (a hit changes the summation order only)."""
    cfg, params = k1_model
    rng = np.random.default_rng(64)
    prefix = torch.from_numpy(rng.integers(0, 512, (1, 64)).astype(np.int32))
    suffix = torch.zeros((1, 64), dtype=torch.int32)
    suffix[0, :60] = torch.from_numpy(rng.integers(0, 512, 60).astype(np.int32))
    table = torch.tensor(K1_TABLE, dtype=torch.int32)
    want_pool = k1_pool(cfg, kv)
    paged.paged_prefill(params, cfg, prefix, 63, want_pool, table)
    got_pool = paged.PagedKVPool(*(x.clone() for x in want_pool.buffers()))
    want, _ = paged.paged_prefill_shared(params, cfg, suffix, 64, 59, want_pool, table)
    got, _ = paged.paged_prefill_shared(params, cfg, suffix, 64, 59, got_pool, table,
                                        attn_impl="flash")
    assert_prefill_paths_agree(got, want, got_pool, want_pool)
    whole = torch.zeros((1, 128), dtype=torch.int32)
    whole[0, :124] = torch.cat([prefix, suffix[:, :60]], dim=1)
    fresh, _ = paged.paged_prefill(params, cfg, whole, 123, k1_pool(cfg, kv), table,
                                   attn_impl="flash")
    compare_tensor(got.numpy(), fresh.numpy(), "bfloat16", tolerance_multiplier=5.0)


def k1_engine():
    from llama_nuts_and_bolts_tpu_torch.models.llama import init_random_params
    from llama_nuts_and_bolts_tpu_torch.models.llama.loader import LoadedModel
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from tests.test_torch_engine import tokenizers

    ranks, vocab, _ = tokenizers()
    vocab.stop_token_ids.clear()                     # requests run to their caps
    cfg = ModelArgs(**K1_SPEC)
    model = LoadedModel(params=init_random_params(cfg, seed=9, device="cpu"), cfg=cfg,
                        vocab=vocab, mergeable_ranks=ranks, tensor_meta={})
    return InferenceEngine(model, InferenceArgs(sequence_length=256), device="cpu")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_a_batcher_forced_to_flash_prefills_on_k1(kv):
    """Random weights at head_dim 128, where attention decides the tokens:
    a batcher forced to ``"flash"`` (K1 in the admissions, K6 in the steps)
    streams the greedy tokens of one on ``"plain"``, through fresh prompts
    and prefix-cache hits on a 70-token system prompt; each seated
    admission's ``batcher.admit`` span counts ``flash``, and
    ``prefill_flash`` counts them."""
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS

    rng = np.random.default_rng(70)
    system = rng.integers(0, 256, 70).tolist()
    prompts = [system + [1, 2], system + rng.integers(0, 256, 40).tolist(),
               rng.integers(0, 256, 100).tolist(), [5, 6, 7]]
    engine = k1_engine()
    if kv == "int8":
        engine.args.kv_cache_dtype = "int8"
    streams, counts = {}, {}
    for impl in ("plain", "flash"):
        cb = PagedBatcher(engine, n_slots=2, block_size=K1_BS, attn_impl=impl)
        assert cb.pool.quantized == (kv == "int8")
        t0 = time.perf_counter_ns()
        first = cb.submit(prompts[0], max_new_tokens=6)
        cb.step()                                   # the system prompt is resident
        reqs = [first] + [cb.submit(p, max_new_tokens=8) for p in prompts[1:]]
        cb.run_until_idle()
        streams[impl] = [toks(drain(r)) for r in reqs]
        admits = {sp[3]: sp[5] for sp in SPANS.between(t0, time.perf_counter_ns() + 1)
                  if sp[0] == "batcher.admit"}
        counts[impl] = [admits[r.rid]["flash"] for r in reqs]
        assert cb.prefill_flash == sum(counts[impl]) and cb.admissions == len(reqs)
        assert cb.allocator.stats["prefix_hits"] == 2    # the second's two blocks
    assert streams["flash"] == streams["plain"]
    assert all(len(s) in (6, 8) for s in streams["flash"])
    assert counts == {"plain": [0] * 4, "flash": [1] * 4}


def test_a_narrower_model_forced_to_flash_prefills_plainly():
    """K1 takes head_dim 128 only: on the tests' head_dim-16 model a batcher
    forced to ``"flash"`` runs K6's plain version in its steps and the plain
    prefill, and its admissions count no ``flash``."""
    cb = make_paged(attn_impl="flash")
    req = cb.submit(PROMPTS[1], max_new_tokens=4)
    cb.run_until_idle()
    assert toks(drain(req)) == toks(sequential(cb.engine, PROMPTS[1], 4))
    assert cb.attn_impl == "flash" and cb.prefill_flash == 0 and cb.admissions == 1


def test_tp2_paged_prefill_on_k1_matches_the_whole_model():
    """Two gloo ranks, each with half the heads (4 / 1 of 8 / 2):
    ``paged_prefill`` and a prefix-cache hit's ``paged_prefill_shared`` on
    K1 through ``tp_flash_gqa_attention`` (its plain version) against the
    whole model's plain prefill (``tests/tp_workers.py``'s tp prefill case,
    the card test's)."""
    import tempfile
    from pathlib import Path

    from tests.tp_workers import TP_PREFILL, TP_SHARED, spawn, tp_prefill_case, tp_prefills

    cfg, params, prompt, suffix, table = tp_prefill_case("cpu")
    want = tp_prefills(params, cfg, paged.PagedKVPool.create(cfg, 17, 32, device="cpu"),
                       prompt, suffix, table)
    calls = [("prefill", dict(tokens=prompt, logits_at=TP_PREFILL - 1, table_row=table,
                              attn_impl="flash")),
             ("shared", dict(tokens=suffix, shared_len=TP_SHARED, logits_at=suffix.shape[1] - 4,
                             table_row=table, attn_impl="flash"))]
    case = dict(params=params, cfg=cfg, n_blocks=17, bs=32, dtype=torch.bfloat16, calls=calls)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn({"paged": {"k1": case}}, 2, Path(tmp))
    for r in ranks:
        for got, w in zip(r["paged"]["k1"], want):
            compare_tensor(got.numpy(), w.numpy(), "bfloat16", tolerance_multiplier=5.0)
