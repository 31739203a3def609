"""Decode kernels K3 and K4 of the PyTorch port on the CPU: their plain
versions (what the wrappers run for CPU tensors) against the JAX package's
Pallas kernels in interpret mode, on the same seeded numpy inputs, with a
stacked cache, ``layer=``, per-row positions and the JAX tile; the tile-size
rule; the int8-dot math against ``quant_attn_math``. The CUDA kernels are held
against the plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.kernels import quant_attn_math as jmath
from llama_nuts_and_bolts_tpu.kernels.decode_attention import (
    flash_decode_attention as jax_flash_decode_attention,
)

from llama_nuts_and_bolts_tpu_torch.kernels import decode_attention as dk
from llama_nuts_and_bolts_tpu_torch.kernels import k4_clusters, k4_timeline
from llama_nuts_and_bolts_tpu_torch.kernels import quant_attn_math as math8
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import (
    tensor_from_numpy,
    tensor_to_numpy,
)
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor

D = 128


def bf16(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(ml_dtypes.bfloat16)


def t(a):
    return tensor_from_numpy(a, "cpu")


def int8_cache(rng, shape):
    """An int8 cache quantized per row as the model writes it, with its bf16
    scales (the scale is stored rounded, the rows divided by the fp32 one)."""
    f = rng.standard_normal(shape).astype(np.float32)
    s = np.maximum(np.abs(f).max(-1), 1e-8) / np.float32(127.0)
    q = np.clip(np.rint(f / s[..., None]), -127, 127).astype(np.int8)
    return q, s.astype(ml_dtypes.bfloat16)


def assert_int8_dots_close(got, want):
    """The int8-dot mode runs the same integer dots and the same fp32 scale
    folds on both sides, so the bf16 outputs may differ only where an fp32
    sum summed in another order rounds to the neighbouring bf16: at most one
    bf16 ulp per element (2^-7 relative), and 1e-3 relative L2 per output row.
    A key dropped from a 256-key row moves it by several percent."""
    got = got.float().numpy().reshape(-1, D)
    want = np.asarray(want, np.float32).reshape(-1, D)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    rel = np.linalg.norm(got - want, axis=-1) / np.maximum(np.linalg.norm(want, axis=-1), 1e-30)
    assert rel.max() <= 1e-3, rel.max()


def counts():
    return (dk.flash_decode_attention.launches, dk.flash_decode_attention_q8.launches,
            dk.flash_decode_attention_int8_mxu.launches)


@pytest.mark.parametrize("T,KV,quantized,want", [
    (4096, 8, True, 2048), (8192, 8, True, 2048), (4096, 8, False, 1024),
    (256, 8, True, 256), (256, 8, False, 256), (2048, 2, False, 2048),
    (640, 8, True, 128), (200, 8, True, 200)])
def test_decode_block_k_rule(T, KV, quantized, want):
    """The model's tile choice then the folded kernel's 2 MB rule
    (models/llama/model.py:204-211, kernels/decode_attention.py:311-339)."""
    assert dk.decode_block_k(T, KV, D, quantized) == want
    # an explicit block_k takes only the kernel's part, as the JAX wrapper
    assert dk.decode_block_k(4096, 8, D, True, block_k=512) == 512
    assert dk.decode_block_k(4096, 8, D, False, block_k=4096) == 1024
    with pytest.raises(ValueError, match="divisible by 128"):
        dk.decode_block_k(5000, 8, D, True)
    with pytest.raises(ValueError, match="multiple of block_k"):
        dk.decode_block_k(1000, 8, D, True, block_k=512)


def test_quant_attn_math_matches_jax():
    """quantize_q_rows, int8_scores and int8_pv against the JAX package's on
    the same inputs: the int8 bytes equal, the fp32 results equal up to the
    order of fp32 products (one rounding)."""
    rng = np.random.default_rng(0)
    G, bk = 4, 64
    q = bf16(rng, G, D)
    q[1] = 0                                           # an all-zero row: eps scale
    kq, ks = int8_cache(rng, (bk, D))
    vq, vs = int8_cache(rng, (bk, D))
    q_i, qs = math8.quantize_q_rows(t(q))
    jq_i, jqs = jmath.quantize_q_rows(jnp.asarray(q))
    np.testing.assert_array_equal(tensor_to_numpy(q_i), np.asarray(jq_i))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(jqs))
    scale = 1.0 / np.sqrt(D)
    ks32, vs32 = ks.astype(np.float32), vs.astype(np.float32)
    s = math8.int8_scores(q_i, qs, t(kq), torch.from_numpy(ks32), scale)
    js = jmath.int8_scores(jq_i, jqs, jnp.asarray(kq), jnp.asarray(ks32), scale)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    p = torch.softmax(s, -1)
    pv = math8.int8_pv(p, t(vq), torch.from_numpy(vs32))
    jpv = jmath.int8_pv(jnp.asarray(p.numpy()), jnp.asarray(vq), jnp.asarray(vs32))
    compare_tensor(pv.numpy(), np.asarray(jpv), "float32")


def stacked_case(seed, quantized, L=3, B=3, H=8, KV=2, T=256):
    rng = np.random.default_rng(seed)
    q = bf16(rng, B, 1, H, D)
    if not quantized:
        return q, bf16(rng, L, B, KV, T, D), bf16(rng, L, B, KV, T, D), None, None
    k, ks = int8_cache(rng, (L, B, KV, T, D))
    v, vs = int8_cache(rng, (L, B, KV, T, D))
    return q, k, v, ks, vs


# per-row positions: inside the first tile, on a tile edge, the last slot
POSITIONS = np.array([5, 127, 255], np.int32)


@pytest.mark.parametrize("mode", ["bf16", "int8_dequant", "int8_mxu"])
def test_k4_plain_matches_pallas_interpret(mode):
    """flash_decode_attention(fold_heads=True) in each of its three modes, a
    stacked [L,B,KV,T,D] cache read at layer 1 with per-row positions and
    the JAX tile (block_k 128: two tiles), against the Pallas kernel in
    interpret mode. The bf16 and int8-dequant modes here run K2's/K3's
    64-key tiles, so their fp32 sums come in another order: bf16 tolerance.
    The int8-dot mode runs the JAX tile's own arithmetic: one bf16 ulp."""
    quantized = mode != "bf16"
    q, k, v, ks, vs = stacked_case(1, quantized)
    mxu = mode == "int8_mxu"
    scales = {} if not quantized else {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
    want = jax_flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(POSITIONS),
        block_k=128, layer=1, fold_heads=True, int8_mxu=mxu, interpret=True, **scales)
    before = counts()
    tscales = {} if not quantized else {"k_scale": t(ks), "v_scale": t(vs)}
    got = dk.flash_decode_attention(t(q), t(k), t(v), torch.from_numpy(POSITIONS),
                                    layer=1, fold_heads=True, int8_mxu=mxu,
                                    block_k=128, **tscales)
    assert counts() == before                          # CPU: no kernel launch
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    if mxu:
        assert_int8_dots_close(got, want)
    else:
        compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")


def test_k4_int8_mxu_plain_follows_the_jax_tile():
    """The int8-dot mode's numerics depend on the tile (p is quantized per
    row over a whole tile): with the tile the model picks (decode_block_k),
    the plain version matches the Pallas kernel far more closely than the
    difference between two tile sizes."""
    q, k, v, ks, vs = stacked_case(2, True, L=1, B=2, T=512)
    pos = np.array([300, 511], np.int32)
    bk = dk.decode_block_k(512, 2, D, True)
    assert bk == 512
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), layer=0,
               fold_heads=True, int8_mxu=True, interpret=True)
    want = np.asarray(jax_flash_decode_attention(*args, block_k=bk, **jkw), np.float32)
    got = dk.flash_decode_attention(t(q), t(k), t(v), torch.from_numpy(pos),
                                    k_scale=t(ks), v_scale=t(vs), layer=0,
                                    fold_heads=True, int8_mxu=True)   # the model's tile
    small = dk.flash_decode_attention(t(q), t(k), t(v), torch.from_numpy(pos),
                                      k_scale=t(ks), v_scale=t(vs), layer=0,
                                      fold_heads=True, int8_mxu=True, block_k=128)
    err = np.abs(got.float().numpy() - want).max()
    err_small = np.abs(small.float().numpy() - want).max()
    assert_int8_dots_close(got, want)
    assert err < err_small


@pytest.mark.parametrize("T,positions,block_k", [
    (256, POSITIONS, 64),
    # 128-key splits (K2's partition): one active split, a split's last key,
    # the next split's first key, all 8 splits combined
    (1024, np.array([5, 127, 128, 1023], np.int32), 256)])
def test_k3_plain_matches_pallas_interpret(T, positions, block_k):
    """The fold_heads=False int8 call (K3: _decode_kernel_blocked on an int8
    cache), stacked cache at layer 2, per-row positions, on K2's split key
    walk and combine; and the 4-D single-layer form."""
    q, k, v, ks, vs = stacked_case(3, True, B=len(positions), T=T)
    assert dk.k2_split_k(len(positions), 2, T) == 128
    want = jax_flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), block_k=block_k, layer=2,
        interpret=True)
    before = counts()
    got = dk.flash_decode_attention(t(q), t(k), t(v), torch.from_numpy(positions),
                                    k_scale=t(ks), v_scale=t(vs), layer=2)
    assert counts() == before
    compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")
    one = dk.flash_decode_attention(t(q), t(k[2]), t(v[2]), torch.from_numpy(positions),
                                    k_scale=t(ks[2]), v_scale=t(vs[2]))
    assert torch.equal(one, got)
    # the plain version reads the dequantized tiles: the same function as
    # the bf16 cache bf16(bf16(int8) * scale)
    deq = lambda c, s: (c.astype(np.float32) * s.astype(np.float32)[..., None]).astype(  # noqa: E731
        ml_dtypes.bfloat16)
    ref = dk.flash_decode_attention(t(q), t(deq(k, ks)), t(deq(v, vs)),
                                    torch.from_numpy(positions), layer=2)
    assert torch.equal(ref, got)


# n_keys of a row: the first key, around 16-key chunks, around the tile
# edge, a ragged middle, a full cache
def k4_rows(T, bk):
    return sorted({n for n in (1, 2, 15, 16, 17, 33, bk - 1, bk, bk + 1, T // 2 + 3, T)
                   if 1 <= n <= T})


@pytest.mark.parametrize("B", [1, 2, 4, 16])
@pytest.mark.parametrize("T", [256, 1024, 2048, 4096, 8192])
def test_k4_cluster_geometry(T, B):
    """K4's cluster rule and partition at the shapes the paths use (KV = 8,
    the JAX tile): a cluster of at most 8 (16 only when forced), the
    smallest that reaches 64 blocks with 256 keys a rank; a grid of one
    cluster per (KV head, row); every visible key of a tile read by exactly
    one rank, in order; every bulk copy a whole number of 16-byte units
    from a 16-byte aligned offset."""
    KV = 8
    bk = dk.decode_block_k(T, KV, D, True)
    C = dk.k4_cluster(B, KV, T, bk)
    geo = dk.k4_geometry(B, KV, T, bk)
    assert geo.cluster == C and C in (1, 2, 4, 8)
    assert geo.grid == (C, KV, B)
    assert C * geo.chunk == bk and geo.chunk % 8 == 0
    assert C == 1 or geo.chunk >= dk.K4_RULE_CHUNK
    if C > 1:                                  # no smaller cluster would do
        assert (C // 2) * B * KV < dk.K4_TARGET_BLOCKS
    if C < dk.K4_MAX_CLUSTER and bk // (2 * C) >= dk.K4_RULE_CHUNK:
        assert C * B * KV >= dk.K4_TARGET_BLOCKS
    for n_keys in k4_rows(T, bk):
        for t0 in range(0, n_keys, bk):        # every tile the row reaches
            owned = []
            for r in range(C):
                start, end = geo.rank_keys(n_keys, t0, r)
                owned += range(start, end)
                copies = geo.copies(n_keys, t0, r)
                k_part, v_part = copies[:len(copies) // 2], copies[len(copies) // 2:]
                for part in (k_part, v_part):  # k pieces, then v pieces: the rank's keys
                    got = [key + i for key, rows, _ in part for i in range(rows // D)]
                    assert got == list(range(start, end))
                for key, rows, scale_bytes in copies:
                    assert rows % 16 == 0 and scale_bytes % 16 == 0
                    assert (key * 2) % 16 == 0 and rows <= geo.piece * D
                    assert scale_bytes // 4 <= geo.piece      # rounded within the piece
                assert all(sb > 0 for _, _, sb in k_part) and all(
                    sb == 0 for _, _, sb in v_part)
            assert owned == list(range(t0, min(t0 + bk, n_keys)))
            active = geo.active_ranks(n_keys, t0)   # the ranks that hold keys, a prefix
            assert all((geo.rank_keys(n_keys, t0, r)[1] > geo.rank_keys(n_keys, t0, r)[0])
                       == (r < active) for r in range(C))


@pytest.mark.parametrize("cluster,ok", [(1, True), (2, True), (8, True), (16, True),
                                        (3, False), (32, False)])
def test_k4_forced_cluster_sizes(cluster, ok):
    """A forced cluster: the sizes the kernel is built for, 16 included
    (the rule never picks it), and the chunks it can cut: whole 8-key units,
    at least 16 keys once the tile is split."""
    if ok:
        geo = dk.k4_geometry(1, 8, 256, 256, cluster)
        assert geo.grid == (cluster, 8, 1) and geo.chunk == 256 // cluster
    else:
        with pytest.raises(ValueError, match="cluster"):
            dk.k4_geometry(1, 8, 256, 256, cluster)
    assert not dk.k4_cluster_takes(64, 8)          # 8-key chunks
    assert not dk.k4_cluster_takes(200, 2)         # 100-key chunks: not 8-key units
    assert dk.k4_cluster_takes(200, 1)
    assert dk.k4_cluster(1, 8, 8192, 2048) == 8 and dk.k4_cluster(16, 8, 8192, 2048) == 1


@pytest.mark.parametrize("shape", sorted(k4_clusters.SHAPES))
def test_k4_clusters_times_sizes_the_kernel_takes(shape):
    """The sweep times the rule's cluster, half and twice it and 8, each one
    the kernel can cut the shape's tile over."""
    T, _ = k4_clusters.SHAPES[shape]
    bk = dk.decode_block_k(T, 8, D, True)
    tried = k4_clusters.clusters_tried(1, T)
    assert dk.k4_cluster(1, 8, T, bk) in tried and dk.K4_MAX_CLUSTER in tried
    assert all(dk.k4_cluster_takes(bk, c) for c in tried)


def test_k4_timeline_stamps_apply_to_the_kernel_source():
    """Every stamp k4_timeline puts into K4's source finds the text it goes
    beside exactly once, and a phase name for every stamp it writes."""
    src = (k4_timeline.CSRC / "decode_attention_int8.cu").read_text()
    for old, new in k4_timeline.EDITS:
        assert src.count(old) == 1 and new != old
    assert len(k4_timeline.PHASES) == k4_timeline.SLOTS
    assert k4_timeline.stamped_source().count("clock64()") == len(k4_timeline.EDITS) - 1


def test_int8_wrapper_refusals():
    q, k, v, ks, vs = stacked_case(4, True, L=1, B=1, T=64)
    q, k, v, ks, vs = t(q), t(k), t(v), t(ks), t(vs)
    with pytest.raises(ValueError, match="k_scale"):
        dk.flash_decode_attention(q, k, v, 3, layer=0)
    with pytest.raises(ValueError, match="k_scale"):
        dk.flash_decode_attention(q, k.to(torch.bfloat16), v.to(torch.bfloat16), 3,
                                  k_scale=ks, v_scale=vs, layer=0)
    with pytest.raises(ValueError, match=r"\[L,B,KV,T\]"):
        dk.flash_decode_attention(q, k, v, 3, k_scale=ks[..., :32], v_scale=vs, layer=0)
    with pytest.raises(TypeError, match="bfloat16 k_scale"):
        dk.flash_decode_attention(q, k, v, 3, k_scale=ks.float(), v_scale=vs, layer=0)
    with pytest.raises(ValueError, match="blocked=True"):   # K5 is single-layer
        dk.flash_decode_attention(q, k, v, 3, k_scale=ks, v_scale=vs, layer=0,
                                  blocked=False)
    with pytest.raises(ValueError, match="multiple of block_k"):
        dk.flash_decode_attention(q, k, v, 3, k_scale=ks, v_scale=vs, layer=0,
                                  fold_heads=True, int8_mxu=True, block_k=48)
    qm = q.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        dk.flash_decode_attention(qm, k.to("meta"), v.to("meta"), 3,
                                  k_scale=ks.to("meta"), v_scale=vs.to("meta"), layer=0)
