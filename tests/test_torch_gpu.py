"""CUDA kernels K1 to K8 of the PyTorch port against their plain versions
at Llama-3.1-8B widths (H=32, KV=8, D=128, dim 4096, ffn 14336; pool blocks
of 32 positions). Marked ``gpu``: each test skips inside its fixture when there is no
card. Imports only torch and the port, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import pytest
import torch

from llama_nuts_and_bolts_tpu_torch.kernels.attention import (
    flash_gqa_attention,
    flash_gqa_attention_plain,
)
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
    decode_block_k,
    flash_decode_attention,
    flash_decode_attention_int8_mxu,
    flash_decode_attention_int8_mxu_plain,
    flash_decode_attention_plain,
    flash_decode_attention_q8,
    flash_decode_attention_whole_head,
    k2_scratch,
    k2_split_k,
    k4_cluster,
    k4_geometry,
)
from llama_nuts_and_bolts_tpu_torch.kernels.paged_attention import (
    paged_chunk,
    paged_flash_decode,
    paged_flash_decode_int8,
    paged_flash_decode_int8_plain,
    paged_flash_decode_per_head,
    paged_flash_decode_plain,
    paged_scratch,
    paged_split,
)
from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import (
    k8_scratch,
    k8_split,
    k8_takes,
    q4_matmul,
    q4_matmul_plain,
)
from llama_nuts_and_bolts_tpu_torch.ops import quantize_kv_rows
from llama_nuts_and_bolts_tpu_torch.quant import quantize_tensor_q4

H, KV, D = 32, 8, 128
# chip_smoke.py's kernel limits: per element one bf16 ulp of the output
# (2^-7 |x|) plus fp32 summation-order noise near zero, and a relative L2
# error over the whole output
ATOL, RTOL, REL_L2 = 1e-3, 2.0 ** -7, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rand(shape, gen, device):
    return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)


# K8's fp32 output against its plain version's: the same exact products
# summed in another order, so fp32 rounding only (chip_smoke.py)
K8_ATOL, K8_RTOL, K8_REL_L2 = 1e-4, 1e-5, 1e-5


def assert_matches(got, ref, atol=ATOL, rtol=RTOL, rel_l2=REL_L2):
    got, ref = got.float(), ref.float()
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    assert float((got - ref).norm() / ref.norm()) <= rel_l2


def int8_cache(shape, gen, device):
    q, s = quantize_kv_rows(torch.randn(shape, generator=gen, device=device))
    return q, s


@pytest.mark.gpu
@pytest.mark.parametrize("S,start_pos,T", [(128, 0, 128), (77, 300, 512),
                                           (512, 0, 2048), (333, 700, 2048), (5, 50, 64)])
def test_k1_kernel_matches_plain(cuda, S, start_pos, T):
    """Full and diagonal tiles, history (start_pos > 0), a ragged S over
    several q tiles, a cache longer than start_pos + S; a cache shorter than
    one key tile and fewer rows than one q tile (the TMA boxes read past
    both ends as zeros)."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    q = rand((2, S, H, D), gen, cuda)
    k, v = rand((2, KV, T, D), gen, cuda), rand((2, KV, T, D), gen, cuda)
    before = flash_gqa_attention.launches
    got = flash_gqa_attention(q, k, v, start_pos)
    torch.cuda.synchronize()
    assert flash_gqa_attention.launches == before + 1
    ref = flash_gqa_attention_plain(q, k, v, start_pos)
    assert_matches(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("L,layer,T,positions", [
    (1, 0, 1024, [0, 1023]), (3, 2, 700, [63, 64, 699]),
    # split_k 512: a split's last key, the next split's first and second
    (2, 1, 4096, [511, 512, 513]),
    # one row at position 0, the other at T - 1 (every split combined)
    (1, 0, 8192, [0, 8191]), (2, 1, 2048, [3, 700, 2047, 1000])])
def test_k2_kernel_matches_plain(cuda, L, layer, T, positions):
    """K2's split key walk and its in-launch combine against the plain
    version's partition; a second call reuses the zeroed tickets and never
    synchronises with the host (the positions stay on the card)."""
    gen = torch.Generator(device=cuda).manual_seed(T)
    B = len(positions)
    if T == 4096:
        assert k2_split_k(B, KV, T) == 512
    q = rand((B, 1, H, D), gen, cuda)
    k, v = rand((L, B, KV, T, D), gen, cuda), rand((L, B, KV, T, D), gen, cuda)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    before = flash_decode_attention.launches
    got = flash_decode_attention(q, k, v, pos, layer=layer)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == before + 1
    ref = flash_decode_attention_plain(q, k, v, pos, layer)
    assert_matches(got, ref)
    split = k2_split_k(B, KV, T)
    _, tickets = k2_scratch(q.device, B, KV, -(-T // split))
    assert int(tickets.abs().sum()) == 0                 # reset by the combining blocks
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = flash_decode_attention(q, k, v, pos, layer=layer)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the combine runs in split order: the same bits on every call
    assert torch.equal(again, got)


@pytest.mark.gpu
def test_k2_calls_on_two_streams_keep_their_own_tickets(cuda):
    """Two streams launching K2 at one shape at once: each has its own
    partials and tickets, so neither combines the other's splits, every
    output matches the plain version and every ticket is back at zero."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    B, L, T = 2, 2, 4096
    k, v = rand((L, B, KV, T, D), gen, cuda), rand((L, B, KV, T, D), gen, cuda)
    qs = [rand((B, 1, H, D), gen, cuda) for _ in range(2)]
    pos = torch.tensor([4095, 2000], dtype=torch.int32, device=cuda)
    refs = [flash_decode_attention_plain(q, k, v, pos, 1) for q in qs]
    n_splits = -(-T // k2_split_k(B, KV, T))
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    outs, tickets = [], []
    for q, stream in zip(qs, streams):
        with torch.cuda.stream(stream):
            outs.append([flash_decode_attention(q, k, v, pos, layer=1) for _ in range(16)])
            tickets.append(k2_scratch(cuda, B, KV, n_splits)[1])
    torch.cuda.synchronize()
    assert tickets[0].data_ptr() != tickets[1].data_ptr()
    for calls, ref, t in zip(outs, refs, tickets):
        for got in calls:
            assert_matches(got, ref)
        assert int(t.abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("L,layer,T,positions", [(1, 0, 1024, [0, 1023]),
                                                 (3, 2, 4096, [63, 2048, 3000])])
def test_k3_k4_kernels_match_plain(cuda, L, layer, T, positions):
    """K3 (int8 cache, K2's tiles) and K4's int8-dot mode (the JAX tile) on
    an int8 cache, and K4's bf16 and int8-dequant modes, which launch the K2
    and K3 kernels."""
    gen = torch.Generator(device=cuda).manual_seed(T + layer)
    B = len(positions)
    q = rand((B, 1, H, D), gen, cuda)
    k, ks = int8_cache((L, B, KV, T, D), gen, cuda)
    v, vs = int8_cache((L, B, KV, T, D), gen, cuda)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    ref = flash_decode_attention_plain(q, k, v, pos, layer, ks, vs)
    before = (flash_decode_attention_q8.launches, flash_decode_attention_int8_mxu.launches)
    for fold in (False, True):                      # K3, then K4's dequant mode
        got = flash_decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs, layer=layer,
                                     fold_heads=fold)
        torch.cuda.synchronize()
        assert_matches(got, ref)
    bk = decode_block_k(T, KV, D, True)
    got = flash_decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs, layer=layer,
                                 fold_heads=True, int8_mxu=True)
    torch.cuda.synchronize()
    assert_matches(got, flash_decode_attention_int8_mxu_plain(q, k, v, ks, vs, pos,
                                                              layer, bk))
    assert (flash_decode_attention_q8.launches,
            flash_decode_attention_int8_mxu.launches) == (before[0] + 2, before[1] + 1)
    kb, vb = rand((L, B, KV, T, D), gen, cuda), rand((L, B, KV, T, D), gen, cuda)
    n2 = flash_decode_attention.launches
    got = flash_decode_attention(q, kb, vb, pos, layer=layer, fold_heads=True)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == n2 + 1
    assert_matches(got, flash_decode_attention_plain(q, kb, vb, pos, layer))


def k4_case(gen, device, L, T, positions):
    B = len(positions)
    q = rand((B, 1, H, D), gen, device)
    k, ks = int8_cache((L, B, KV, T, D), gen, device)
    v, vs = int8_cache((L, B, KV, T, D), gen, device)
    return q, k, v, ks, vs, torch.tensor(positions, dtype=torch.int32, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("L,layer,T,positions", [
    (1, 0, 256, [70]), (1, 0, 256, [134]), (1, 0, 256, [0]), (1, 0, 256, [255]),
    (2, 1, 4096, [3000]), (1, 0, 8192, [2047]), (1, 0, 8192, [8191]),
    (1, 0, 2048, [3, 700, 2047, 1000])])
def test_k4_every_cluster_size_matches_plain(cuda, cluster, L, layer, T, positions):
    """K4's int8-dot kernel forced to each cluster size the rule can pick
    (and 16), against the plain version at the JAX tile: ranks past a row's
    position (pos 70 at T=256 leaves 3 of 8 ranks with keys, pos 0 one),
    rows on a tile's last key, several tiles, mixed rows in one launch. The
    cluster moves only the fp32 order of l's sum, so the kernel limits hold."""
    gen = torch.Generator(device=cuda).manual_seed(T + cluster + positions[0])
    q, k, v, ks, vs, pos = k4_case(gen, cuda, L, T, positions)
    bk = decode_block_k(T, KV, D, True)
    geo = k4_geometry(len(positions), KV, T, bk, cluster)
    assert geo.grid == (cluster, KV, len(positions))
    before = flash_decode_attention_int8_mxu.launches
    got = flash_decode_attention_int8_mxu(q, k, v, ks, vs, pos, layer, bk, cluster)
    torch.cuda.synchronize()
    assert flash_decode_attention_int8_mxu.launches == before + 1
    assert_matches(got, flash_decode_attention_int8_mxu_plain(q, k, v, ks, vs, pos,
                                                              layer, bk))


@pytest.mark.gpu
@pytest.mark.parametrize("L,T,positions", [(2, 4096, [3000]), (1, 256, [103]),
                                           (1, 2048, [3, 700, 2047, 1000])])
def test_k4_two_calls_give_the_same_bits(cuda, L, T, positions):
    """Every float sum of the cluster kernel has a fixed order (the slots
    reduced in rank order, int32 partials added exactly), and the wrapper
    never synchronises with the host."""
    gen = torch.Generator(device=cuda).manual_seed(T + 1)
    q, k, v, ks, vs, pos = k4_case(gen, cuda, L, T, positions)
    bk = decode_block_k(T, KV, D, True)
    assert k4_cluster(len(positions), KV, T, bk) == {4096: 8, 256: 1, 2048: 2}[T]
    first = flash_decode_attention_int8_mxu(q, k, v, ks, vs, pos, L - 1, bk)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = [flash_decode_attention_int8_mxu(q, k, v, ks, vs, pos, L - 1, bk)
                 for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for got in again:
        assert torch.equal(got, first)


@pytest.mark.gpu
def test_k4_calls_on_two_streams_do_not_interfere(cuda):
    """Two streams launching K4 at B's shape at once, each on its own
    inputs: the clusters keep their exchanges in their own shared memory, so
    every output matches its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    cases = [k4_case(gen, cuda, 1, 4096, [p]) for p in (3000, 1500)]
    bk = decode_block_k(4096, KV, D, True)
    refs = [flash_decode_attention_int8_mxu_plain(*c[:5], c[5], 0, bk) for c in cases]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    outs = []
    for c, stream in zip(cases, streams):
        with torch.cuda.stream(stream):
            outs.append([flash_decode_attention_int8_mxu(*c[:5], c[5], 0, bk)
                         for _ in range(16)])
    torch.cuda.synchronize()
    for calls, ref in zip(outs, refs):
        for got in calls:
            assert_matches(got, ref)


@pytest.mark.gpu
def test_k4_refuses_a_cluster_it_cannot_cut(cuda):
    gen = torch.Generator(device=cuda).manual_seed(15)
    q, k, v, ks, vs, pos = k4_case(gen, cuda, 1, 256, [100])
    for cluster in (3, 32):                         # not a size it is built for
        with pytest.raises(ValueError, match="cluster"):
            flash_decode_attention_int8_mxu(q, k, v, ks, vs, pos, 0, 256, cluster)
    with pytest.raises(ValueError, match="cluster"):  # 8-key chunks, < 16
        flash_decode_attention_int8_mxu(q, k, v, ks, vs, pos, 0, 64, 8)


def k8_case(gen, device, rows, out_dim, in_dim):
    w = torch.randn((out_dim, in_dim), generator=gen, device=device) / in_dim ** 0.5
    qt = quantize_tensor_q4(w)
    return rand((rows, in_dim), gen, device), qt.packed, qt.scale


def k8_tickets(x, packed):
    G, out_dim, _ = packed.shape
    n_splits = -(-G // k8_split(x.shape[0], x.shape[1], out_dim, G))
    return k8_scratch(x.device, x.shape[0], out_dim, n_splits)[1]


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 3, 8, 9, 16, 17, 32])
@pytest.mark.parametrize("out_dim,in_dim", [(1024, 4096), (4096, 14336), (14336, 4096),
                                            (4096, 3584)])
def test_k8_kernel_matches_plain(cuda, rows, out_dim, in_dim):
    """Every row bucket and its edges (8, 16 and 32 rows: 1, 2 and 4 mma
    n-tiles); wk/wv's 16 tiles in 8 splits, w_down's 56 groups in 4 to 14
    splits, w_gate in one; 14 groups in splits of 3, the last of 2."""
    gen = torch.Generator(device=cuda).manual_seed(rows + out_dim)
    x, packed, scale = k8_case(gen, cuda, rows, out_dim, in_dim)
    G = packed.shape[0]
    split = k8_split(rows, in_dim, out_dim, G)
    if in_dim == 3584:
        assert (G, split) == (14, 3)
    before = q4_matmul.launches
    got = q4_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert q4_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (rows, out_dim)
    assert_matches(got, q4_matmul_plain(x, packed, scale), K8_ATOL, K8_RTOL, K8_REL_L2)
    if -(-G // split) > 1:
        assert int(k8_tickets(x, packed).abs().sum()) == 0   # reset by the combining blocks


@pytest.mark.gpu
@pytest.mark.parametrize("rows,split", [(1, 11), (1, 5), (9, 3), (32, 3)])
def test_k8_forced_splits_of_w_down(cuda, rows, split):
    """w_down's 56 groups in splits that do not divide them (the last of 1,
    1, 2 and 2 groups), against the plain version on the same partition."""
    gen = torch.Generator(device=cuda).manual_seed(rows * 7 + split)
    x, packed, scale = k8_case(gen, cuda, rows, 4096, 14336)
    assert packed.shape[0] % split
    got = q4_matmul(x, packed, scale, split)
    assert_matches(got, q4_matmul_plain(x, packed, scale, split), K8_ATOL, K8_RTOL,
                   K8_REL_L2)
    with pytest.raises(ValueError, match="split"):
        q4_matmul(x, packed, scale, 57)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,out_dim,in_dim", [(1, 4096, 14336), (32, 4096, 14336),
                                                 (1, 128256, 4096), (16, 1024, 4096)])
def test_k8_two_calls_give_the_same_bits(cuda, rows, out_dim, in_dim):
    """Splits combine in split order, never by float atomics, and the
    wrapper never synchronises with the host."""
    gen = torch.Generator(device=cuda).manual_seed(rows * 3 + out_dim)
    x, packed, scale = k8_case(gen, cuda, rows, out_dim, in_dim)
    first = q4_matmul(x, packed, scale)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = [q4_matmul(x, packed, scale) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for got in again:
        assert torch.equal(got, first)


@pytest.mark.gpu
def test_k8_calls_on_two_streams_keep_their_own_tickets(cuda):
    """Two streams launching K8 at one split shape at once: each has its own
    partials and tickets, so neither combines the other's splits, every
    output matches the plain version and every ticket is back at zero."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    x, packed, scale = k8_case(gen, cuda, 4, 4096, 14336)
    xs = [x, rand((4, 14336), gen, cuda)]
    refs = [q4_matmul_plain(x, packed, scale) for x in xs]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    outs, tickets = [], []
    for x, stream in zip(xs, streams):
        with torch.cuda.stream(stream):
            outs.append([q4_matmul(x, packed, scale) for _ in range(16)])
            tickets.append(k8_tickets(x, packed))
    torch.cuda.synchronize()
    assert tickets[0].data_ptr() != tickets[1].data_ptr()
    for calls, ref, t in zip(outs, refs, tickets):
        for got in calls:
            assert_matches(got, ref, K8_ATOL, K8_RTOL, K8_REL_L2)
        assert int(t.abs().sum()) == 0


@pytest.mark.gpu
def test_auto_sends_other_gqa_shapes_to_the_plain_path(cuda):
    """A Llama-3.2-3B-shaped model (head_dim 128, G = 3), tiny: the
    attention kernels are built for G = 4 only, so ``auto`` generates on the
    plain path, no attention kernel launched, where it once raised."""
    from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import init_random_params
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.tokenizer import TiktokenModel, Vocabulary
    from llama_nuts_and_bolts_tpu_torch.tokenizer.tiktoken_io import build_special_tokens

    ranks = {bytes([i]): i for i in range(256)}
    special = build_special_tokens(len(ranks))
    vocab = Vocabulary.from_tiktoken(TiktokenModel(
        mergeable_ranks=ranks, special_tokens=special, bos_id=special["<|begin_of_text|>"],
        eos_id=special["<|end_of_text|>"],
        stop_token_ids=[special["<|eom_id|>"], special["<|eot_id|>"]]))
    cfg = ModelArgs(dim=768, n_layers=2, n_heads=6, n_kv_heads=2, vocab_size=512,
                    multiple_of=32, norm_eps=1e-5, max_sequence_length=256)
    assert (cfg.head_dim, cfg.n_rep) == (128, 3)
    model = LoadedModel(params=init_random_params(cfg, seed=0, device=cuda), cfg=cfg,
                        vocab=vocab, mergeable_ranks=ranks, tensor_meta={})
    engine = InferenceEngine(model, InferenceArgs(sequence_length=256), device=cuda)
    assert engine._attn_impl(1, 256) == "plain"
    kernels = (flash_gqa_attention, flash_decode_attention, flash_decode_attention_q8,
               flash_decode_attention_int8_mxu, paged_flash_decode)
    before = [k.launches for k in kernels]
    tokens = [t for _, t in engine.generate_tokens(list(range(40, 60)), max_new_tokens=8)]
    torch.cuda.synchronize()
    assert len(tokens) >= 1 and all(0 <= t < 512 for t in tokens)
    assert [k.launches for k in kernels] == before


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = rand((1, 1, H, D), gen, cuda)
    k = rand((1, 1, KV, 64, D), gen, cuda)
    with pytest.raises(ValueError, match="blocked=True"):   # K5 is single-layer
        flash_decode_attention(q, k, k, 3, layer=0, blocked=False)
    with pytest.raises(ValueError):                 # an int8 cache without scales
        flash_decode_attention(q, k.to(torch.int8), k.to(torch.int8), 3, layer=0)
    qt = quantize_tensor_q4(torch.randn((80, 512), generator=gen, device=cuda))
    with pytest.raises(ValueError, match="out"):    # out % 64
        q4_matmul(rand((1, 512), gen, cuda), qt.packed, qt.scale)
    qt = quantize_tensor_q4(torch.randn((128, 512), generator=gen, device=cuda))
    with pytest.raises(ValueError, match="rows"):   # R > 32
        q4_matmul(rand((33, 512), gen, cuda), qt.packed, qt.scale)
    with pytest.raises(TypeError):
        flash_gqa_attention(q.float(), k[0].float(), k[0].float(), 0)
    with pytest.raises(ValueError, match="G = H/KV"):      # built for G = 4 only
        flash_gqa_attention(rand((1, 4, 2 * KV, D), gen, cuda), k[0], k[0], 0)
    with pytest.raises(ValueError):
        flash_gqa_attention(q, k[0].transpose(2, 3).contiguous().transpose(2, 3),
                            k[0], 0)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True])
def test_k5_kernel_matches_plain(cuda, quantized):
    """blocked=False over a single-layer cache: K2's kernel (K3's for an int8
    cache) on a one-layer view, counted as K5."""
    gen = torch.Generator(device=cuda).manual_seed(5 + quantized)
    B, T = 3, 1024
    q = rand((B, 1, H, D), gen, cuda)
    pos = torch.tensor([0, 511, 1023], dtype=torch.int32, device=cuda)
    if quantized:
        k, ks = int8_cache((B, KV, T, D), gen, cuda)
        v, vs = int8_cache((B, KV, T, D), gen, cuda)
        scales = dict(k_scale=ks, v_scale=vs)
        ref = flash_decode_attention_plain(q, k[None], v[None], pos, 0, ks[None], vs[None])
    else:
        k, v = rand((B, KV, T, D), gen, cuda), rand((B, KV, T, D), gen, cuda)
        scales = {}
        ref = flash_decode_attention_plain(q, k[None], v[None], pos, 0)
    before = (flash_decode_attention_whole_head.launches, flash_decode_attention.launches,
              flash_decode_attention_q8.launches)
    got = flash_decode_attention(q, k, v, pos, blocked=False, **scales)
    torch.cuda.synchronize()
    assert (flash_decode_attention_whole_head.launches, flash_decode_attention.launches,
            flash_decode_attention_q8.launches) == (before[0] + 1, before[1], before[2])
    assert_matches(got, ref)


def paged_case(gen, device, B, M, n_blocks, L, positions, dtype=torch.bfloat16):
    """Pools with a seeded scatter of blocks: row b's table is a slice of one
    permutation of the pool's blocks 1..n_blocks-1 (block 0 is trash)."""
    bs = 32
    shape = (L, n_blocks, KV, bs, D)
    if dtype == torch.int8:
        pk, pks = int8_cache(shape, gen, device)
        pv, pvs = int8_cache(shape, gen, device)
    else:
        pk, pv = rand(shape, gen, device), rand(shape, gen, device)
        pks = pvs = None
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(B + M)) + 1
    tables = perm[:B * M].reshape(B, M).to(torch.int32).to(device)
    q = rand((B, 1, H, D), gen, device)
    pos = torch.tensor(positions, dtype=torch.int32, device=device)
    return q, pk, pv, pks, pvs, tables, pos


@pytest.mark.gpu
@pytest.mark.parametrize("B,M,layer,positions", [
    (1, 256, 3, [8191]), (4, 64, 0, [0, 31, 32, 2047]), (8, 16, 31, [5, 511, 100, 64,
                                                                        33, 0, 300, 480])])
def test_k6_kernel_matches_plain(cuda, B, M, layer, positions):
    """K6 on a stacked 32-layer pool at varying layers, bf16 (spans of
    paged_chunk entries) and int8 (one update per block)."""
    gen = torch.Generator(device=cuda).manual_seed(B * 100 + M)
    q, pk, pv, _, _, tables, pos = paged_case(gen, cuda, B, M, B * M + 1, 32, positions)
    before = paged_flash_decode.launches
    got = paged_flash_decode(q, pk, pv, tables, pos, layer=layer)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    assert_matches(got, paged_flash_decode_plain(q, pk, pv, tables, pos, layer,
                                                 paged_chunk(M, 32)))
    del pk, pv
    q, pk, pv, pks, pvs, tables, pos = paged_case(gen, cuda, B, M, B * M + 1, 32,
                                                  positions, torch.int8)
    before = paged_flash_decode_int8.launches
    got = paged_flash_decode(q, pk, pv, tables, pos, layer=layer, pool_ks=pks, pool_vs=pvs)
    torch.cuda.synchronize()
    assert paged_flash_decode_int8.launches == before + 1
    assert_matches(got, paged_flash_decode_int8_plain(q, pk, pv, pks, pvs, tables, pos,
                                                      layer))


@pytest.mark.gpu
def test_k7_kernel_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, pk, pv, _, _, tables, pos = paged_case(gen, cuda, 4, 64, 257, 1, [0, 31, 32, 2047])
    before = paged_flash_decode_per_head.launches
    got = paged_flash_decode(q, pk[0], pv[0], tables, pos, fold_heads=False)
    torch.cuda.synchronize()
    assert paged_flash_decode_per_head.launches == before + 1
    assert_matches(got, paged_flash_decode_plain(q, pk, pv, tables, pos, 0, 1))
    with pytest.raises(ValueError, match="fold_heads"):
        paged_flash_decode(q, pk, pv, tables, pos, fold_heads=False, layer=0)
    with pytest.raises(ValueError, match="G = H/KV"):
        paged_flash_decode(rand((4, 1, 2 * KV, D), gen, cuda), pk[0], pv[0], tables, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 2, 3, 5, None])
@pytest.mark.parametrize("int8", [False, True])
def test_k6_forced_splits_match_plain(cuda, split, int8):
    """K6 at forced splits of its table walk (entries a split takes) and at
    paged_split's, bf16 and int8: rows with nothing visible, on a split's
    first and last key, and at the table's end, beside each other; one
    launch a call, and every ticket back at zero after it."""
    gen = torch.Generator(device=cuda).manual_seed(40 + (split or 0) + 10 * int8)
    B, M = 6, 16
    positions = [-1, 0, 63, 64, 300, 511]
    q, pk, pv, pks, pvs, tables, pos = paged_case(
        gen, cuda, B, M, B * M + 1, 4, positions, torch.int8 if int8 else torch.bfloat16)
    scales = dict(pool_ks=pks, pool_vs=pvs) if int8 else {}
    counter = paged_flash_decode_int8 if int8 else paged_flash_decode
    before = counter.launches
    got = paged_flash_decode(q, pk, pv, tables, pos, layer=2, split=split, **scales)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    if int8:
        ref = paged_flash_decode_int8_plain(q, pk, pv, pks, pvs, tables, pos, 2, split=split)
    else:
        ref = paged_flash_decode_plain(q, pk, pv, tables, pos, 2, paged_chunk(M, 32),
                                       split=split)
    assert_matches(got, ref)
    assert float(got[0].float().abs().max()) == 0.0          # position -1: zeros
    n_splits = -(-M // (split or paged_split(B, KV, M, 32)))
    assert int(paged_scratch(cuda, B, KV, n_splits)[1].abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 3, None])
def test_k7_forced_splits_match_plain(cuda, split):
    gen = torch.Generator(device=cuda).manual_seed(70 + (split or 0))
    q, pk, pv, _, _, tables, pos = paged_case(gen, cuda, 4, 64, 257, 1, [0, 31, 32, 2047])
    before = paged_flash_decode_per_head.launches
    got = paged_flash_decode(q, pk[0], pv[0], tables, pos, fold_heads=False, split=split)
    torch.cuda.synchronize()
    assert paged_flash_decode_per_head.launches == before + 1
    assert_matches(got, paged_flash_decode_plain(q, pk, pv, tables, pos, 0, 1, split=split))


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_k6_calls_on_two_streams_keep_their_own_tickets(cuda, int8):
    """Two streams launching K6 at one shape at once: each has its own
    partials and tickets, so neither combines the other's splits, every
    output matches the plain version and every ticket is back at zero."""
    gen = torch.Generator(device=cuda).manual_seed(13 + int8)
    B, M = 2, 64
    q, pk, pv, pks, pvs, tables, pos = paged_case(
        gen, cuda, B, M, B * M + 1, 2, [2047, 1000], torch.int8 if int8 else torch.bfloat16)
    scales = dict(pool_ks=pks, pool_vs=pvs) if int8 else {}
    qs = [q, rand((B, 1, H, D), gen, cuda)]
    if int8:
        refs = [paged_flash_decode_int8_plain(x, pk, pv, pks, pvs, tables, pos, 1) for x in qs]
    else:
        refs = [paged_flash_decode_plain(x, pk, pv, tables, pos, 1, paged_chunk(M, 32))
                for x in qs]
    n_splits = -(-M // paged_split(B, KV, M, 32))
    assert n_splits > 1
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    outs, tickets = [], []
    for x, stream in zip(qs, streams):
        with torch.cuda.stream(stream):
            outs.append([paged_flash_decode(x, pk, pv, tables, pos, layer=1, **scales)
                         for _ in range(16)])
            tickets.append(paged_scratch(cuda, B, KV, n_splits)[1])
    torch.cuda.synchronize()
    assert tickets[0].data_ptr() != tickets[1].data_ptr()
    for calls, ref, t in zip(outs, refs, tickets):
        for got in calls:
            assert_matches(got, ref)
        assert int(t.abs().sum()) == 0


@pytest.mark.gpu
def test_k6_refuses_block_sizes_it_cannot_copy(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = rand((1, 1, H, D), gen, cuda)
    tables = torch.ones((1, 4), dtype=torch.int32, device=cuda)
    for bs in (4, 12):
        pool = rand((1, 3, KV, bs, D), gen, cuda)
        with pytest.raises(ValueError, match="multiple of 8"):
            paged_flash_decode(q, pool, pool, tables, 5, layer=0)


# ------------------------------------------------------------ decode graphs


def tiny_engine(device, fused=True, mesh=None, cycle=0, kv_heads=1, **args):
    """A 2-layer model at the kernels' shape (head_dim 128, G = 4; one KV
    head, ``kv_heads`` for a mesh to cut), random bf16 weights in the fused
    layout (``fused=False``: the split one, which a ``mesh`` takes, as this
    rank's shards), byte-level vocab of 512.
    ``cycle`` > 0 (split layout): the constructed-cyclic model, whose
    greedy tokens walk ``0 .. cycle-1`` whatever the attention (``wo`` and
    ``w_down`` zeroed, head rows that follow the cycle), so any two correct
    runs give the same tokens."""
    from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import init_random_params
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.tokenizer import TiktokenModel, Vocabulary
    from llama_nuts_and_bolts_tpu_torch.tokenizer.tiktoken_io import build_special_tokens

    ranks = {bytes([i]): i for i in range(256)}
    special = build_special_tokens(len(ranks))
    vocab = Vocabulary.from_tiktoken(TiktokenModel(
        mergeable_ranks=ranks, special_tokens=special, bos_id=special["<|begin_of_text|>"],
        eos_id=special["<|end_of_text|>"],
        stop_token_ids=[special["<|eom_id|>"], special["<|eot_id|>"]]))
    cfg = ModelArgs(dim=512 * kv_heads, n_layers=2, n_heads=4 * kv_heads, n_kv_heads=kv_heads,
                    vocab_size=512, multiple_of=32, norm_eps=1e-5, max_sequence_length=512)
    params = init_random_params(cfg, seed=0, device=device, fused=fused)
    if cycle:
        import dataclasses

        layers = dict(params.layers, wo=torch.zeros_like(params.layers["wo"]),
                      w_down=torch.zeros_like(params.layers["w_down"]))
        out = torch.zeros_like(params.output)
        out[:cycle] = params.tok_embeddings[(torch.arange(cycle) - 1) % cycle]
        params = dataclasses.replace(params, layers=layers, output=out)
    if mesh is not None:
        from llama_nuts_and_bolts_tpu_torch.parallel import shard_params

        params = shard_params(params, mesh)
    model = LoadedModel(params=params,
                        cfg=cfg, vocab=vocab, mergeable_ranks=ranks, tensor_meta={})
    return InferenceEngine(model, InferenceArgs(sequence_length=512, **args), device=device,
                           mesh=mesh)


PROMPT_IDS = list(range(40, 60))


def eager_decode(engine, prompt, cache_len, steps):
    """The uncaptured yardstick: prefill, then ``steps`` eager decode steps
    (``engine._forward`` + ``engine._select_token``). Returns the tokens
    (the prefill's first), the cache and the last logits."""
    logits, cache = engine._prefill(prompt, cache_len)
    tokens = [engine._select_token(logits[0, 0])]
    for i in range(steps):
        logits, cache = engine._forward([[tokens[-1]]], len(prompt) + i, cache)
        tokens.append(engine._select_token(logits[0, -1]))
    return tokens, cache, logits[:, -1]


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("k", [1, 4])
def test_captured_decode_equals_eager(cuda, k, kv):
    """Tokens, cache rows and last logits of captured steps (k-step graphs)
    are bit-equal to the eager steps': the same kernels in the same order."""
    engine = tiny_engine(cuda, decode_chunk=k, kv_cache_dtype=kv)
    cache_len, steps = 256, 12
    assert engine._attn_impl(1, cache_len) == "flash"
    ref, ref_cache, ref_logits = eager_decode(engine, PROMPT_IDS, cache_len, steps)
    with engine._lease(1, cache_len) as slot:
        logits, _ = engine._prefill(PROMPT_IDS, cache_len, cache=slot.cache)
        first = engine._select_token(logits[0, 0])
        slot.set([first], [len(PROMPT_IDS)])
        graph = engine._decode_chunk(k, cache_len=cache_len, slot=slot)
        got = [first]
        for _ in range(steps // k):
            graph.replay()
            got += [row[0] for row in graph.tokens(graph.fetch())]
        torch.cuda.synchronize()
        assert got == ref
        rows = slice(len(PROMPT_IDS), len(PROMPT_IDS) + steps)
        for name in ("k", "v", "k_scale", "v_scale"):
            mine, theirs = getattr(slot.cache, name), getattr(ref_cache, name)
            if mine is not None:
                assert torch.equal(mine[:, :, :, rows], theirs[:, :, :, rows]), name
        assert torch.equal(slot.logits, ref_logits)
    assert graph.graph is not None and graph.warmup_steps == 1


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_captured_request_counts_launches_exactly(cuda, k):
    """K1 once a layer for the prefill; K2 once a layer for every step the
    card ran: the one warm-up step of each new graph, and every replayed
    step (a chunk in flight when the cap is reached ran too)."""
    engine = tiny_engine(cuda, decode_chunk=k)
    L = engine.model.cfg.n_layers
    for request in range(2):
        flash_gqa_attention.launches = flash_decode_attention.launches = 0
        n = len(list(engine.generate_tokens(PROMPT_IDS, max_new_tokens=17)))
        torch.cuda.synchronize()
        graphs = list(engine._chunk_fns.values())
        steps = sum(g.k * g.replays + g.warmup_steps for g in graphs)
        for g in graphs:
            g.replays = g.warmup_steps = 0
        # k = 1: a step a token but the first; k = 4: the chunks the 16
        # decoded tokens need and one in flight
        want = n - 1 if k == 1 else k * (-(-(n - 1) // k) + 1)
        warm = 0 if request else 1
        assert n == 17 and steps == want + warm
        assert flash_gqa_attention.launches == L
        assert flash_decode_attention.launches == L * steps


@pytest.mark.gpu
def test_sampled_captured_stream_equals_eager_and_chunked(cuda):
    """A seeded sampled request: the captured per-token stream equals the
    eager steps', a 4-step chunked one equals both, and a mid-chunk end
    leaves the generator where per-token decoding leaves it."""
    args = dict(temperature=0.9, top_k=40, top_p=0.95, seed=7)
    engine = tiny_engine(cuda, **args)
    ref, _, _ = eager_decode(engine, PROMPT_IDS, 256, 9)
    for k in (1, 4):
        engine = tiny_engine(cuda, decode_chunk=k, **args)
        got = [t for _, t in engine.generate_tokens(PROMPT_IDS, max_new_tokens=10)]
        assert got == ref, k
        if k == 1:
            state = engine._generator.get_state()
        else:
            assert torch.equal(engine._generator.get_state(), state)


@pytest.mark.gpu
def test_capture_failure_raises_without_an_eager_fallback(cuda, monkeypatch):
    """A kernel that raises during capture makes the request raise: no
    token is decoded after the prefill's, on any path."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import model as model_mod

    def refuses_capture(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("planted: K2 refuses to be captured")
        return flash_decode_attention(*args, **kwargs)

    monkeypatch.setattr(model_mod, "flash_decode_attention", refuses_capture)
    engine = tiny_engine(cuda)
    tokens = []
    with pytest.raises(RuntimeError, match="planted"):
        for _, tok in engine.generate_tokens(PROMPT_IDS, max_new_tokens=8):
            tokens.append(tok)
    assert len(tokens) == 1
    assert not torch.cuda.is_current_stream_capturing()


@pytest.mark.gpu
def test_batched_generation_replays_one_graph_at_two_rows(cuda):
    """generate_tokens_batched on the card: two rows with the same prompt
    give the same tokens, every step replays the two-row one-step graph,
    and K2 runs once a layer for each step and the one warm-up step."""
    from llama_nuts_and_bolts_tpu_torch.runtime.batch import generate_tokens_batched

    engine = tiny_engine(cuda)
    engine.model.vocab.stop_token_ids.clear()     # the rows run to the 12th step
    L = engine.model.cfg.n_layers
    flash_decode_attention.launches = 0
    rows = {0: [], 1: []}
    steps = 0
    for step in generate_tokens_batched(engine, [PROMPT_IDS, PROMPT_IDS]):
        steps += 1
        for r in step:
            rows[r.row].append((r.position, r.token_id))
        if steps == 12:
            break
    torch.cuda.synchronize()
    assert rows[0] == rows[1] and len(rows[0]) == 12
    (graph,) = engine._chunk_fns.values()
    assert graph.slot.batch == 2 and graph.replays == 11
    assert flash_decode_attention.launches == L * (11 + 1)


# ------------------------------------------------ the batchers' step graph


def checked_replays(batcher):
    """Wrap the batcher's step graph: after each replay, the eager step on
    fresh copies of the static inputs; per replay, whether the logits are
    bit-equal. And per dispatch, whether the static tables equal the
    host's."""
    import numpy as np

    graph = batcher._step_graph
    bufs, step = graph.slot, batcher._step_fn()
    equal, tables = [], []
    replay, dispatch = graph.replay, batcher._dispatch

    def replayed():
        replay()
        ref = step(bufs.feed.clone(), bufs.pos.clone(), bufs.tables.clone())
        equal.append(torch.equal(bufs.logits, ref))

    def dispatched():
        dispatch()
        tables.append(np.array_equal(bufs.tables.cpu().numpy(), batcher.tables))

    graph.replay, batcher._dispatch = replayed, dispatched
    return equal, tables


@pytest.mark.gpu
@pytest.mark.parametrize("quantum", [1, 2])
def test_replayed_batcher_step_equals_the_eager_step(cuda, quantum):
    """Every replay of the paged batcher's step graph (K6) against the
    eager ``paged_decode_step`` on fresh copies of the same feed, positions
    and tables: bit-equal logits over a run where requests join mid-flight,
    leave and grow blocks across block boundaries; the static tables equal
    the host's after each dispatch, and every step replays the graph."""
    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher

    b = PagedBatcher(tiny_engine(cuda, fused=False), n_slots=3, step_quantum=quantum)
    assert b.attn_impl == "flash"
    equal, tables = checked_replays(b)
    reqs = [b.submit(PROMPT_IDS, max_new_tokens=50), b.submit([7, 8, 9], max_new_tokens=9)]
    for _ in range(5):
        b.step()
    reqs += [b.submit(list(range(100, 131)), max_new_tokens=40),
             b.submit([5] * 33, max_new_tokens=12)]
    b.run_until_idle()
    torch.cuda.synchronize()
    assert [len(list(r.tokens(timeout=60))) for r in reqs] == [50, 9, 40, 12]
    assert len(equal) == b.decode_steps > 40 and all(equal)
    assert tables and all(tables)
    assert b.graph_steps == b.decode_steps and b._step_graph.warmup_steps == 1


@pytest.mark.gpu
def test_the_batcher_captures_once_and_replays_k6_a_layer_a_step(cuda):
    """One capture during the warm-up request (one ``engine.graph_capture``
    span), none while serving after it; every plain step replays the graph,
    and K6 runs once a layer for each replayed step."""
    import time

    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS

    b = PagedBatcher(tiny_engine(cuda, fused=False), n_slots=2)

    def captures(t0):
        return [sp for sp in SPANS.between(t0, time.perf_counter_ns() + 1)
                if sp[0] == "engine.graph_capture"]

    t0 = time.perf_counter_ns()
    warm = b.submit(PROMPT_IDS, max_new_tokens=3)
    b.run_until_idle()
    assert len(list(warm.tokens(timeout=60))) == 3
    torch.cuda.synchronize()
    graph = b._step_graph.graph
    assert graph is not None and len(captures(t0)) == 1
    t1, steps0 = time.perf_counter_ns(), b.decode_steps
    paged_flash_decode.launches = 0
    reqs = [b.submit(PROMPT_IDS, max_new_tokens=30), b.submit([3, 4], max_new_tokens=17)]
    b.run_until_idle()
    torch.cuda.synchronize()
    assert all(list(r.tokens(timeout=60)) for r in reqs)
    assert not captures(t1) and b._step_graph.graph is graph
    assert b._step_graph.warmup_steps == 1 and b.graph_steps == b.decode_steps
    assert paged_flash_decode.launches == b.engine.model.cfg.n_layers * (
        b.decode_steps - steps0) > 0


@pytest.mark.gpu
def test_a_failed_batcher_capture_raises_without_an_eager_fallback(cuda, monkeypatch):
    """K6 refusing to be captured makes the batcher's first dispatch raise:
    no decode step runs eagerly in the graph's place."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import paged as paged_mod
    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher

    k6 = paged_mod.tp_paged_flash_decode

    def refuses_capture(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("planted: K6 refuses to be captured")
        return k6(*args, **kwargs)

    monkeypatch.setattr(paged_mod, "tp_paged_flash_decode", refuses_capture)
    b = PagedBatcher(tiny_engine(cuda, fused=False), n_slots=2)
    req = b.submit(PROMPT_IDS, max_new_tokens=8)
    with pytest.raises(RuntimeError, match="planted"):
        b.step()
    assert b.decode_steps == b.graph_steps == 0 and req.out.empty()
    assert not torch.cuda.is_current_stream_capturing()


# ------------------------------------------------- the paged prefill on K1

# phi-3-medium's attention (40 / 10 heads, head_dim 128, rope_theta 1e4) on
# two layers, ffn and vocabulary cut: the serve cell's prefill shapes
PHI3_2L = dict(dim=5120, n_layers=2, n_heads=40, n_kv_heads=10, vocab_size=512,
               multiple_of=256, norm_eps=1e-5, rope_theta=10000.0, max_sequence_length=2048)
# K1 against the fp32 oracle, relative L2 of the logits row on 2 layers
# (chip_smoke.py's LOGITS_REL_L2: the paths round p at different places)
PREFILL_REL_L2 = 3e-2
_PHI3: list = []


def phi3_model(device):
    from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import init_random_params

    if not _PHI3:
        cfg = ModelArgs(**PHI3_2L)
        _PHI3.append((cfg, init_random_params(cfg, seed=22, device=device)))
    return _PHI3[0]


def rel_l2(got, ref):
    return float((got.float() - ref.float()).norm() / ref.float().norm())


def phi3_prefills(device, tokens, n, shared=None, planted=False):
    """``paged_prefill`` of ``tokens`` (``n`` real rows) on the plain path
    and on K1 into fresh pools, or with ``shared`` (a resident prefix's
    tokens) ``paged_prefill_shared`` of the suffix after it; ``planted``
    runs K1 one pool block (32 positions) early, so each row misses its 32
    latest keys. The logits rows, the pools and K1's launches."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import paged

    cfg, params = phi3_model(device)
    table = torch.arange(1, 65, dtype=torch.int32, device=device)
    out = {}
    for impl in ("plain", "flash"):
        pool = paged.PagedKVPool.create(cfg, 65, 32, device=device)
        if shared is not None:
            paged.paged_prefill(params, cfg, shared, shared.shape[1] - 1, pool, table)
        before = flash_gqa_attention.launches
        k1 = paged.tp_flash_gqa_attention
        if planted:
            paged.tp_flash_gqa_attention = lambda m, q, k, v, p: k1(m, q, k, v, p - 32)
        try:
            if shared is None:
                logits, _ = paged.paged_prefill(params, cfg, tokens, n - 1, pool, table,
                                                attn_impl=impl)
            else:
                logits, _ = paged.paged_prefill_shared(params, cfg, tokens, shared.shape[1],
                                                       n - 1, pool, table, attn_impl=impl)
        finally:
            paged.tp_flash_gqa_attention = k1
        torch.cuda.synchronize()
        out[impl] = (logits, pool, flash_gqa_attention.launches - before)
    return out


def prompt_ids(device, n, bucket, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device=device)
    tokens[0, :n] = torch.randint(0, 512, (n,), generator=gen, device=device)
    return tokens


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", [32, 1024, 2048])
def test_paged_prefill_on_k1_matches_plain_at_phi3_heads(cuda, bucket):
    """A fresh prompt in a 32-, 1024- and 2048-row bucket at phi-3's heads:
    K1 (one launch a layer, one key tile or sixteen) against the plain fp32
    attention: the logits row within the limit, the first layer's pool rows
    bit-equal (projected before any attention)."""
    n = bucket - 5
    runs = phi3_prefills(cuda, prompt_ids(cuda, n, bucket, bucket), n)
    (want, want_pool, plain_k1), (got, got_pool, k1) = runs["plain"], runs["flash"]
    cfg, _ = phi3_model(cuda)
    assert (plain_k1, k1) == (0, cfg.n_layers)
    assert rel_l2(got, want) <= PREFILL_REL_L2, rel_l2(got, want)
    assert torch.equal(got_pool.k[0], want_pool.k[0])
    assert torch.equal(got_pool.v[0], want_pool.v[0])


@pytest.mark.gpu
def test_paged_prefill_shared_on_k1_matches_plain_at_phi3_heads(cuda):
    """A prefix-cache hit: 1024 resident prefix rows, a 512-row suffix
    bucket (500 real rows); K1 from ``start_pos`` 1024 over the gathered
    prefix and the suffix against the plain path's masked gather, and K1
    started one block early, which must fail the limit."""
    shared = prompt_ids(cuda, 1024, 1024, 7)
    suffix = prompt_ids(cuda, 500, 512, 8)
    runs = phi3_prefills(cuda, suffix, 500, shared=shared)
    (want, _, _), (got, _, k1) = runs["plain"], runs["flash"]
    cfg, _ = phi3_model(cuda)
    assert k1 == cfg.n_layers
    assert rel_l2(got, want) <= PREFILL_REL_L2, rel_l2(got, want)
    late = phi3_prefills(cuda, suffix, 500, shared=shared, planted=True)["flash"][0]
    assert rel_l2(late, want) > PREFILL_REL_L2, rel_l2(late, want)


@pytest.mark.gpu
def test_the_paged_batcher_prefills_on_k1(cuda):
    """The paged batcher on a card (``auto``: K6 in the steps) runs each
    admission's prefill on K1, one launch a layer, fresh prompts and a
    prefix-cache hit alike, and counts it: ``flash`` on each seated
    ``batcher.admit`` span, ``prefill_flash`` beside the admissions."""
    import time

    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import SPANS

    b = PagedBatcher(tiny_engine(cuda, fused=False), n_slots=2)
    assert b.attn_impl == "flash"
    t0, before = time.perf_counter_ns(), flash_gqa_attention.launches
    reqs = [b.submit(PROMPT_IDS * 4, max_new_tokens=5)]
    b.step()                                        # its blocks are resident
    reqs += [b.submit(PROMPT_IDS * 4 + [3, 4, 5], max_new_tokens=5),
             b.submit([7, 8, 9], max_new_tokens=5)]
    b.run_until_idle()
    torch.cuda.synchronize()
    assert all(len(list(r.tokens(timeout=60))) == 5 for r in reqs)
    admits = [sp[5] for sp in SPANS.between(t0, time.perf_counter_ns() + 1)
              if sp[0] == "batcher.admit" and "computed" in sp[5]]
    assert [c["flash"] for c in admits] == [1, 1, 1] and b.prefill_flash == 3
    assert b.allocator.stats["prefix_hits"] == 2
    assert flash_gqa_attention.launches - before == 3 * b.engine.model.cfg.n_layers


@pytest.mark.gpu
def test_tp2_paged_prefill_runs_k1_on_a_ranks_heads(cuda, tmp_path):
    """Two gloo ranks on the one card, each with its half of the heads (4
    / 1 of 8 / 2): ``paged_prefill`` and ``paged_prefill_shared`` on K1
    through ``tp_flash_gqa_attention`` against the whole model's plain
    prefill, within the limit; K1 launched once a layer a call on each
    rank."""
    import torch.multiprocessing as mp

    from llama_nuts_and_bolts_tpu_torch.models.llama import paged
    from llama_nuts_and_bolts_tpu_torch.parallel.launch import free_port
    from tests.tp_workers import cuda_shared_prefill_rank, tp_prefill_case, tp_prefills

    cfg, params, prompt, suffix, table = tp_prefill_case(cuda)
    want = tp_prefills(params, cfg, paged.PagedKVPool.create(cfg, 17, 32, device=cuda),
                       prompt, suffix, table)
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=cuda_shared_prefill_rank, args=(r, 2, port, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    errors = [e.read_text() for e in tmp_path.glob("*.err")]
    assert not errors, errors[0]
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        assert got["launches"] == 2 * cfg.n_layers
        for g, w in zip(got["logits"], want):
            assert rel_l2(g.to(cuda), w) <= PREFILL_REL_L2, rel_l2(g.to(cuda), w)


CYCLE = 7           # the cyclic model's cycle (tiny_engine's ``cycle``)
TP_SCRIPT = [("submit", PROMPT_IDS, {"max_new_tokens": 30}),
             ("submit", [3, 4, 5], {"max_new_tokens": 12}), ("step", 4),
             ("submit", list(range(60, 100)), {"max_new_tokens": 25}), ("idle",)]


@pytest.mark.gpu
def test_tp2_batcher_replays_its_step_graph(cuda, tmp_path):
    """Two NCCL ranks on two cards, each a paged batcher over its shards of
    the cyclic model: each rank captures its step graph (the all-reduces and
    the logits all-gather inside) once and replays it for every plain step,
    and rank 0's streams equal one card's without a mesh (two KV heads, one
    a rank)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import torch.multiprocessing as mp

    from llama_nuts_and_bolts_tpu_torch.parallel.launch import free_port
    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher
    from tests.tp_workers import cuda_batcher_rank, run_script

    b = PagedBatcher(tiny_engine(cuda, fused=False, cycle=CYCLE, kv_heads=2), n_slots=2)
    want = run_script(b, TP_SCRIPT)
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=cuda_batcher_rank, args=(r, 2, port, str(tmp_path), "cuda"))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    errors = [e.read_text() for e in tmp_path.glob("*.err")]
    assert not errors, errors[0]
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["streams"] == want
    for r in ranks:
        assert r["graph_steps"] == r["decode_steps"] == ranks[0]["decode_steps"] > 0
        assert r["warmup_steps"] == 1


def scripted_drafts(monkeypatch, pattern):
    """The n-gram proposer replaced by a script: step i drafts
    ``pattern[i % len(pattern)]`` tokens (``[]`` for none)."""
    from llama_nuts_and_bolts_tpu_torch.runtime import speculative

    calls = []

    def propose(self, k):
        calls.append(k)
        return list(pattern[(len(calls) - 1) % len(pattern)])

    monkeypatch.setattr(speculative.NgramProposer, "propose", propose)
    return calls


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_verify_graph_equals_eager_verify(cuda, k):
    """Three replays of the captured verify step at successive positions:
    its predictions and the cache rows it writes are bit-equal to an eager
    ``forward`` at S = k+1 (the same operations in the same order)."""
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import forward

    engine = tiny_engine(cuda, speculate_k=k)
    cfg, T = engine.model.cfg, engine.seq_len
    P = len(PROMPT_IDS)
    with engine._lease(1, T) as slot:
        engine._prefill(PROMPT_IDS, T, cache=slot.cache)
        ref = slot.cache.truncated(T)
        graph = engine._verify_graph(k, slot)
        for i in range(3):
            tokens = [(7 + 31 * i + 13 * j) % 512 for j in range(k + 1)]
            graph.set(tokens, P + 2 * i)
            graph.replay()
            got = graph.tokens(graph.fetch())
            logits, ref = forward(engine.model.params, cfg,
                                  torch.tensor([tokens], dtype=torch.int32, device=cuda),
                                  torch.tensor([P + 2 * i], dtype=torch.int32, device=cuda),
                                  ref, attn_impl="plain")
            assert got == torch.argmax(logits[0], dim=-1).tolist()
        torch.cuda.synchronize()
        assert torch.equal(slot.cache.k, ref.k) and torch.equal(slot.cache.v, ref.v)
    assert graph.graph is not None and graph.warmup_steps == 1 and graph.replays == 3


@pytest.mark.gpu
def test_speculative_request_counts_launches_exactly(cuda, monkeypatch):
    """K1 once a layer for the prefill; K2 once a layer for every no-draft
    step (the one-step graph's replays and its one warm-up step); the verify
    steps run the plain attention path and no kernel. The graphs' tallies
    agree with ``spec_stats``."""
    engine = tiny_engine(cuda, speculate_k=3)
    engine.model.vocab.stop_token_ids.clear()         # the request runs to its cap
    L = engine.model.cfg.n_layers
    calls = scripted_drafts(monkeypatch, [[5, 6, 7], [], [9]])
    for request in range(2):
        flash_gqa_attention.launches = flash_decode_attention.launches = 0
        n = len(list(engine.generate_tokens(PROMPT_IDS, max_new_tokens=17)))
        torch.cuda.synchronize()
        stats = engine.spec_stats
        graphs = dict(engine._chunk_fns)
        verify = [g for key, g in graphs.items() if key[0] == "verify"]
        steps = [g for key, g in graphs.items() if key[0] != "verify"]
        assert n == 17 and len(verify) == len(steps) == 1
        assert verify[0].replays == stats["spec_steps"]
        assert steps[0].replays == stats["steps"] - stats["spec_steps"] > 0
        warm = 0 if request else 1
        assert verify[0].warmup_steps == steps[0].warmup_steps == warm
        assert flash_gqa_attention.launches == L
        assert flash_decode_attention.launches == L * (steps[0].replays + warm)
        for g in graphs.values():
            g.replays = g.warmup_steps = 0
    assert calls


@pytest.mark.gpu
def test_verify_capture_failure_raises_without_an_eager_fallback(cuda, monkeypatch):
    """A forward that raises while the verify step is captured makes the
    request raise after the prefill's token: nothing runs the verify
    eagerly instead."""
    from llama_nuts_and_bolts_tpu_torch.runtime import decode_graph

    real = decode_graph.forward

    def refuses_capture(params, cfg, tokens, *args, **kwargs):
        if torch.cuda.is_current_stream_capturing() and tokens.shape[1] > 1:
            raise RuntimeError("planted: the verify step refuses to be captured")
        return real(params, cfg, tokens, *args, **kwargs)

    monkeypatch.setattr(decode_graph, "forward", refuses_capture)
    scripted_drafts(monkeypatch, [[5, 6]])
    engine = tiny_engine(cuda, speculate_k=2)
    tokens = []
    with pytest.raises(RuntimeError, match="planted"):
        for _, tok in engine.generate_tokens(PROMPT_IDS, max_new_tokens=8):
            tokens.append(tok)
    assert len(tokens) == 1
    assert not torch.cuda.is_current_stream_capturing()


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_probe_choice_is_viable_and_stable_for_a_bucket(cuda, kv):
    """On a card the probe times the plain path and the kernels (K2, K4 for
    an int8 cache) once per bucket; its choice is one of them, a second
    decode step of the bucket does not probe again, and the bucket's decode
    graph takes the choice. The probe's graphs and slot are not kept."""
    engine = tiny_engine(cuda, attn_impl="probe", kv_cache_dtype=kv)
    assert engine._decode_candidates(256) == ["plain", "flash"]
    choice = engine._attn_impl(1, 256)
    assert choice in ("plain", "flash")
    assert set(engine._probe_timings) == {"plain", "flash"}
    assert all(t > 0 for t in engine._probe_timings.values())
    assert choice == min(engine._probe_timings, key=engine._probe_timings.get)
    assert engine._chunk_fns == {} and engine._slots == {}
    engine.autotune_attn_impl = None              # a second probe would call None
    assert engine._attn_impl(1, 256) == choice
    assert engine._attn_impl(64, 256) == engine._auto_attn_impl(64, 256)
    tokens = [t for _, t in engine.generate_tokens(PROMPT_IDS, max_new_tokens=8)]
    assert len(tokens) == 8
    assert {g.impl for g in engine._chunk_fns.values()} == {choice}


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_narrated_prefill_is_bit_equal_to_forward(cuda, kv):
    """The narrated prefill runs forward's own blocks (K1 on a bf16 cache,
    the plain path on an int8 one, as the engine's prefill): logits and
    cache bit for bit, one K1 launch a layer on bf16."""
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import forward
    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import narrated_forward

    engine = tiny_engine(cuda, kv_cache_dtype=kv)
    params, cfg = engine.model.params, engine.model.cfg
    tokens = torch.tensor([PROMPT_IDS * 5], dtype=torch.int32, device=cuda)
    impl = engine._attn_impl(tokens.shape[1], 256)
    assert impl == ("flash" if kv == "bf16" else "plain")
    caches = [engine.new_cache(1, 256) for _ in range(2)]
    lines = []
    flash_gqa_attention.launches = 0
    got, _ = narrated_forward(params, cfg, tokens, 0, caches[0], lines.append,
                              attn_impl=impl, logits_at=99)
    assert flash_gqa_attention.launches == (cfg.n_layers if kv == "bf16" else 0)
    want, _ = forward(params, cfg, tokens, 0, caches[1], attn_impl=impl, logits_at=99)
    assert torch.equal(got, want)
    assert torch.equal(caches[0].k, caches[1].k) and torch.equal(caches[0].v, caches[1].v)
    assert len(lines) == cfg.n_layers + 2


@pytest.mark.gpu
def test_device_trace_names_k1_and_k2(cuda, tmp_path):
    """A trace of an eager prefill (K1) and a replayed decode graph (K2)
    holds both kernels on the device timeline."""
    import json
    import os

    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import device_trace

    engine = tiny_engine(cuda)
    with engine._lease(1, 256) as slot:
        engine._prefill(PROMPT_IDS, 256, cache=slot.cache)
        slot.set([1], [len(PROMPT_IDS)])
        graph = engine._decode_chunk(1, cache_len=256, slot=slot)
        graph.replay()                            # captured before the trace
        with device_trace(str(tmp_path)) as prof:
            engine._prefill(PROMPT_IDS, 256)
            slot.set([1], [len(PROMPT_IDS)])
            graph.replay()
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
        names = " ".join(str(e.get("name")) for e in json.load(f)["traceEvents"])
    assert "flash_gqa_kernel" in names and "flash_decode_kernel" in names
    keys = " ".join(e.key for e in prof.key_averages())
    assert "flash_gqa_kernel" in keys


# --------------------------------------------------- tensor parallelism

@pytest.mark.gpu
@pytest.mark.parametrize("tp", [2, 4])
def test_kernels_at_tp_rank_shapes(cuda, tp):
    """K1, K2, K4 and K8 at one tp rank's shapes of Llama-3.1-8B (H/tp, KV/tp
    heads, G = 4; the rank's int4 wq, wo, w_down and vocab-sharded head)
    against their plain versions; K4 still forms a thread-block cluster at
    B * KV = 8 / tp."""
    h, kv = H // tp, KV // tp
    gen = torch.Generator(device=cuda).manual_seed(tp)
    q = rand((1, 512, h, D), gen, cuda)
    k, v = rand((1, kv, 2048, D), gen, cuda), rand((1, kv, 2048, D), gen, cuda)
    assert_matches(flash_gqa_attention(q, k, v, 700),
                   flash_gqa_attention_plain(q, k, v, 700))
    qd = rand((1, 1, h, D), gen, cuda)
    pos = torch.tensor([3000], dtype=torch.int32, device=cuda)
    kc, vc = rand((2, 1, kv, 4096, D), gen, cuda), rand((2, 1, kv, 4096, D), gen, cuda)
    assert_matches(flash_decode_attention(qd, kc, vc, pos, layer=1),
                   flash_decode_attention_plain(qd, kc, vc, pos, 1))
    k8_, ks = int8_cache((2, 1, kv, 4096, D), gen, cuda)
    v8, vs = int8_cache((2, 1, kv, 4096, D), gen, cuda)
    bk = decode_block_k(4096, kv, D, True)
    assert k4_cluster(1, kv, 4096, bk) >= 2
    got = flash_decode_attention(qd, k8_, v8, pos, k_scale=ks, v_scale=vs, layer=1,
                                 fold_heads=True, int8_mxu=True)
    assert_matches(got, flash_decode_attention_int8_mxu_plain(qd, k8_, v8, ks, vs, pos, 1, bk))
    for out_dim, in_dim in ((4096 // tp, 4096), (4096, 4096 // tp), (4096, 14336 // tp),
                            (128256 // tp, 4096)):
        x, packed, scale = k8_case(gen, cuda, 1, out_dim, in_dim)
        assert k8_takes(1, packed)
        assert_matches(q4_matmul(x, packed, scale), q4_matmul_plain(x, packed, scale),
                       K8_ATOL, K8_RTOL, K8_REL_L2)


@pytest.fixture
def one_rank_group(cuda):
    """A one-rank process group in this process (``backend`` as the test
    asks), torn down after."""
    import torch.distributed as dist

    from llama_nuts_and_bolts_tpu_torch.parallel.launch import free_port
    from llama_nuts_and_bolts_tpu_torch.parallel import initialize_multihost

    def start(backend):
        initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend=backend)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_one_nccl_rank_mesh_engine_is_bit_equal(cuda, one_rank_group, k):
    """``make_mesh(tp=1)`` over NCCL: the engine with the mesh captures the
    all-reduces and the logits all-gather into its decode graphs, and its
    tokens, last logits and launches equal those of the engine without it,
    bit for bit (a one-rank sum is its only term)."""
    from llama_nuts_and_bolts_tpu_torch.parallel import make_mesh
    from llama_nuts_and_bolts_tpu_torch.runtime.decode_graph import launch_counts

    one_rank_group("nccl")
    mesh = make_mesh(tp=1)
    out = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        engine = tiny_engine(cuda, fused=False, mesh=m, decode_chunk=k)
        before = launch_counts()
        ids = [t for _, t in engine.generate_tokens(PROMPT_IDS, max_new_tokens=24)]
        torch.cuda.synchronize()
        launches = tuple(a - b for a, b in zip(launch_counts(), before))
        slot = engine._slots[(1, 256)][0]
        out[name] = (ids, slot.logits.clone(), launches)
        assert any(g.graph is not None for g in engine._chunk_fns.values())
    assert out["plain"][0] == out["mesh"][0]
    assert torch.equal(out["plain"][1], out["mesh"][1])
    assert out["plain"][2] == out["mesh"][2]


@pytest.mark.gpu
def test_engine_refuses_gloo_on_the_card(cuda, one_rank_group):
    """Gloo's collectives cannot be captured: an engine on the card refuses
    a gloo mesh instead of running it."""
    from llama_nuts_and_bolts_tpu_torch.parallel import make_mesh

    one_rank_group("gloo")
    with pytest.raises(ValueError, match="gloo group on cuda.*cannot be captured"):
        tiny_engine(cuda, fused=False, mesh=make_mesh(tp=1))


@pytest.mark.gpu
def test_cli_tp_refuses_more_ranks_than_cards(cuda):
    from llama_nuts_and_bolts_tpu_torch.parallel.launch import check_cards

    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"--tp {n + 1} needs {n + 1} CUDA devices"):
        check_cards(n + 1, "cuda")



@pytest.mark.gpu
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("B,M,positions", [(4, 64, [3, 700, 2047, 1000]), (4, 64, [114] * 4),
                                           (1, 64, [1850])])
def test_k6_at_tp_rank_shapes(cuda, one_rank_group, tp, B, M, positions):
    """K6 through ``tp_paged_flash_decode`` at one tp rank's shapes of
    Llama-3.1-8B (H/tp, KV/tp heads of a 32-layer pool of 32-position
    blocks, G = 4), bf16 and int8, each launch counted, against the plain
    versions."""
    from llama_nuts_and_bolts_tpu_torch.parallel import make_mesh
    from llama_nuts_and_bolts_tpu_torch.parallel.kernel_shard import tp_paged_flash_decode

    one_rank_group("nccl")
    mesh = make_mesh(tp=1)
    h, kv, bs, L, layer = H // tp, KV // tp, 32, 32, 5
    gen = torch.Generator(device=cuda).manual_seed(tp * 10 + B)
    n_blocks = B * M + 1
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(B + M)) + 1
    tables = perm[:B * M].reshape(B, M).to(torch.int32).to(cuda)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    q = rand((B, 1, h, D), gen, cuda)
    shape = (L, n_blocks, kv, bs, D)
    pk, pv = rand(shape, gen, cuda), rand(shape, gen, cuda)
    before = paged_flash_decode.launches
    got = tp_paged_flash_decode(mesh, q, pk, pv, tables, pos, layer=layer)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    assert_matches(got, paged_flash_decode_plain(q, pk, pv, tables, pos, layer,
                                                 paged_chunk(M, bs)))
    del pk, pv
    (pk, pks), (pv, pvs) = int8_cache(shape, gen, cuda), int8_cache(shape, gen, cuda)
    before = paged_flash_decode_int8.launches
    got = tp_paged_flash_decode(mesh, q, pk, pv, tables, pos, layer=layer, pool_ks=pks,
                                pool_vs=pvs)
    torch.cuda.synchronize()
    assert paged_flash_decode_int8.launches == before + 1
    assert_matches(got, paged_flash_decode_int8_plain(q, pk, pv, pks, pvs, tables, pos,
                                                      layer))


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_batcher_on_a_one_rank_nccl_mesh_runs_k6(cuda, one_rank_group, kv):
    """The paged batcher under ``make_mesh(tp=1)`` over NCCL keeps the card's
    rule (K6 for a bf16 pool; a forced ``flash`` runs K6's int8 mode), never
    the gather, and its tokens equal the batcher's without the mesh."""
    from llama_nuts_and_bolts_tpu_torch.parallel import make_mesh
    from llama_nuts_and_bolts_tpu_torch.parallel.launch import new_control_group
    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher

    one_rank_group("nccl")
    mesh = make_mesh(tp=1)
    control = new_control_group()
    counter = paged_flash_decode if kv == "bf16" else paged_flash_decode_int8
    out = []
    for m in (None, mesh):
        engine = tiny_engine(cuda, fused=False, mesh=m, kv_cache_dtype=kv,
                             attn_impl="auto" if kv == "bf16" else "flash")
        b = PagedBatcher(engine, n_slots=2, control=None if m is None else control)
        assert b.attn_impl == "flash"
        before = counter.launches
        reqs = [b.submit(PROMPT_IDS, max_new_tokens=12), b.submit([7, 8, 9], max_new_tokens=9)]
        b.run_until_idle()
        b.stop()
        # every replayed step, and the step graph's one warm-up run
        assert counter.launches - before == engine.model.cfg.n_layers * (
            b.decode_steps + b._step_graph.warmup_steps)
        assert b.graph_steps == b.decode_steps
        out.append([[t for _, t in r.tokens(timeout=60)] for r in reqs])
    assert out[0] == out[1]


@pytest.mark.gpu
def test_server_tp_refuses_more_ranks_than_cards(cuda):
    """The server's ``--tp N`` with fewer than N cards raises and names both
    counts before any rank starts."""
    from llama_nuts_and_bolts_tpu_torch.serving import __main__ as serving

    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"--tp {n + 1} needs {n + 1} CUDA devices"):
        serving.main(["--tiny", "--tp", str(n + 1), "--continuous", "2"])
