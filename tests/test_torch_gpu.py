"""CUDA kernels K1, K2, K3, K4 and K8 of the PyTorch port against their
plain versions at Llama-3.1-8B widths (H=32, KV=8, D=128, dim 4096, ffn
14336). Marked ``gpu``: each test skips inside its fixture when there is no
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
)
from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import q4_matmul, q4_matmul_plain
from llama_nuts_and_bolts_tpu_torch.models.llama.model import quantize_kv_rows
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
                                           (512, 0, 2048)])
def test_k1_kernel_matches_plain(cuda, S, start_pos, T):
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
@pytest.mark.parametrize("L,layer,T,positions", [(1, 0, 1024, [0, 1023]),
                                                 (3, 2, 700, [63, 64, 699])])
def test_k2_kernel_matches_plain(cuda, L, layer, T, positions):
    gen = torch.Generator(device=cuda).manual_seed(T)
    B = len(positions)
    q = rand((B, 1, H, D), gen, cuda)
    k, v = rand((L, B, KV, T, D), gen, cuda), rand((L, B, KV, T, D), gen, cuda)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    before = flash_decode_attention.launches
    got = flash_decode_attention(q, k, v, pos, layer=layer)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == before + 1
    ref = flash_decode_attention_plain(q, k, v, pos, layer)
    assert_matches(got, ref)


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


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 3, 16, 32])
@pytest.mark.parametrize("out_dim,in_dim", [(1024, 4096), (4096, 14336)])
def test_k8_kernel_matches_plain(cuda, rows, out_dim, in_dim):
    gen = torch.Generator(device=cuda).manual_seed(rows + out_dim)
    w = torch.randn((out_dim, in_dim), generator=gen, device=cuda) / in_dim ** 0.5
    qt = quantize_tensor_q4(w)
    x = rand((rows, in_dim), gen, cuda)
    before = q4_matmul.launches
    got = q4_matmul(x, qt.packed, qt.scale)
    torch.cuda.synchronize()
    assert q4_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (rows, out_dim)
    assert_matches(got, q4_matmul_plain(x, qt.packed, qt.scale), K8_ATOL, K8_RTOL, K8_REL_L2)


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = rand((1, 1, H, D), gen, cuda)
    k = rand((1, 1, KV, 64, D), gen, cuda)
    with pytest.raises(NotImplementedError):
        flash_decode_attention(q, k, k, 3, layer=0, blocked=False)
    with pytest.raises(ValueError):                 # an int8 cache without scales
        flash_decode_attention(q, k.to(torch.int8), k.to(torch.int8), 3, layer=0)
    qt = quantize_tensor_q4(torch.randn((80, 512), generator=gen, device=cuda))
    with pytest.raises(ValueError, match="out"):    # out % 32
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
