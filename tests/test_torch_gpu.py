"""CUDA kernels K1/K2 of the PyTorch port against their plain versions at
Llama-3.1-8B attention widths (H=32, KV=8, D=128). Marked ``gpu``: each test
skips inside its fixture when there is no card. Imports only torch and the
port, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import pytest
import torch

from llama_nuts_and_bolts_tpu_torch.kernels.attention import (
    flash_gqa_attention,
    flash_gqa_attention_plain,
)
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
    flash_decode_attention,
    flash_decode_attention_plain,
)

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


def assert_matches(got, ref):
    got, ref = got.float(), ref.float()
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
    assert float((got - ref).norm() / ref.norm()) <= REL_L2


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
def test_wrappers_raise_instead_of_falling_back(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = rand((1, 1, H, D), gen, cuda)
    k = rand((1, 1, KV, 64, D), gen, cuda)
    with pytest.raises(NotImplementedError):
        flash_decode_attention(q, k, k, 3, layer=0, fold_heads=True)
    with pytest.raises(NotImplementedError):
        flash_decode_attention(q, k.to(torch.int8), k.to(torch.int8), 3, layer=0)
    with pytest.raises(TypeError):
        flash_gqa_attention(q.float(), k[0].float(), k[0].float(), 0)
    with pytest.raises(ValueError, match="G = H/KV"):      # built for G = 4 only
        flash_gqa_attention(rand((1, 4, 2 * KV, D), gen, cuda), k[0], k[0], 0)
    with pytest.raises(ValueError):
        flash_gqa_attention(q, k[0].transpose(2, 3).contiguous().transpose(2, 3),
                            k[0], 0)
