"""The quantized slice of the PyTorch port against the JAX package: int4 (and
int8) weights bridged from the same JAX params and an int8 KV cache, through
``forward`` (a plain prefill and decode steps on the flash path, whose JAX
side runs the Pallas kernel in interpret mode and whose port side runs the
plain versions) and through the engine's greedy tokens on the cyclic model."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.io.params import ModelArgs as JModelArgs
from llama_nuts_and_bolts_tpu.models.llama import model as jmodel
from llama_nuts_and_bolts_tpu.models.llama.loader import LoadedModel as JLoadedModel
from llama_nuts_and_bolts_tpu.runtime import InferenceArgs as JInferenceArgs
from llama_nuts_and_bolts_tpu.runtime import InferenceEngine as JInferenceEngine
from llama_nuts_and_bolts_tpu import quant as jquant

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.kernels import decode_attention as dk
from llama_nuts_and_bolts_tpu_torch.models.llama import model
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import (
    params_from_numpy,
    tensor_to_numpy,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.loader import LoadedModel
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests.test_torch_engine import CYCLE, PROMPT, tokenizers

JFWD = jax.jit(jmodel.forward, static_argnums=(1,), static_argnames=("attn_impl",))

# head_dim 128 (the kernels' width), 2 layers, G = 2
WIDE = dict(dim=256, n_layers=2, n_heads=2, n_kv_heads=1, vocab_size=96,
            multiple_of=32, norm_eps=1e-5, max_sequence_length=128)
# the bf16 drift bar of tests/test_torch_model.py: 5x the bf16 threshold
BF16_DRIFT = 5.0


def leaves(p):
    def leaf(a):
        if hasattr(a, "packed"):
            return {"packed": np.asarray(a.packed), "scale": np.asarray(a.scale)}
        if hasattr(a, "q"):
            return {"q": np.asarray(a.q), "scale": np.asarray(a.scale)}
        return np.asarray(a)
    return {"tok_embeddings": np.asarray(p.tok_embeddings),
            "layers": {k: leaf(v) for k, v in p.layers.items()},
            "norm": np.asarray(p.norm), "output": leaf(p.output),
            "rope_cos": np.asarray(p.rope_cos), "rope_sin": np.asarray(p.rope_sin)}


def quantized_pair(spec, quant, seed=0):
    jcfg = JModelArgs(**spec)
    jparams = jax.jit(jmodel.init_random_params, static_argnums=(0,))(
        jcfg, jax.random.PRNGKey(seed))
    jparams = (jquant.quantize_params_q4 if quant == "int4" else jquant.quantize_params)(jparams)
    return jcfg, jparams, ModelArgs(**spec), params_from_numpy(leaves(jparams), "cpu")


def run_both(quant, cache_dtype, decode_impl, steps=3, T=256):
    """A plain prefill of 7 tokens, then greedy decode steps on
    ``decode_impl``, through both forwards on the same weights; the port's
    tokens follow the JAX ones."""
    jcfg, jparams, cfg, params = quantized_pair(WIDE, quant)
    jdt, dt = ((jnp.int8, torch.int8) if cache_dtype == "int8"
               else (jnp.bfloat16, torch.bfloat16))
    jcache = jmodel.KVCache.create(jcfg, 1, T, dtype=jdt)
    cache = model.KVCache.create(cfg, 1, T, device="cpu", dtype=dt)
    toks, pos, out = [5, 17, 42, 7, 9, 2, 6], 0, []
    for step in range(steps + 1):
        jimpl, impl = ("xla", "plain") if step == 0 else (
            "xla" if decode_impl == "plain" else decode_impl, decode_impl)
        jl, jcache = JFWD(jparams, jcfg, jnp.asarray([toks], jnp.int32), pos, jcache,
                          attn_impl=jimpl)
        tl, cache = model.forward(params, cfg, torch.tensor([toks], dtype=torch.int32),
                                  pos, cache, attn_impl=impl)
        out.append((tl, np.asarray(jl)))
        pos += len(toks)
        toks = [int(np.argmax(np.asarray(jl)[0, -1]))]
    return out, cache, jcache, pos


def assert_cache_close(cache, jcache, pos):
    """Layer 0's rows come from the same weights through the same arithmetic
    but for the order of the projection's fp32 sums, which can move a bf16
    element by an ulp -- and a bf16 ulp near a row's maximum is half an int8
    step: so its bytes are equal but for a few, each one step off. Past layer
    0 the residual stream carries such ulps too, and a row's scale may move:
    there the dequantized rows agree within bf16 tolerance."""
    for got, want, gs, ws in ((cache.k, jcache.k, cache.k_scale, jcache.k_scale),
                              (cache.v, jcache.v, cache.v_scale, jcache.v_scale)):
        got_q, want_q = tensor_to_numpy(got)[..., :pos, :], np.asarray(want)[..., :pos, :]
        assert np.mean(got_q[0] != want_q[0]) < 1e-2
        assert np.abs(got_q[0].astype(np.int32) - want_q[0]).max() <= 1
        deq = got_q * gs[..., :pos, None].float().numpy()
        jdeq = want_q * np.asarray(ws, np.float32)[..., :pos, None]
        compare_tensor(deq, jdeq, "bfloat16", tolerance_multiplier=BF16_DRIFT)
        assert not got[:, :, :, pos:].any() and not gs[..., pos:].any()


@pytest.mark.parametrize("decode_impl", ["flash", "plain"])
def test_int4_weights_int8_cache_forward_matches_jax(decode_impl):
    """Int4 weights, int8 cache: the prefill on the plain path of both, then
    3 decode steps on K4's int8-dot mode (flash: Pallas in interpret mode vs
    the port's plain version) or on the plain dequantized path."""
    before = dk.flash_decode_attention_int8_mxu.launches
    steps, cache, jcache, pos = run_both("int4", "int8", decode_impl)
    assert dk.flash_decode_attention_int8_mxu.launches == before     # CPU: no launch
    for tl, jl in steps:
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        compare_tensor(tl.numpy(), jl, "bfloat16", tolerance_multiplier=BF16_DRIFT)
    assert cache.quantized and cache.k_scale.dtype == torch.bfloat16
    assert_cache_close(cache, jcache, pos)


def test_int8_weights_bf16_cache_forward_matches_jax():
    """The QTensor path (int8 cast to bf16, product, scale) with a bf16 cache
    and the kernels' flash path on the CPU."""
    steps, cache, jcache, pos = run_both("int8", "bf16", "flash")
    for tl, jl in steps:
        compare_tensor(tl.numpy(), jl, "bfloat16", tolerance_multiplier=BF16_DRIFT)
    compare_tensor(cache.k.float().numpy()[:, :, :, :pos],
                   np.asarray(jcache.k, np.float32)[:, :, :, :pos], "bfloat16",
                   tolerance_multiplier=BF16_DRIFT)


def test_int8_cache_create_truncate_and_refusals():
    cfg = ModelArgs(**WIDE)
    c = model.KVCache.create(cfg, 2, 64, device="cpu", dtype=torch.int8)
    assert c.quantized and c.k.dtype == torch.int8
    assert tuple(c.k_scale.shape) == (cfg.n_layers, 2, cfg.kv_heads, 64)
    assert not model.KVCache.create(cfg, 1, 16, device="cpu").quantized
    c.k_scale.fill_(1.0)
    cut = c.truncated(32)
    assert cut.max_seq == 32 and tuple(cut.v_scale.shape) == (cfg.n_layers, 2, cfg.kv_heads, 32)
    cut.k_scale.zero_()
    assert bool((c.k_scale == 1).all())                  # an independent copy
    with pytest.raises(ValueError, match="bf16 or int8"):
        model.KVCache.create(cfg, 1, 16, device="cpu", dtype=torch.float16)
    _, _, _, params = quantized_pair(WIDE, "int4")
    toks = torch.tensor([[1, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="decode-only"):
        model.forward(params, cfg, toks, 0, c, attn_impl="flash")
    with pytest.raises(ValueError, match="flash_folded"):
        model.forward(params, cfg, toks, 0, model.KVCache.create(cfg, 1, 16, device="cpu"),
                      attn_impl="flash_folded")


def cyclic_quantized(jparams):
    """tests/test_torch_engine.py's cyclic model in the checkpoint layout (wo
    and w_down zeroed, head row CYCLE[i] = embedding of CYCLE[i-1]), then
    int4-quantized by the JAX package."""
    layers = dict(jparams.layers)
    layers["wo"] = jnp.zeros_like(layers["wo"])
    layers["w_down"] = jnp.zeros_like(layers["w_down"])
    out = np.zeros(jparams.output.shape, np.float32)
    emb = np.asarray(jparams.tok_embeddings, np.float32)
    for i, tok in enumerate(CYCLE):
        out[tok] = emb[CYCLE[i - 1]]
    return jquant.quantize_params_q4(dataclasses.replace(
        jparams, layers=layers, output=jnp.asarray(out, jnp.bfloat16)))


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_engine_cyclic_int4_tokens_equal_jax(kv):
    spec = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
                multiple_of=32, norm_eps=1e-5, max_sequence_length=128)
    ranks, vocab, jvocab = tokenizers()
    jcfg = JModelArgs(**spec)
    jparams = cyclic_quantized(jax.jit(jmodel.init_random_params, static_argnums=(0,))(
        jcfg, jax.random.PRNGKey(1)))
    jeng = JInferenceEngine(
        JLoadedModel(params=jparams, cfg=jcfg, vocab=jvocab, mergeable_ranks=ranks,
                     tensor_meta={}),
        JInferenceArgs(sequence_length=96, decode_chunk=1, kv_cache_dtype=kv))
    eng = InferenceEngine(
        LoadedModel(params=params_from_numpy(leaves(jparams), "cpu"),
                    cfg=ModelArgs(**spec), vocab=vocab, mergeable_ranks=ranks,
                    tensor_meta={}),
        InferenceArgs(sequence_length=96, kv_cache_dtype=kv), device="cpu")
    got = [t for _, t in eng.generate_tokens(PROMPT, max_new_tokens=16)]
    want = [t for _, t in jeng.generate_tokens(PROMPT, max_new_tokens=16)]
    start = CYCLE.index(PROMPT[-1]) + 1
    assert got == want == [CYCLE[(start + i) % len(CYCLE)] for i in range(16)]
    assert eng.new_cache(1, 32).quantized == (kv == "int8")
