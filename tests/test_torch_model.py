"""Forward pass of the PyTorch port against the JAX package's: the weight
bridge is bit-exact, and logits and KV-cache contents agree within bf16
tolerance for a prefill and 8 decode steps, in both weight layouts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.io.params import ModelArgs as JModelArgs
from llama_nuts_and_bolts_tpu.models.llama import model as jmodel

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama import model
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import (
    params_from_numpy,
    tensor_to_numpy,
)
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor

JFWD = jax.jit(jmodel.forward, static_argnums=(1,), static_argnames=("attn_impl",))

# tests/test_model.py's TINY config (head_dim 16: the plain path)
TINY = dict(dim=64, n_layers=3, n_heads=4, n_kv_heads=2, vocab_size=96,
            multiple_of=32, ffn_dim_multiplier=1.3, norm_eps=1e-5,
            rope_theta=500000.0, use_scaled_rope=True, max_sequence_length=64)
# head_dim 128: the kernels' width, for the flash path
WIDE = dict(dim=256, n_layers=2, n_heads=2, n_kv_heads=1, vocab_size=96,
            multiple_of=32, norm_eps=1e-5, max_sequence_length=64)


def leaves(params):
    return {"tok_embeddings": np.asarray(params.tok_embeddings),
            "layers": {k: np.asarray(v) for k, v in params.layers.items()},
            "norm": np.asarray(params.norm), "output": np.asarray(params.output),
            "rope_cos": np.asarray(params.rope_cos),
            "rope_sin": np.asarray(params.rope_sin)}


def make_pair(spec, fused, seed=0, dtype=jnp.bfloat16):
    jcfg = JModelArgs(**spec)
    jparams = jax.jit(jmodel.init_random_params, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(seed), dtype)
    if fused:
        jparams = jmodel.fuse_decode_params(jparams)
    return jcfg, jparams, ModelArgs(**spec), params_from_numpy(leaves(jparams), "cpu")


def bits(a):
    return np.ascontiguousarray(a).view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("fused", [False, True])
def test_weight_bridge_is_bit_exact(fused):
    _, jparams, _, params = make_pair(TINY, fused)
    want = leaves(jparams)
    for name, t in params.layers.items():
        np.testing.assert_array_equal(tensor_to_numpy(t), bits(want["layers"][name]))
    for name in ("tok_embeddings", "norm", "output", "rope_cos", "rope_sin"):
        np.testing.assert_array_equal(bits(tensor_to_numpy(getattr(params, name))),
                                      bits(want[name]))
    assert params.output.dtype == torch.bfloat16
    assert params.rope_cos.dtype == torch.float32


def run_both(spec, fused, attn_impl, decode_steps=8, prompt=(5, 17, 42, 7, 9, 2, 6),
             dtype=jnp.bfloat16):
    """Prefill + greedy decode steps through both forwards (the JAX one on
    its plain XLA path); returns per-step (port, jax) logits and caches."""
    jcfg, jparams, cfg, params = make_pair(spec, fused, dtype=dtype)
    T = 32
    jcache = jmodel.KVCache.create(jcfg, 1, T, dtype=dtype)
    cache = model.KVCache.create(cfg, 1, T, device="cpu")
    if dtype == jnp.float32:
        cache = model.KVCache(k=cache.k.float(), v=cache.v.float())
    steps = []
    toks, pos = list(prompt), 0
    for step in range(decode_steps + 1):
        jl, jcache = JFWD(jparams, jcfg, jnp.asarray([toks], jnp.int32), pos, jcache)
        tl, cache = model.forward(params, cfg, torch.tensor([toks], dtype=torch.int32),
                                  pos, cache, attn_impl=attn_impl)
        steps.append((tl, np.asarray(jl)))
        pos += len(toks)
        toks = [int(np.argmax(np.asarray(jl)[0, -1]))]
    return steps, (cache, jcache), pos


# bf16 activations round at the same places in both packages, but fp32 sums
# taken in another order flip some roundings by one ulp, and a tiny model
# (dim 64) feels each flip: the repo's own bf16 parity bar for this config
# against an independent PyTorch forward is rtol 5e-2 / atol 8e-2
# (tests/test_model.py::test_prefill_logits_match_oracle); here 5x the bf16
# threshold. With fp32 weights the same forward must agree to fp32's 1e-3.
BF16_DRIFT = 5.0


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype,mult", [(jnp.bfloat16, BF16_DRIFT), (jnp.float32, 1.0)])
def test_forward_prefill_and_8_decode_steps_match_jax(fused, dtype, mult):
    steps, (cache, jcache), pos = run_both(TINY, fused, "plain", dtype=dtype)
    kind = "bfloat16" if dtype == jnp.bfloat16 else "float32"
    for tl, jl in steps:
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        compare_tensor(tl.numpy(), jl, kind, tolerance_multiplier=mult)
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        compare_tensor(got.float().numpy()[:, :, :, :pos],
                       np.asarray(want, np.float32)[:, :, :, :pos], kind,
                       tolerance_multiplier=mult)
        # nothing written past the last position
        assert not got[:, :, :, pos:].any()


def test_forward_flash_on_cpu_matches_jax_at_kernel_width():
    """attn_impl="flash" at head_dim 128 runs the kernels' plain versions on
    the CPU (K1 for the prefill, K2 for each decode step)."""
    steps, (cache, jcache), pos = run_both(WIDE, True, "flash", decode_steps=3)
    for tl, jl in steps:
        compare_tensor(tl.numpy(), jl, "bfloat16", tolerance_multiplier=BF16_DRIFT)
    compare_tensor(cache.k.float().numpy()[:, :, :, :pos],
                   np.asarray(jcache.k, np.float32)[:, :, :, :pos], "bfloat16",
                   tolerance_multiplier=BF16_DRIFT)


def test_logits_at_and_bad_arguments():
    _, _, cfg, params = make_pair(TINY, False)
    cache = model.KVCache.create(cfg, 1, 16, device="cpu")
    toks = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    full, _ = model.forward(params, cfg, toks, 0, cache)
    one, _ = model.forward(params, cfg, toks, 0,
                           model.KVCache.create(cfg, 1, 16, device="cpu"), logits_at=2)
    assert one.shape == (1, 1, cfg.vocab_size)
    torch.testing.assert_close(one[0, 0], full[0, 2])
    with pytest.raises(ValueError, match="attn_impl"):
        model.forward(params, cfg, toks, 0, cache, attn_impl="xla")
    with pytest.raises(ValueError, match="cache length"):
        model.forward(params, cfg, toks, 14, cache)
    int8 = model.KVCache.create(cfg, 1, 16, device="cpu", dtype=torch.int8)
    assert int8.quantized and int8.k_scale.shape == int8.k.shape[:-1]
    with pytest.raises(ValueError, match="bf16 or int8"):
        model.KVCache.create(cfg, 1, 16, device="cpu", dtype=torch.float16)


def test_init_random_params_shapes_and_seed():
    cfg = ModelArgs(**TINY)
    a = model.init_random_params(cfg, seed=3, device="cpu")
    b = model.init_random_params(cfg, seed=3, device="cpu", fused=True)
    for name, shape in model.layer_weight_shapes(cfg).items():
        assert tuple(a.layers[name].shape) == (cfg.n_layers,) + shape
    for name, shape in model.fused_layer_weight_shapes(cfg).items():
        assert tuple(b.layers[name].shape) == (cfg.n_layers,) + shape
    assert tuple(b.output.shape) == (cfg.dim, cfg.vocab_size)
    again = model.init_random_params(cfg, seed=3, device="cpu")
    assert torch.equal(a.layers["wq"], again.layers["wq"])
    fused = model.fuse_decode_params(a)
    assert torch.equal(fused.layers["wqkv"][:, :, :cfg.dim], a.layers["wq"].transpose(1, 2))
    assert torch.equal(fused.output, a.output.t())
