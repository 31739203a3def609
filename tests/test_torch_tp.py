"""Tensor parallelism of the PyTorch port on CPU gloo ranks, against the JAX
package's tensor parallelism on the 8-device CPU mesh of tests/conftest.py.

Each spawn (``tests/tp_workers.py``) runs several checks on 2 or 4 ranks
that import only the port; this process holds the JAX side:

  * forward logits of the sharded model -- prefill, decode steps, per-row
    positions, int8 and int4 weights, an int8 cache, the kernels' path (K1,
    K2 and K4's plain versions on each rank's heads) -- against the JAX
    package's ``forward`` on ``shard_params(params, make_mesh(tp))``, within
    the bf16 drift bar of tests/test_torch_model.py (5x the bf16 threshold)
    and a relative L2 error under ``REL_L2_JAX``; within ``REL_L2_SINGLE`` of
    the port's single-device forward; every rank holds the same logits, bit
    for bit;
  * the mesh's shape and errors, the sharded loader against ``shard_params``
    of the whole load, and the engine's refusal of a KV head count tp does
    not divide;
  * the engine's greedy tokens on the constructed-cyclic model at tp 2
    against the unsharded engine and the JAX engine, at ``decode_chunk`` 4
    and with n-gram speculation;
  * the ``--tp 2 --device cpu`` CLI: both ranks exit 0 and rank 0 prints
    the "Finished by" line.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu import quant as jquant
from llama_nuts_and_bolts_tpu.io.params import ModelArgs as JModelArgs
from llama_nuts_and_bolts_tpu.models.llama import model as jmodel
from llama_nuts_and_bolts_tpu.models.llama.loader import LoadedModel as JLoadedModel
from llama_nuts_and_bolts_tpu.parallel import make_mesh as jmake_mesh
from llama_nuts_and_bolts_tpu.parallel import shard_cache as jshard_cache
from llama_nuts_and_bolts_tpu.parallel import shard_params as jshard_params
from llama_nuts_and_bolts_tpu.runtime import InferenceArgs as JInferenceArgs
from llama_nuts_and_bolts_tpu.runtime import InferenceEngine as JInferenceEngine

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama.loader import (
    LoadedModel,
    build_params_from_checkpoint,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import params_from_numpy
from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
from llama_nuts_and_bolts_tpu_torch.parallel.sharding import shard_params_for
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests import tp_workers
from tests.test_torch_engine import CYCLE, PROMPT, tokenizers
from tests.test_torch_quant_model import BF16_DRIFT, leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFWD = jax.jit(jmodel.forward, static_argnums=(1,), static_argnames=("attn_impl",))

# head_dim 16 (the plain path); 8 heads over 4 KV heads, so tp 2 and 4 keep
# whole GQA groups. int4 groups: wo and the head have one (in = 128), which
# _fit_spec replicates on every rank; w_down has two (in = 352), split at
# tp 2 and replicated at tp 4
SPEC = dict(dim=128, n_layers=2, n_heads=8, n_kv_heads=4, vocab_size=96,
            multiple_of=32, norm_eps=1e-5, max_sequence_length=64)
# head_dim 128 and a local G of 4 at tp 2: the kernels' shape
WIDE = dict(dim=1024, n_layers=1, n_heads=8, n_kv_heads=2, vocab_size=96,
            multiple_of=32, norm_eps=1e-5, max_sequence_length=256)
# relative L2 errors of the port's tp logits the tests accept: against the
# port's own single-device forward (readings 0 to 1.1e-4: most steps are
# bit-equal), and against the JAX package's tp forward (readings 4.8e-3 to
# 1.45e-2, each equal to the single-device port's own distance from it)
REL_L2_SINGLE = 1e-3
REL_L2_JAX = 2e-2


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_params(spec, quant=None, seed=0):
    jcfg = JModelArgs(**spec)
    jparams = jax.jit(jmodel.init_random_params, static_argnums=(0,))(
        jcfg, jax.random.PRNGKey(seed))
    if quant == "int8":
        jparams = jquant.quantize_params(jparams)
    elif quant == "int4":
        jparams = jquant.quantize_params_q4(jparams)
    return jcfg, jparams


def forward_case(spec, tp, quant=None, cache="bf16", impl="plain", decode=3,
                 batch=1, per_row=False, T=32):
    """The JAX tp reference of one case and the port's payload for it: a
    7-token prefill, then ``decode`` greedy steps (the JAX tokens feed
    both), or with ``per_row`` one decode step at per-row positions."""
    jcfg, jparams = jax_params(spec, quant)
    mesh = jmake_mesh(tp=tp)
    jsharded = jshard_params(jparams, mesh)
    jdt, dt = (jnp.int8, torch.int8) if cache == "int8" else (jnp.bfloat16, torch.bfloat16)
    jcache = jshard_cache(jmodel.KVCache.create(jcfg, batch, T, dtype=jdt), mesh)
    rng = np.random.default_rng(tp)
    toks = rng.integers(0, spec["vocab_size"], (batch, 7)).tolist()
    steps, want, pos = [], [], 0
    for step in range(decode + 1):
        if per_row and step == 1:
            start = np.array([7, 4][:batch], np.int32)
            jl, jcache = JFWD(jsharded, jcfg, jnp.asarray(toks, jnp.int32),
                              jnp.asarray(start), jcache, attn_impl="xla")
            steps.append((torch.tensor(toks, dtype=torch.int32),
                          torch.from_numpy(start), "plain"))
            want.append(np.asarray(jl))
            break
        jl, jcache = JFWD(jsharded, jcfg, jnp.asarray(toks, jnp.int32), pos, jcache,
                          attn_impl="xla")
        step_impl = "plain" if step == 0 and cache == "int8" else impl
        steps.append((torch.tensor(toks, dtype=torch.int32), pos, step_impl))
        want.append(np.asarray(jl))
        pos += len(toks[0])
        toks = np.asarray(jl)[:, -1].argmax(-1)[:, None].tolist()
    case = {"params": params_from_numpy(leaves(jparams), "cpu"), "cfg": ModelArgs(**spec),
            "batch": batch, "T": T, "cache_dtype": dt, "steps": steps}
    return case, want


def single_device(case):
    """The case's logits through the port's forward without a mesh."""
    cache = KVCache.create(case["cfg"], case["batch"], case["T"], device="cpu",
                           dtype=case["cache_dtype"])
    out = []
    for tokens, start_pos, impl in case["steps"]:
        logits, cache = forward(case["params"], case["cfg"], tokens, start_pos, cache,
                                attn_impl=impl)
        out.append(logits)
    return out


def check_forward(results, cases, want):
    for name, jlogits in want.items():
        got = results[0][name]
        for r in range(1, len(results)):
            for a, b in zip(got, results[r][name]):
                assert torch.equal(a, b), f"{name}: rank {r}'s logits differ from rank 0's"
        for step, (tl, jl, sl) in enumerate(zip(got, jlogits, single_device(cases[name]))):
            assert tl.dtype == torch.float32 and tl.shape == jl.shape, name
            compare_tensor(tl.numpy(), jl, "bfloat16", tolerance_multiplier=BF16_DRIFT)
            err = rel_l2(tl.numpy(), jl)
            assert err < REL_L2_JAX, f"{name} step {step}: relative L2 {err:.3e} to JAX"
            err = rel_l2(tl.numpy(), sl.numpy())
            assert err < REL_L2_SINGLE, f"{name} step {step}: relative L2 {err:.3e} to tp 1"


def test_tp2_forward_matches_jax_tp(tmp_path):
    """tp 2: bf16, per-row positions, int8 and int4 weights with an int8
    cache, and the kernels' path at head_dim 128 (K1 prefill, K2 and K4
    decode, each rank's plain versions)."""
    cases, want = {}, {}
    for name, kw in (("bf16", {}), ("per_row", dict(batch=2, per_row=True)),
                     ("int8", dict(quant="int8")),
                     ("int4_kv8", dict(quant="int4", cache="int8")),
                     ("flash", dict(spec=WIDE, impl="flash", decode=2, T=128)),
                     ("flash_kv8", dict(spec=WIDE, impl="flash", cache="int8", decode=2,
                                        T=128))):
        cases[name], want[name] = forward_case(kw.pop("spec", SPEC), 2, **kw)
    results = tp_workers.spawn({"forward": {"cases": cases}}, 2, tmp_path)
    check_forward([r["forward"] for r in results], cases, want)


def test_tp4_forward_and_engine_match_jax_tp(tmp_path):
    """tp 4: forward with bf16, int8 weights, and int4 weights (w_down
    replicated by _fit_spec as well) with an int8 cache; and the engine's
    greedy tokens on the cyclic model, every rank in lockstep, equal to the
    JAX engine's."""
    cases, want = {}, {}
    for name, kw in (("bf16", {}), ("int8", dict(quant="int8")),
                     ("int4_kv8", dict(quant="int4", cache="int8"))):
        cases[name], want[name] = forward_case(SPEC, 4, **kw)
    spec = dict(SPEC, vocab_size=512)
    engine, jwant = cyclic_engine_job(spec, {"chunk4": dict(sequence_length=48,
                                                            decode_chunk=4)})
    results = tp_workers.spawn({"forward": {"cases": cases}, "engine": engine}, 4, tmp_path)
    check_forward([r["forward"] for r in results], cases, want)
    for r, res in enumerate(results):
        assert res["engine"]["chunk4"] == jwant, r


def checkpoint(cfg, seed=0):
    """A bf16 checkpoint's tensors (name -> tensor) at ``cfg``'s shapes."""
    from llama_nuts_and_bolts_tpu_torch.models.llama.loader import expected_tensor_shapes

    gen = torch.Generator().manual_seed(seed)
    return {name: (torch.randn(shape, generator=gen) * 0.1).to(torch.bfloat16)
            for name, shape in expected_tensor_shapes(cfg).items()}


def bytes_of(leaf):
    if dataclasses.is_dataclass(leaf):
        return [bytes_of(getattr(leaf, f.name)) for f in dataclasses.fields(leaf)]
    return leaf.contiguous().view(torch.uint8).numpy().tobytes() if leaf.dtype != torch.uint8 \
        else leaf.contiguous().numpy().tobytes()


def params_bytes(p):
    return {"layers": {k: bytes_of(v) for k, v in p.layers.items()},
            **{k: bytes_of(getattr(p, k)) for k in ("tok_embeddings", "norm", "output",
                                                     "rope_cos", "rope_sin")}}


def test_mesh_loader_and_refusal_on_two_ranks(tmp_path):
    """The (dp, sp, tp) mesh and its errors (dp and sp name item 17b), the
    sharded loader on every rank byte-equal to ``shard_params`` of the whole
    load (bf16, int8 and int4), a mesh forward's refusal of whole params,
    and the engine's refusal of a model of 1 KV head at tp 2."""
    cfg = ModelArgs(**SPEC)
    tensors = checkpoint(cfg)
    odd_cfg = ModelArgs(**dict(SPEC, n_heads=2, n_kv_heads=1, dim=64))
    from llama_nuts_and_bolts_tpu_torch.models.llama import init_random_params

    odd = LoadedModel(params=init_random_params(odd_cfg, device="cpu"), cfg=odd_cfg,
                      vocab=None, mergeable_ranks={}, tensor_meta={})
    results = tp_workers.spawn({"mesh": {"tensors": tensors, "cfg": cfg,
                                         "odd_model": odd}}, 2, tmp_path)
    for r, res in enumerate(r["mesh"] for r in results):
        assert res["shape"] == (1, 1, 2) and res["names"] == ("dp", "sp", "tp")
        assert res["rank"] == r and res["tp"] == 2
        assert res["errors"]["tp3"] == ("ValueError: dp(1) * sp(1) * tp(3) "
                                        "incompatible with device count (2)")
        for axis in ("dp2", "sp2"):
            assert res["errors"][axis].startswith("NotImplementedError") and \
                "ROADMAP item 17b" in res["errors"][axis]
        assert "tp=2 must divide the KV heads (1)" in res["refusal"]
        assert "shard the params" in res["whole_params"]
        for quant, got in res["loads"].items():
            whole = build_params_from_checkpoint(tensors, cfg, device="cpu", quant=quant)
            assert params_bytes(got) == params_bytes(shard_params_for(whole, r, 2)), quant


def cyclic_unfused(jparams):
    """tests/test_torch_engine.py's cyclic model in the split layout (the
    head is [vocab, dim]): wo and w_down zeroed, head row CYCLE[i] holds the
    embedding of CYCLE[i-1]."""
    layers = dict(jparams.layers)
    layers["wo"] = jnp.zeros_like(layers["wo"])
    layers["w_down"] = jnp.zeros_like(layers["w_down"])
    out = np.zeros(jparams.output.shape, np.float32)
    emb = np.asarray(jparams.tok_embeddings, np.float32)
    for i, tok in enumerate(CYCLE):
        out[tok] = emb[CYCLE[i - 1]]
    return dataclasses.replace(jparams, layers=layers, output=jnp.asarray(out, jnp.bfloat16))


def cyclic_engine_job(spec, args):
    """The engine job's payload on the cyclic model at ``spec`` (each of
    ``args`` an InferenceArgs set), and the JAX engine's greedy tokens,
    which every set must give; the unsharded port engine's are checked
    against them here."""
    ranks, vocab, jvocab = tokenizers()
    jcfg = JModelArgs(**spec)
    jparams = cyclic_unfused(jax.jit(jmodel.init_random_params, static_argnums=(0,))(
        jcfg, jax.random.PRNGKey(1)))
    model = LoadedModel(params=params_from_numpy(leaves(jparams), "cpu"),
                        cfg=ModelArgs(**spec), vocab=vocab, mergeable_ranks=ranks,
                        tensor_meta={})
    jeng = JInferenceEngine(JLoadedModel(params=jparams, cfg=jcfg, vocab=jvocab,
                                         mergeable_ranks=ranks, tensor_meta={}),
                            JInferenceArgs(sequence_length=48, decode_chunk=1))
    want = [t for _, t in jeng.generate_tokens(PROMPT)]
    assert want[:len(CYCLE)] == [CYCLE[(i + 1) % len(CYCLE)] for i in range(len(CYCLE))]
    for name, a in args.items():
        tp1 = [t for _, t in InferenceEngine(model, InferenceArgs(**a),
                                             device="cpu").generate_tokens(PROMPT)]
        assert tp1 == want, name
    return {"model": model, "args": args, "prompt": PROMPT}, want


def test_tp2_engine_tokens_equal_tp1_and_jax(tmp_path):
    """Greedy tokens on the cyclic model at tp 2 (per token, decode_chunk 4,
    n-gram speculation k = 4) equal the unsharded port engine's and the JAX
    engine's, exactly."""
    args = {"chunk1": dict(sequence_length=48, decode_chunk=1),
            "chunk4": dict(sequence_length=48, decode_chunk=4),
            "spec4": dict(sequence_length=48, speculate_k=4)}
    payload, want = cyclic_engine_job(dict(SPEC, vocab_size=512, n_heads=4, n_kv_heads=2,
                                           dim=64), args)
    results = tp_workers.spawn({"engine": payload}, 2, tmp_path)
    for name in args:
        for r, res in enumerate(results):
            assert res["engine"][name] == want, (name, r)


def test_tp2_cli_on_cpu_exits_cleanly():
    """``--tiny --device cpu --tp 2 --decode-chunk 4``: rank 0 prints the
    transcript and the "Finished by" line, and both ranks exit 0 (rank 0
    returns nonzero when a follower fails). The transcript itself is not
    compared with a single-device run's: that run fuses its layout, and on
    random weights another summation order flips near-tied tokens."""
    cmd = [sys.executable, "-m", "llama_nuts_and_bolts_tpu_torch.cli", "--tiny",
           "--device", "cpu", "--tp", "2", "--prompt-text", "hello", "--seq-len", "40",
           "--decode-chunk", "4"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "Tensor parallelism: tp=2 over 2 devices." in run.stdout
    assert "Finished \x1b[1mby reaching" in run.stdout
    assert run.stdout.count("Welcome to Llama") == 1      # followers print nothing


def test_tp_on_cuda_without_cards_raises():
    """``--tp 2`` on ``cuda`` (the default) where there is no card raises
    before any rank starts: nothing falls back to the CPU or to fewer ranks."""
    from llama_nuts_and_bolts_tpu_torch.cli.main import main
    from llama_nuts_and_bolts_tpu_torch.parallel.launch import check_cards

    if torch.cuda.is_available():
        pytest.skip("this machine has a card (tests/test_torch_gpu.py checks the count)")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--tiny", "--tp", "2", "--prompt-text", "hi"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_cards(2, "cuda")
    check_cards(2, "cpu")
