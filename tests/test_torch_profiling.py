"""Profiling of the PyTorch port against the JAX package's
(runtime/profiling.py, tests/test_profiling.py): the narrated forward's
logits, cache and lines against JAX's at ``attn_impl="plain"`` in both
weight layouts, and bit for bit against the port's own ``forward`` (the
same code, a layer at a time) on a bf16 or int8 cache and on quantized
weights; ``StepTimer`` against JAX's; ``device_trace`` writes a trace; the
CLI's ``--narrate`` prints one line a layer plus two."""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.io.params import ModelArgs as JModelArgs
from llama_nuts_and_bolts_tpu.models.llama import model as jmodel
from llama_nuts_and_bolts_tpu.runtime import profiling as jprofiling

from llama_nuts_and_bolts_tpu_torch.cli.main import main as cli_main
from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import params_from_numpy
from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
from llama_nuts_and_bolts_tpu_torch.quant import quantize_params, quantize_params_q4
from llama_nuts_and_bolts_tpu_torch.runtime.profiling import (
    StepTimer,
    device_trace,
    narrated_forward,
)
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests.test_torch_model import leaves

# tests/test_profiling.py's CFG
SPEC = dict(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=64,
            multiple_of=16, max_sequence_length=32)
LINE = re.compile(r"^Transformer block layer (\d+) / (\d+) was run, took \d+\.\d{4} sec\(s\)$")


def pair(seed, fused):
    jcfg = JModelArgs(**SPEC)
    jparams = jax.jit(jmodel.init_random_params, static_argnums=(0,))(
        jcfg, jax.random.PRNGKey(seed))
    if fused:
        jparams = jmodel.fuse_decode_params(jparams)
    return jcfg, jparams, ModelArgs(**SPEC), params_from_numpy(leaves(jparams), "cpu")


@pytest.mark.parametrize("seed,fused,tokens", [(0, False, [3, 1, 4, 1]),
                                               (2, True, [5, 3, 8])])
def test_narrated_forward_matches_jax_and_forward(seed, fused, tokens):
    jcfg, jparams, cfg, params = pair(seed, fused)
    jlines, lines = [], []
    jlogits, jcache = jprofiling.narrated_forward(
        jparams, jcfg, jnp.asarray([tokens], jnp.int32), 0,
        jmodel.KVCache.create(jcfg, 1, 16), jlines.append)
    tok = torch.tensor([tokens], dtype=torch.int32)
    logits, cache = narrated_forward(params, cfg, tok, 0,
                                     KVCache.create(cfg, 1, 16, device="cpu"),
                                     lines.append, attn_impl="plain")
    # tolerance: the bf16 drift bar of tests/test_torch_model.py
    compare_tensor(logits.numpy(), np.asarray(jlogits), "bfloat16", tolerance_multiplier=5.0)
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16",
                       tolerance_multiplier=5.0)
    # the port narrates its own forward: bit for bit
    ref, ref_cache = forward(params, cfg, tok, 0, KVCache.create(cfg, 1, 16, device="cpu"))
    assert torch.equal(logits, ref) and torch.equal(cache.k, ref_cache.k)
    # the lines: embeddings, one a layer, output -- as JAX's
    assert len(lines) == len(jlines) == cfg.n_layers + 2
    for i, (got, want) in enumerate(zip(lines, jlines)):
        strip = lambda s: re.sub(r"took \d+\.\d+", "took", s)  # noqa: E731
        assert strip(got) == strip(want), (got, want)
        if 0 < i <= cfg.n_layers:
            assert LINE.match(got).groups() == (str(i), str(cfg.n_layers))
    assert lines[0].startswith("embeddings: shape(1, %d, 32) dtype=bfloat16" % len(tokens))


@pytest.mark.parametrize("weights,kv", [("bf16", "int8"), ("int8", "bf16"),
                                        ("int4", "int8")])
def test_narration_runs_the_served_code(weights, kv):
    """Quantized weights and an int8 cache go through the same blocks as
    ``forward``'s: logits and cache bit for bit, one token after a prompt
    too (``start_pos`` > 0, ``logits_at``)."""
    spec = dict(SPEC, dim=256, vocab_size=96, multiple_of=256, max_sequence_length=64)
    jcfg = JModelArgs(**spec)
    jparams = jax.jit(jmodel.init_random_params, static_argnums=(0,))(
        jcfg, jax.random.PRNGKey(5))
    cfg, params = ModelArgs(**spec), params_from_numpy(leaves(jparams), "cpu")
    params = {"bf16": lambda p: p, "int8": quantize_params,
              "int4": quantize_params_q4}[weights](params)
    dtype = torch.int8 if kv == "int8" else torch.bfloat16
    caches = [KVCache.create(cfg, 1, 32, device="cpu", dtype=dtype) for _ in range(2)]
    prompt = torch.tensor([[7, 2, 9, 4, 1]], dtype=torch.int32)
    lines = []
    got, _ = narrated_forward(params, cfg, prompt, 0, caches[0], lines.append)
    want, _ = forward(params, cfg, prompt, 0, caches[1])
    assert torch.equal(got, want)
    step = torch.tensor([[11]], dtype=torch.int32)
    got, _ = narrated_forward(params, cfg, step, 5, caches[0], lines.append, logits_at=0)
    want, _ = forward(params, cfg, step, 5, caches[1], logits_at=0)
    assert torch.equal(got, want) and got.shape == (1, 1, 96)
    for a, b in zip((caches[0].k, caches[0].v, caches[0].k_scale),
                    (caches[1].k, caches[1].v, caches[1].k_scale)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert len(lines) == 2 * (cfg.n_layers + 2)


def test_step_timer_summary_matches_jax():
    t, jt = StepTimer(), jprofiling.StepTimer()
    for _ in range(10):
        t.start()
        t.stop()
    s = t.summary()
    assert s["count"] == 10
    assert s["p50_s"] >= 0 and s["p95_s"] >= s["p50_s"] >= 0
    assert StepTimer().summary() == {} == jt.summary()
    jt.samples = list(t.samples)
    assert jt.summary() == s


def test_device_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with device_trace(d) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = [os.path.join(root, f) for root, _, fs in os.walk(d) for f in fs]
    assert len(files) == 1 and files[0].endswith(".json")
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::matmul" in names
    assert any(e.key == "aten::matmul" for e in prof.key_averages())
    with device_trace(d):
        pass
    assert len(os.listdir(d)) == 2             # a second trace, not an overwrite


def test_cli_narrate_prints_one_line_a_layer_and_two(capsys):
    assert cli_main(["--tiny", "--device", "cpu", "--narrate", "--prompt-text", "hello",
                     "--seq-len", "48"]) == 0
    out = capsys.readouterr().out
    narrated = {m.group(0) for m in re.finditer(
        r"(embeddings: shape\(1, \d+, 256\)|Transformer block layer \d / 4 was run|"
        r"output norm\+projection: logits\(1, 1, 512\))", out)}
    assert len(narrated) == 4 + 2
    assert "Finished \x1b[1mby reaching" in out
