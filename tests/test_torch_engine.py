"""Engine of the PyTorch port against the JAX package's engine.

On a constructed-cyclic model (wo and w_down zeroed, so attention cannot
change the logits, and head rows that walk a fixed token cycle) the greedy
token stream and every GeneratedPart must be equal, through the prefix
cache and chunked prefill too. On random weights the prefill and first
decode logits are compared within bf16 tolerance instead, since near-tied
argmaxes make token equality there a matter of ulps."""

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
from llama_nuts_and_bolts_tpu.tokenizer import TiktokenModel as JTiktokenModel
from llama_nuts_and_bolts_tpu.tokenizer import Vocabulary as JVocabulary

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import params_from_numpy
from llama_nuts_and_bolts_tpu_torch.models.llama.loader import LoadedModel
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.runtime.paged import default_attn_impl
from llama_nuts_and_bolts_tpu_torch.tokenizer import TiktokenModel, Vocabulary
from llama_nuts_and_bolts_tpu_torch.tokenizer.tiktoken_io import build_special_tokens
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor

SPEC = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
            multiple_of=32, norm_eps=1e-5, max_sequence_length=128)
# "Hey", the three bytes of the euro sign (the detokenizer holds them back
# until the codepoint completes) and "!": distinct ids, so each has one
# successor
CYCLE = [72, 101, 121, 0xE2, 0x82, 0xAC, 33]
PROMPT = [3, 7, 9, 1, 72, 101, 121, 0xE2, 0x82, 0xAC, 33, 72]


def tokenizers():
    """Byte-level ranks (256) + 256 specials = vocab 512, in both packages."""
    ranks = {bytes([i]): i for i in range(256)}
    special = build_special_tokens(len(ranks))
    kw = dict(mergeable_ranks=ranks, special_tokens=special,
              bos_id=special["<|begin_of_text|>"], eos_id=special["<|end_of_text|>"],
              stop_token_ids=[special["<|eom_id|>"], special["<|eot_id|>"]])
    return (ranks, Vocabulary.from_tiktoken(TiktokenModel(**kw)),
            JVocabulary.from_tiktoken(JTiktokenModel(**kw)))


def cyclic(jparams):
    """Zero wo and w_down; head column CYCLE[i] holds the embedding of
    CYCLE[i-1] (fused layout: the head is [dim, vocab])."""
    layers = dict(jparams.layers)
    layers["wo"] = jnp.zeros_like(layers["wo"])
    layers["w_down"] = jnp.zeros_like(layers["w_down"])
    out = np.zeros(jparams.output.shape, np.float32)
    emb = np.asarray(jparams.tok_embeddings, np.float32)
    for i, tok in enumerate(CYCLE):
        out[:, tok] = emb[CYCLE[i - 1]]
    return dataclasses.replace(jparams, layers=layers,
                               output=jnp.asarray(out, jnp.bfloat16))


def leaves(p):
    return {"tok_embeddings": np.asarray(p.tok_embeddings),
            "layers": {k: np.asarray(v) for k, v in p.layers.items()},
            "norm": np.asarray(p.norm), "output": np.asarray(p.output),
            "rope_cos": np.asarray(p.rope_cos), "rope_sin": np.asarray(p.rope_sin)}


def engines(make_cyclic, **args):
    ranks, vocab, jvocab = tokenizers()
    jcfg = JModelArgs(**SPEC)
    jparams = jmodel.fuse_decode_params(jax.jit(
        jmodel.init_random_params, static_argnums=(0,))(jcfg, jax.random.PRNGKey(1)))
    if make_cyclic:
        jparams = cyclic(jparams)
    jeng = JInferenceEngine(
        JLoadedModel(params=jparams, cfg=jcfg, vocab=jvocab, mergeable_ranks=ranks,
                     tensor_meta={}),
        JInferenceArgs(sequence_length=96, decode_chunk=1, **args))
    eng = InferenceEngine(
        LoadedModel(params=params_from_numpy(leaves(jparams), "cpu"),
                    cfg=ModelArgs(**SPEC), vocab=vocab, mergeable_ranks=ranks,
                    tensor_meta={}),
        InferenceArgs(sequence_length=96, **args), device="cpu")
    return eng, jeng


def part_fields(part):
    return (part.token_id, part.token.piece, part.token.is_byte, part.decoded_string,
            part.added_to_waiting, part.waiting_runes_extra_str,
            part.generation_state.name, part.is_resend_of_waiting)


@pytest.mark.parametrize("args", [{}, {"prefill_chunk": 5}])
def test_cyclic_token_stream_and_parts_equal_jax(args):
    eng, jeng = engines(True, **args)
    got = [(s.name, t) for s, t in eng.generate_tokens(PROMPT, max_new_tokens=20)]
    want = [(s.name, t) for s, t in jeng.generate_tokens(PROMPT, max_new_tokens=20)]
    assert got == want
    start = CYCLE.index(PROMPT[-1]) + 1
    assert [t for _, t in got] == [CYCLE[(start + i) % len(CYCLE)] for i in range(20)]
    # streaming to the sequence-length horizon, with the detokenizer's
    # waiting bytes, finish state and the final flush
    parts = [part_fields(p) for p in eng.generate_string(PROMPT)]
    jparts = [part_fields(p) for p in jeng.generate_string(PROMPT)]
    assert parts == jparts
    assert parts[-1][6] == "FINISHED_BY_REACHING_SEQ_LEN"
    assert "€" in "".join(p[3] for p in parts)


def test_cyclic_prefix_cache_equal_jax():
    eng, jeng = engines(True)
    for e in (eng, jeng):
        e.cache_prefix(PROMPT[:7])
    for prompt in (PROMPT, PROMPT[:7], PROMPT[:10]):
        got = [t for _, t in eng.generate_tokens(prompt, max_new_tokens=12)]
        want = [t for _, t in jeng.generate_tokens(prompt, max_new_tokens=12)]
        assert got == want
    # the snapshot is copied per use: a second request sees the same state
    again = [t for _, t in eng.generate_tokens(PROMPT, max_new_tokens=12)]
    assert again == [t for _, t in jeng.generate_tokens(PROMPT, max_new_tokens=12)]


def test_scripted_token_replay_parts_equal_jax():
    """generate_string_from_output_tokens: a split 4-byte emoji, a lone
    continuation byte that never completes (flushed as <0xNN>), ASCII."""
    eng, jeng = engines(False)
    script = [72, 0xF0, 0x9F, 0x98, 0x80, 33, 0x80, 0xE2, 0x82]
    parts = [part_fields(p) for p in eng.generate_string_from_output_tokens(script)]
    jparts = [part_fields(p) for p in jeng.generate_string_from_output_tokens(script)]
    assert parts == jparts
    assert "😀" in "".join(p[3] for p in parts)
    assert any(p[7] for p in parts)             # resent waiting parts at the end


def test_random_weights_prefill_and_first_decode_logits_match_jax():
    eng, jeng = engines(False)
    cache_len = eng.cache_bucket(len(PROMPT), 8)
    assert cache_len == jeng.cache_bucket(len(PROMPT), 8)
    logits, cache = eng._prefill(PROMPT, cache_len)
    jlogits, jcache = jeng._prefill(PROMPT, cache_len)
    compare_tensor(logits.numpy(), np.asarray(jlogits), "bfloat16", tolerance_multiplier=5.0)
    tok = int(np.argmax(np.asarray(jlogits)[0, 0]))
    logits, _ = eng._forward([[tok]], len(PROMPT), cache)
    jlogits, _ = jeng._fwd(jeng.model.params, jeng.model.cfg,
                           jnp.asarray([[tok]], jnp.int32), len(PROMPT), jcache,
                           attn_impl="xla", mesh=None)
    # tolerance: the bf16 drift bar of tests/test_torch_model.py
    compare_tensor(logits.numpy(), np.asarray(jlogits), "bfloat16", tolerance_multiplier=5.0)


def test_attention_choice_and_refusals():
    eng, _ = engines(False)
    assert eng._attn_impl() == "plain"           # CPU, head_dim 16
    assert eng._attn_impl(7, 256) == "plain"
    for bad, exc in (({"kv_cache_dtype": "fp8"}, ValueError),
                     ({"attn_impl": "xla"}, ValueError),
                     ({"attn_impl": "flash"}, ValueError)):   # head_dim 16
        with pytest.raises(exc):
            InferenceEngine(eng.model, InferenceArgs(**bad), device="cpu")
    # probe is accepted: on the CPU it has one candidate, the plain path
    probing = InferenceEngine(eng.model, InferenceArgs(attn_impl="probe"), device="cpu")
    assert probing._attn_impl() == "plain" and probing._probe_timings == {"plain": 0.0}
    # decode_chunk is accepted (the chunks are decode graphs); 0 is auto, 1
    for chunk, k in ((4, 4), (0, 1), (1, 1)):
        chunked = InferenceEngine(eng.model, InferenceArgs(decode_chunk=chunk),
                                  device="cpu")
        assert chunked._decode_chunk_size() == k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            InferenceEngine(eng.model, InferenceArgs())


@pytest.mark.parametrize("kv,impl,want", [
    # (kv cache, attn_impl) -> {(seq_len, cache_len): path} on a card
    ("bf16", "auto", {(1, 256): "flash", (64, 256): "flash", (1, 200): "flash"}),
    ("int8", "auto", {(1, 256): "flash", (64, 256): "plain", (1, 200): "plain"}),
    ("int8", "flash", {(1, 200): "flash", (64, 256): "plain"}),
    ("bf16", "flash_folded", {(1, 256): "flash_folded", (64, 256): "flash"}),
    ("int8", "flash_folded", {(1, 256): "flash_folded", (64, 256): "plain"}),
    ("int8", "plain", {(1, 256): "plain"})])
def test_attention_rules_follow_the_jax_engine(kv, impl, want):
    """engine.py:173-188 of the JAX package: an int8 cache decodes on the
    kernel only at S = 1 with a cache length that is a multiple of 128 and
    prefills on the plain path, even when flash is forced. The rules are read
    for a card: the engine's device is set to one without running on it."""
    eng, _ = engines(False, kv_cache_dtype=kv, attn_impl="plain")
    eng.args.attn_impl = impl
    eng.device = torch.device("cuda", 0)
    # head_dim 128 and G = 4: the kernels' shape
    eng.model.cfg = dataclasses.replace(eng.model.cfg, dim=512, n_kv_heads=1)
    assert eng._kernels_viable()
    for (seq_len, cache_len), path in want.items():
        assert eng._attn_impl(seq_len, cache_len) == path


@pytest.mark.parametrize("G", [3, 4, 8])
@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_auto_takes_the_kernels_only_at_their_shape(G, head_dim):
    """The attention kernels are built for head_dim 128 and G = H/KV = 4
    only (a Llama-3.2-3B has G = 3, a 70B G = 8): on a card, ``auto`` takes
    them for that shape alone, the dense and paged paths alike, and a forced
    ``flash`` or ``flash_folded`` is refused at construction, naming head_dim
    and G. The rules are read for a card without running on it."""
    eng, _ = engines(False, attn_impl="plain")
    cfg = dataclasses.replace(eng.model.cfg, n_heads=G * 2, n_kv_heads=2,
                              dim=G * 2 * head_dim)
    assert (cfg.head_dim, cfg.n_rep) == (head_dim, G)
    model = dataclasses.replace(eng.model, cfg=cfg)
    eng.model, eng.args.attn_impl = model, "auto"
    eng.device = torch.device("cuda", 0)
    viable = head_dim == 128 and G == 4
    assert eng._kernels_viable() == viable
    want = "flash" if viable else "plain"
    assert (eng._attn_impl(1, 256), eng._attn_impl(64, 256)) == (want, want)
    assert default_attn_impl(eng) == want
    for impl in ("flash", "flash_folded"):
        if viable:
            InferenceEngine(model, InferenceArgs(attn_impl=impl), device="cpu")
            continue
        with pytest.raises(ValueError, match=f"head_dim {head_dim} and G = {G}$"):
            InferenceEngine(model, InferenceArgs(attn_impl=impl), device="cpu")
