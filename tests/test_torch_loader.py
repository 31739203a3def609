"""Checkpoint loader of the PyTorch port: a synthetic Meta-format directory
(tokenizer.model, params.json, a ``torch.save`` consolidated.00.pth) loads
bit-identically to the JAX package's loader, in both weight layouts."""

import base64
import json

import numpy as np
import pytest
import torch

from llama_nuts_and_bolts_tpu.models.llama.loader import (
    load_llama_model as jax_load_llama_model,
)

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import tensor_to_numpy
from llama_nuts_and_bolts_tpu_torch.models.llama.loader import (
    CheckpointShapeError,
    build_params_from_checkpoint,
    expected_tensor_shapes,
    load_llama_model,
    validate_checkpoint,
)

CFG = ModelArgs(dim=32, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=516,
                multiple_of=16, norm_eps=1e-5, max_sequence_length=64)


def checkpoint(cfg, tie_head=False, seed=0):
    gen = torch.Generator().manual_seed(seed)
    sd = {name: (torch.randn(shape, generator=gen) / 8).to(torch.bfloat16)
          for name, shape in expected_tensor_shapes(cfg).items()}
    if tie_head:
        del sd["output.weight"]
    return sd


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """tests/test_torch_ckpt.py's synthetic directory: 260 base ranks + 256
    specials = vocab 516."""
    d = tmp_path_factory.mktemp("ckpt")
    ranks = {bytes([i]): i for i in range(256)}
    for j, tok in enumerate([b"he", b"ll", b"hell", b"hello"]):
        ranks[tok] = 256 + j
    lines = [base64.b64encode(t).decode() + " " + str(r) for t, r in ranks.items()]
    (d / "tokenizer.model").write_text("\n".join(lines) + "\n")
    (d / "params.json").write_text(json.dumps({
        "dim": CFG.dim, "n_layers": CFG.n_layers, "n_heads": CFG.n_heads,
        "n_kv_heads": CFG.n_kv_heads, "vocab_size": CFG.vocab_size,
        "multiple_of": CFG.multiple_of, "norm_eps": CFG.norm_eps}))
    torch.save(checkpoint(CFG), str(d / "consolidated.00.pth"))
    return d


def raw(arr):
    arr = np.ascontiguousarray(np.asarray(arr))
    return arr.view(np.uint16) if arr.dtype.itemsize == 2 else arr


@pytest.mark.parametrize("fused", [False, True])
def test_load_matches_jax_loader_bit_for_bit(model_dir, fused):
    want = jax_load_llama_model(str(model_dir), max_sequence_length=48, fused=fused)
    got = load_llama_model(str(model_dir), max_sequence_length=48, fused=fused,
                           device="cpu")
    assert got.cfg == CFG.with_(max_sequence_length=48)
    assert got.vocab.size == want.vocab.size == 516
    assert got.mergeable_ranks == want.mergeable_ranks
    assert set(got.tensor_meta) == set(want.tensor_meta)
    assert got.tensor_meta["norm.weight"] == ((CFG.dim,), "bfloat16")
    assert set(got.params.layers) == set(want.params.layers)
    for name, t in got.params.layers.items():
        np.testing.assert_array_equal(tensor_to_numpy(t), raw(want.params.layers[name]))
    for name in ("tok_embeddings", "norm", "output", "rope_cos", "rope_sin"):
        np.testing.assert_array_equal(tensor_to_numpy(getattr(got.params, name)),
                                      raw(getattr(want.params, name)))


@pytest.mark.parametrize("quant", ["int4", "int8"])
def test_load_quantized_matches_jax_loader_bit_for_bit(model_dir, quant):
    """quant= quantizes each layer's memory-mapped view on the host: the
    packed bytes and scales equal the JAX loader's, head included."""
    want = jax_load_llama_model(str(model_dir), max_sequence_length=48, quant=quant)
    got = load_llama_model(str(model_dir), max_sequence_length=48, device="cpu",
                           quant=quant)
    fields = ("packed", "scale") if quant == "int4" else ("q", "scale")
    for name, w in got.params.layers.items():
        jw = want.params.layers[name]
        if name.endswith("norm"):
            np.testing.assert_array_equal(tensor_to_numpy(w), raw(jw))
            continue
        for f in fields:
            np.testing.assert_array_equal(tensor_to_numpy(getattr(w, f)), raw(getattr(jw, f)))
    for f in fields:
        np.testing.assert_array_equal(tensor_to_numpy(getattr(got.params.output, f)),
                                      raw(getattr(want.params.output, f)))
    assert got.params.layers["wq"][1].shape == (CFG.n_heads * CFG.head_dim, CFG.dim)
    with pytest.raises(ValueError, match="fused"):
        load_llama_model(str(model_dir), device="cpu", quant=quant, fused=True)
    with pytest.raises(ValueError, match="quant mode"):
        load_llama_model(str(model_dir), device="cpu", quant="int2")
    # a tied head is quantized through the same path
    tied = build_params_from_checkpoint(checkpoint(CFG, tie_head=True), CFG,
                                        device="cpu", quant=quant)
    emb = tied.tok_embeddings
    from llama_nuts_and_bolts_tpu_torch import quant as q

    again = (q.quantize_tensor_q4 if quant == "int4" else q.quantize_tensor)(emb)
    for f in fields:
        assert torch.equal(getattr(tied.output, f), getattr(again, f))


def test_tied_head_and_validation_errors():
    sd = checkpoint(CFG, tie_head=True)
    params = build_params_from_checkpoint(sd, CFG, device="cpu")
    assert torch.equal(params.output, params.tok_embeddings)
    fused = build_params_from_checkpoint(sd, CFG, fused=True, device="cpu")
    assert torch.equal(fused.output, params.tok_embeddings.t())
    bad = dict(sd)
    bad["layers.1.attention.wk.weight"] = torch.zeros(3, 3, dtype=torch.bfloat16)
    with pytest.raises(CheckpointShapeError, match="wk"):
        validate_checkpoint(bad, CFG)
    del bad["norm.weight"]
    with pytest.raises(CheckpointShapeError, match="missing"):
        validate_checkpoint(bad, CFG)


def test_multi_shard_and_cuda_are_refused_here(model_dir, tmp_path):
    """A second shard that is no checkpoint is read as one, and refused: it
    is never skipped. A file whose middle part is not a number is no shard.
    Without a card, a cuda load raises."""
    for name in ("tokenizer.model", "params.json", "consolidated.00.pth"):
        (tmp_path / name).write_bytes((model_dir / name).read_bytes())
    (tmp_path / "consolidated.bak.pth").write_bytes(b"")
    assert load_llama_model(str(tmp_path), device="cpu").params is not None
    (tmp_path / "consolidated.01.pth").write_bytes(b"")
    with pytest.raises((RuntimeError, EOFError)):   # torch.load of an empty file
        load_llama_model(str(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            load_llama_model(str(model_dir))
