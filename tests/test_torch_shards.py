"""Meta's multi-shard checkpoints in the PyTorch port (``io/shards.py`` and
the loader) against the JAX package's (``io/torch_ckpt.py``,
tests/test_sharded_ckpt.py's cases): the concatenation axis of every
tensor name, the shard filter, sharded tensors equal to the full ones, a
forward on the sharded load against the JAX forward on JAX's sharded load,
and ``load_llama_model`` of a shard directory equal to the single-file
load (and to the JAX loader's) in every weight layout."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.io.torch_ckpt import (
    find_checkpoint_shards as jax_find_checkpoint_shards,
)
from llama_nuts_and_bolts_tpu.io.torch_ckpt import (
    load_sharded_checkpoint as jax_load_sharded_checkpoint,
)
from llama_nuts_and_bolts_tpu.io.torch_ckpt import shard_concat_axis as jax_shard_concat_axis
from llama_nuts_and_bolts_tpu.models.llama import (
    build_params_from_checkpoint as jax_build_params_from_checkpoint,
)
from llama_nuts_and_bolts_tpu.models.llama import forward as jax_forward
from llama_nuts_and_bolts_tpu.models.llama.loader import (
    load_llama_model as jax_load_llama_model,
)
from llama_nuts_and_bolts_tpu.models.llama.model import KVCache as JKVCache

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.io.shards import (
    ShardedTensor,
    find_checkpoint_shards,
    load_sharded_checkpoint,
    shard_concat_axis,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import tensor_to_numpy
from llama_nuts_and_bolts_tpu_torch.models.llama.loader import (
    CheckpointShapeError,
    build_params_from_checkpoint,
    expected_tensor_shapes,
    load_llama_model,
    validate_checkpoint,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests.test_sharded_ckpt import TINY as JTINY
from tests.test_sharded_ckpt import make_torch_weights, split_meta_style
from tests.test_torch_loader import model_dir, raw  # noqa: F401 (a fixture)

TINY = ModelArgs(**{f: getattr(JTINY, f) for f in (
    "dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size", "multiple_of",
    "ffn_dim_multiplier", "norm_eps", "rope_theta", "use_scaled_rope",
    "max_sequence_length")})


def save_shards(weights, d, n_shards=2):
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, shard in enumerate(split_meta_style(weights, n_shards)):
        paths.append(os.path.join(d, f"consolidated.{i:02d}.pth"))
        torch.save(shard, paths[-1])
    return paths


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    """tests/test_sharded_ckpt.py's fixture: its tiny model over two shards."""
    d = str(tmp_path_factory.mktemp("shards"))
    weights = make_torch_weights(JTINY, seed=11)
    save_shards(weights, d)
    return d, weights


def test_axis_rule_for_every_tensor_name():
    names = list(expected_tensor_shapes(TINY)) + ["rope.freqs", "layers.31.attention.wo.weight",
                                                  "unknown.weight"]
    for name in names:
        assert shard_concat_axis(name) == jax_shard_concat_axis(name), name
    assert shard_concat_axis("layers.0.attention.wq.weight") == 0
    assert shard_concat_axis("layers.2.feed_forward.w2.weight") == 1
    assert shard_concat_axis("tok_embeddings.weight") == 1
    assert shard_concat_axis("layers.0.attention_norm.weight") is None


def test_find_shards_filters_like_jax(tmp_path):
    for name in ("consolidated.00.pth", "consolidated.01.pth", "consolidated.10.pth",
                 "consolidated.bak.pth", "consolidated.0x.pth", "consolidated.02.pth.tmp",
                 "other.00.pth"):
        (tmp_path / name).write_bytes(b"")
    got = find_checkpoint_shards(str(tmp_path))
    assert got == jax_find_checkpoint_shards(str(tmp_path))
    assert [os.path.basename(p) for p in got] == [
        "consolidated.00.pth", "consolidated.01.pth", "consolidated.10.pth"]


def test_sharded_equals_full(shard_dir):
    d, weights = shard_dir
    tensors = load_sharded_checkpoint(find_checkpoint_shards(d))
    assert set(tensors) == set(weights)
    for name, t in tensors.items():
        assert isinstance(t, ShardedTensor) and len(t.shards) == 2
        assert t.shape == tuple(weights[name].shape) and t.dtype == torch.bfloat16
        assert torch.equal(t.materialize(), weights[name]), name
    # a replicated tensor is shard 0's
    norm = tensors["norm.weight"]
    assert norm.axis is None and norm.materialize() is norm.shards[0]
    # reversed shards hold other weights: the order is the file order
    backwards = load_sharded_checkpoint(find_checkpoint_shards(d)[::-1])
    assert not torch.equal(backwards["layers.0.attention.wq.weight"].materialize(),
                           weights["layers.0.attention.wq.weight"])


def test_sharded_forward_matches_jax(shard_dir):
    d, weights = shard_dir
    paths = find_checkpoint_shards(d)
    params = build_params_from_checkpoint(load_sharded_checkpoint(paths), TINY, device="cpu")
    full = build_params_from_checkpoint(weights, TINY, device="cpu")
    jparams = jax_build_params_from_checkpoint(jax_load_sharded_checkpoint(paths), JTINY)
    tokens = [[5, 9, 2]]
    got, _ = forward(params, TINY, torch.tensor(tokens, dtype=torch.int32), 0,
                     KVCache.create(TINY, 1, 16, device="cpu"))
    ref, _ = forward(full, TINY, torch.tensor(tokens, dtype=torch.int32), 0,
                     KVCache.create(TINY, 1, 16, device="cpu"))
    assert torch.equal(got, ref)
    want, _ = jax.jit(jax_forward, static_argnums=(1,))(
        jparams, JTINY, jnp.asarray(tokens, jnp.int32), 0, JKVCache.create(JTINY, 1, 16))
    # tolerance: the bf16 drift bar of tests/test_torch_model.py
    compare_tensor(got.numpy(), np.asarray(want), "bfloat16", tolerance_multiplier=5.0)


def test_validation_checks_the_combined_shapes(shard_dir):
    d, weights = shard_dir
    tensors = load_sharded_checkpoint(find_checkpoint_shards(d))
    validate_checkpoint(tensors, TINY)
    wk = tensors["layers.1.attention.wk.weight"]
    tensors["layers.1.attention.wk.weight"] = ShardedTensor(wk.name, wk.shards[:1], wk.axis)
    with pytest.raises(CheckpointShapeError, match="wk"):
        validate_checkpoint(tensors, TINY)


@pytest.fixture(scope="module")
def shard_model_dir(model_dir, tmp_path_factory):  # noqa: F811
    """tests/test_torch_loader.py's model directory with its checkpoint
    split over four shards."""
    d = tmp_path_factory.mktemp("shard_model")
    for name in ("tokenizer.model", "params.json"):
        shutil.copy(model_dir / name, d / name)
    weights = torch.load(str(model_dir / "consolidated.00.pth"), weights_only=True)
    save_shards(weights, str(d), n_shards=4)
    return d


@pytest.mark.parametrize("fused,quant", [(False, None), (True, None), (False, "int4"),
                                         (False, "int8")])
def test_load_llama_model_of_shards_equals_the_single_file(model_dir, shard_model_dir,  # noqa: F811
                                                           fused, quant):
    got = load_llama_model(str(shard_model_dir), max_sequence_length=48, fused=fused,
                           quant=quant, device="cpu")
    want = load_llama_model(str(model_dir), max_sequence_length=48, fused=fused,
                            quant=quant, device="cpu")
    assert got.tensor_meta == want.tensor_meta
    fields = {None: (None,), "int4": ("packed", "scale"), "int8": ("q", "scale")}[quant]

    def leaves_of(p):
        out = {"tok_embeddings": p.tok_embeddings, "norm": p.norm}
        for name, w in list(p.layers.items()) + [("output", p.output)]:
            for f in fields:
                out[(name, f)] = w if f is None or name.endswith("norm") else getattr(w, f)
        return out

    a, b = leaves_of(got.params), leaves_of(want.params)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    if quant is None:
        jax_got = jax_load_llama_model(str(shard_model_dir), max_sequence_length=48,
                                       fused=fused)
        for name, t in got.params.layers.items():
            np.testing.assert_array_equal(tensor_to_numpy(t),
                                          raw(jax_got.params.layers[name]))
