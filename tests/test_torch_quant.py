"""Weight quantization of the PyTorch port against the JAX package's: the int8
and int4 quantizers, the int4 unpack and ``quantize_kv_rows`` give the same
bytes from the same seeded numpy inputs; K8's plain version matches the
Pallas kernel in interpret mode; quantized ``linear`` matches; quantized
params cross the weight bridge bit for bit."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.io.params import ModelArgs as JModelArgs
from llama_nuts_and_bolts_tpu.kernels.q4_matmul import q4_matmul as jax_q4_matmul
from llama_nuts_and_bolts_tpu.models.llama import model as jmodel
from llama_nuts_and_bolts_tpu.ops import linear as jax_linear
from llama_nuts_and_bolts_tpu import quant as jquant

from llama_nuts_and_bolts_tpu_torch import quant
from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.kernels import k8_splits
from llama_nuts_and_bolts_tpu_torch.kernels import q4_matmul as k8
from llama_nuts_and_bolts_tpu_torch.models.llama import model
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import (
    params_from_numpy,
    tensor_from_numpy,
    tensor_to_numpy,
)
from llama_nuts_and_bolts_tpu_torch.ops import linear
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor


def bf16(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(ml_dtypes.bfloat16)


def raw(a):
    """Bytes of a numpy or torch array (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        return tensor_to_numpy(a)
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


# weights with the checkpoint's spread (~1/sqrt(dim)), stacked or not; the
# contraction dims cover fit_group's odd cases: 704 -> groups of 176, 90 -> 90,
# 6 -> 6, 1000 -> 250
SHAPES = [(3, 48, 256), (40, 704), (2, 16, 90), (8, 6), (24, 1000), (32, 4096)]


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_quantizer_bytes_equal_jax(shape):
    w = bf16(np.random.default_rng(len(shape) * 1000 + shape[-1]), *shape, scale=0.05)
    got = quant.quantize_tensor(tensor_from_numpy(w, "cpu"))
    want = jquant.quantize_tensor(jnp.asarray(w))
    np.testing.assert_array_equal(raw(got.q), raw(want.q))
    np.testing.assert_array_equal(raw(got.scale), raw(want.scale))
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(raw(quant.dequantize(got)), raw(jquant.dequantize(want)))


@pytest.mark.parametrize("shape", SHAPES)
def test_int4_quantizers_bytes_equal_jax(shape):
    w = bf16(np.random.default_rng(shape[-1]), *shape, scale=0.05)
    got = quant.quantize_tensor_q4(tensor_from_numpy(w, "cpu"))
    want = jquant.quantize_tensor_q4(jnp.asarray(w))
    host_packed, host_scale = jquant.host_quantize_q4(np.asarray(w))
    for mine in (got, quant.Q4Tensor(*quant.host_quantize_q4(tensor_from_numpy(w, "cpu")))):
        np.testing.assert_array_equal(raw(mine.packed), raw(want.packed))
        np.testing.assert_array_equal(raw(mine.scale), raw(want.scale))
        np.testing.assert_array_equal(raw(mine.packed), host_packed)
        np.testing.assert_array_equal(raw(mine.scale), raw(host_scale))
    assert got.shape == tuple(want.shape) and got.group_size == want.group_size


@pytest.mark.parametrize("in_dim", [2, 6, 64, 90, 176, 256, 704, 1000, 4096, 14336])
def test_fit_group_equals_jax(in_dim):
    for group in (256, 64, 7):
        assert quant.fit_group(in_dim, group) == jquant.int4.fit_group(in_dim, group)
    with pytest.raises(ValueError, match="even"):
        quant.fit_group(in_dim + 1)


@pytest.mark.parametrize("shape", [(3, 48, 256), (40, 704), (2, 16, 90)])
def test_unpack_q4_is_exact(shape):
    w = bf16(np.random.default_rng(5), *shape, scale=0.1)
    want = jquant.quantize_tensor_q4(jnp.asarray(w))
    qt = quant.Q4Tensor(packed=tensor_from_numpy(np.asarray(want.packed), "cpu"),
                        scale=tensor_from_numpy(np.asarray(want.scale), "cpu"))
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        np.testing.assert_array_equal(raw(quant.unpack_q4(qt, dtype)),
                                      raw(jquant.unpack_q4(want, jdtype)))


@pytest.mark.parametrize("shape", [(2, 3, 5, 128), (1, 7, 2, 16)])
def test_quantize_kv_rows_bytes_equal_jax(shape):
    rows = bf16(np.random.default_rng(11), *shape, scale=3.0)
    rows[0, 0, 0] = 0                                   # an all-zero row: eps scale
    q, s = model.quantize_kv_rows(tensor_from_numpy(rows, "cpu"))
    jq, js = jmodel.quantize_kv_rows(jnp.asarray(rows))
    np.testing.assert_array_equal(raw(q), raw(jq))
    np.testing.assert_array_equal(raw(s), raw(js))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16


@pytest.mark.parametrize("split", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("rows", [1, 16, 32])
def test_k8_plain_matches_pallas_interpret(rows, split):
    """q4_matmul_plain against q4_matmul(interpret=True) on weights quantized
    by the JAX package (tests/test_quant4.py's shape, G = 4), at every split
    of its groups (3 does not divide G) and through the wrapper (None:
    k8_split's); fp32 outputs of the same fp32 arithmetic, summed in another
    order: fp32 tolerance."""
    rng = np.random.default_rng(rows)
    w = rng.standard_normal((256, 1024)).astype(np.float32) / 16
    qt = jquant.quantize_tensor_q4(jnp.asarray(w))
    x = bf16(rng, rows, 1024)
    want = np.asarray(jax_q4_matmul(jnp.asarray(x), qt.packed, qt.scale, interpret=True))
    args = (tensor_from_numpy(x, "cpu"), tensor_from_numpy(np.asarray(qt.packed), "cpu"),
            tensor_from_numpy(np.asarray(qt.scale), "cpu"))
    before = k8.q4_matmul.launches
    if split is None:
        got = k8.q4_matmul(*args)
        assert k8.q4_matmul.launches == before         # CPU: no kernel launch
        assert torch.equal(got, k8.q4_matmul_plain(*args, k8.k8_split(rows, 1024, 256, 4)))
    else:
        got = k8.q4_matmul_plain(*args, split)
    assert got.dtype == torch.float32 and got.shape == (rows, 256)
    compare_tensor(got.numpy(), want, "float32")


@pytest.mark.parametrize("G,split", [(7, 3), (56, 11)])
def test_k8_plain_adds_whole_splits_in_order(G, split):
    """The plain version's partition: each split's groups from zero in
    order, then the splits added in order, the last split the groups left
    (7 = 3 + 3 + 1; w_down's 56 = 5 x 11 + 1), through the wrapper too."""
    rng = np.random.default_rng(G)
    qt = quant.quantize_tensor_q4(tensor_from_numpy(bf16(rng, 64, G * 256, scale=0.1), "cpu"))
    x = tensor_from_numpy(bf16(rng, 3, G * 256), "cpu")
    parts = [k8.q4_matmul_plain(x[:, g * 256:(g + 1) * 256], qt.packed[g:g + 1],
                                qt.scale[g:g + 1], 1) for g in range(G)]
    want = None
    for g0 in range(0, G, split):
        acc = parts[g0]
        for p in parts[g0 + 1:g0 + split]:
            acc = acc + p
        want = acc if want is None else want + acc
    assert G % split
    assert torch.equal(k8.q4_matmul_plain(x, qt.packed, qt.scale, split), want)
    assert torch.equal(k8.q4_matmul(x, qt.packed, qt.scale, split), want)


# Llama-3.1-8B's int4 products: (out, in) of every projection and the head
K8_MAIN_PATH = {"wq": (4096, 4096), "wk": (1024, 4096), "wv": (1024, 4096),
                "wo": (4096, 4096), "w_gate": (14336, 4096), "w_up": (14336, 4096),
                "w_down": (4096, 14336), "output": (128256, 4096)}


@pytest.mark.parametrize("R", [1, 16, 32])
@pytest.mark.parametrize("name", list(K8_MAIN_PATH) + ["odd"])
def test_k8_split_at_main_path_shapes(name, R):
    """k8_split at the 8B shapes (groups of 256), and at a G of 14 that its
    split does not divide: whole groups, the last split the rest, x's slice
    within the block's budget, 1.5 blocks per SM wherever the groups and the
    cap of 8 splits allow it, no more splits than that unless x's budget
    asks for them."""
    out_dim, in_dim = K8_MAIN_PATH.get(name, (4096, 14 * 256))
    G = in_dim // 256
    split = k8.k8_split(R, in_dim, out_dim, G)
    assert isinstance(split, int) and 1 <= split <= G
    n_splits = -(-G // split)
    sizes = [min(split, G - g0) for g0 in range(0, G, split)]
    assert len(sizes) == n_splits and sum(sizes) == G and min(sizes) >= 1
    cap = k8.K8_X_BYTES // (R * 256 * 2)
    assert split <= cap
    tiles = out_dim // k8.K8_OUT_TILE
    assert tiles * n_splits >= min(k8.K8_MIN_BLOCKS, tiles * k8.K8_MAX_SPLITS, tiles * G)
    assert n_splits <= max(k8.K8_MAX_SPLITS, -(-G // cap))
    if name in ("wk", "wv"):
        assert n_splits == k8.K8_MAX_SPLITS              # 16 tiles: split 8 ways
    if name == "output" and R == 1:
        assert n_splits == 1                             # 2004 tiles fill the card
    if name == "odd":
        assert (split, sizes[-1]) == (3, 2)              # 3 + 3 + 3 + 3 + 2 groups


@pytest.mark.parametrize("rows,shape,takes", [
    (1, (16, 4096, 128), True), (32, (16, 4096, 128), True),    # groups of 256
    (33, (16, 4096, 128), False),                                # a longer prefill
    (1, (2, 16, 4096, 128), False),                              # stacked layers
    (1, (4, 256, 512), True), (1, (2, 256, 640), False),         # K/2 past the build
    (1, (16, 256, 64), False), (1, (16, 4160, 128), False)])     # not multiples of 128
def test_k8_takes_the_jax_routing_rule(rows, shape, takes):
    """ops/linear.py sends a Q4Tensor product to K8 on a card by the JAX
    package's rule and the group sizes the kernel is built for."""
    assert k8.k8_takes(rows, torch.empty(shape, dtype=torch.uint8)) is takes


@pytest.mark.parametrize("name,R", k8_splits.SHAPES)
def test_k8_splits_times_partitions_the_kernel_takes(name, R):
    """The split sweep times k8_split's choice and half and twice it, each a
    split q4_matmul accepts, on the same function as the plain version's."""
    out_dim, in_dim = k8_splits.WEIGHTS[name]
    G = in_dim // 256
    tried = k8_splits.splits_tried(R, in_dim, out_dim, G)
    assert k8.k8_split(R, in_dim, out_dim, G) in tried and len(tried) in (2, 3)
    assert all(1 <= sp <= min(G, k8.K8_X_BYTES // (R * 256 * 2)) for sp in tried)
    if name == "w_down":
        x, packed, scale = (torch.ones((R, in_dim), dtype=torch.bfloat16),
                            torch.full((G, 64, 128), 0x99, dtype=torch.uint8),
                            torch.ones((G, 64), dtype=torch.bfloat16))
        outs = [k8.q4_matmul(x, packed, scale, sp) for sp in tried]
        assert all(torch.equal(o, torch.full((R, 64), float(in_dim))) for o in outs)


def test_k8_row_buckets_follow_the_n_tiles():
    """R rows run on the first bucket of 8, 16 or 32 rows that holds them:
    1, 2 or 4 mma n-tiles of 8 rows."""
    assert k8.K8_ROW_BUCKETS == (8, 16, 32)
    for R in range(1, 33):
        bucket = k8.k8_row_bucket(R)
        assert bucket == (8 if R <= 8 else 16 if R <= 16 else 32)
        assert bucket // 8 in (1, 2, 4)
    for R in (0, 33):
        with pytest.raises(ValueError, match="rows"):
            k8.k8_row_bucket(R)


def test_k8_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(0)
    qt = quant.quantize_tensor_q4(tensor_from_numpy(bf16(rng, 256, 512), "cpu"))
    x = tensor_from_numpy(bf16(rng, 2, 512), "cpu")
    with pytest.raises(ValueError, match="in dim"):
        k8.q4_matmul(x[:, :256], qt.packed, qt.scale)
    with pytest.raises(ValueError, match="scale"):
        k8.q4_matmul(x, qt.packed, qt.scale[:, :8])
    with pytest.raises(TypeError, match="uint8"):
        k8.q4_matmul(x, qt.packed.to(torch.int8), qt.scale)
    with pytest.raises(TypeError, match="floating"):
        k8.q4_matmul(x.to(torch.int32), qt.packed, qt.scale)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k8.q4_matmul(x.to("meta"), qt.packed.to("meta"), qt.scale.to("meta"))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_linear_matches_jax(kind):
    """ops.linear on a QTensor (int8 cast to bf16, fp32 product, scale) and a
    Q4Tensor (unpack, fp32 product) against the JAX package's linear on the
    same bytes: bf16 results of the same arithmetic."""
    rng = np.random.default_rng(3)
    w = bf16(rng, 2, 64, 512, scale=0.05)
    x = bf16(rng, 1, 5, 512)
    jqt = (jquant.quantize_tensor if kind == "int8" else jquant.quantize_tensor_q4)(
        jnp.asarray(w))
    qt = (quant.quantize_tensor if kind == "int8" else quant.quantize_tensor_q4)(
        tensor_from_numpy(w, "cpu"))
    for layer in range(2):
        jl = jax.tree_util.tree_map(lambda a: a[layer], jqt)
        for out_dtype in (None, torch.float32):
            jdt = None if out_dtype is None else jnp.float32
            got = linear(tensor_from_numpy(x, "cpu"), qt[layer], out_dtype=out_dtype)
            want = np.asarray(jax_linear(jnp.asarray(x), jl, out_dtype=jdt), np.float32)
            assert got.shape == want.shape
            compare_tensor(got.float().numpy(), want,
                           "bfloat16" if out_dtype is None else "float32")


def jax_params(cfg, seed=0):
    return jax.jit(jmodel.init_random_params, static_argnums=(0,))(
        cfg, jax.random.PRNGKey(seed))


def quantized_leaves(p):
    def leaf(a):
        if hasattr(a, "packed"):
            return {"packed": np.asarray(a.packed), "scale": np.asarray(a.scale)}
        if hasattr(a, "q"):
            return a                                   # the object itself
        return np.asarray(a)
    return {"tok_embeddings": np.asarray(p.tok_embeddings),
            "layers": {k: leaf(v) for k, v in p.layers.items()},
            "norm": np.asarray(p.norm), "output": leaf(p.output),
            "rope_cos": np.asarray(p.rope_cos), "rope_sin": np.asarray(p.rope_sin)}


SPEC = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
            multiple_of=32, norm_eps=1e-5, max_sequence_length=64)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_params_bridge_and_quantize_params_equal_jax(kind):
    """JAX-quantized params cross the bridge (dict leaves for int4, the JAX
    objects for int8) bit for bit, and the port's quantize_params* on the
    bridged bf16 params gives the bytes of the JAX quantizer run eagerly
    (and of its loader's numpy quantizer). The JAX package's quantize_params*
    jit the quantizer, and XLA's fused division moves a few bytes per matrix
    (ROADMAP.md, faults), so those are bridged, not recomputed."""
    jp = jax_params(JModelArgs(**SPEC))
    jfn, jtensor, fn = (
        (jquant.quantize_params, jquant.quantize_tensor, quant.quantize_params)
        if kind == "int8" else
        (jquant.quantize_params_q4, jquant.quantize_tensor_q4, quant.quantize_params_q4))
    jq = jfn(jp)
    bridged = params_from_numpy(quantized_leaves(jq), "cpu")
    mine = fn(params_from_numpy(quantized_leaves(jp), "cpu"))
    fields = ("q", "scale") if kind == "int8" else ("packed", "scale")
    for name in quant.quantize.QUANT_KEYS:
        eager = jtensor(jp.layers[name])
        for f in fields:
            np.testing.assert_array_equal(raw(getattr(bridged.layers[name], f)),
                                          raw(getattr(jq.layers[name], f)))
            np.testing.assert_array_equal(raw(getattr(mine.layers[name], f)),
                                          raw(getattr(eager, f)))
    eager = jtensor(jp.output)
    for f in fields:
        np.testing.assert_array_equal(raw(getattr(mine.output, f)), raw(getattr(eager, f)))
    np.testing.assert_array_equal(raw(mine.layers["attn_norm"]),
                                  raw(jq.layers["attn_norm"]))
    with pytest.raises(ValueError, match="plain"):
        model.fuse_decode_params(mine)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_init_random_quantized_params_shapes_and_seed(kind):
    cfg = ModelArgs(**SPEC)
    init = quant.init_random_params_q8 if kind == "int8" else quant.init_random_params_q4
    a, b = init(cfg, seed=3, device="cpu"), init(cfg, seed=3, device="cpu")
    c = init(cfg, seed=4, device="cpu")
    field = "q" if kind == "int8" else "packed"
    for name, shape in model.layer_weight_shapes(cfg).items():
        w = a.layers[name]
        if name.endswith("norm"):
            assert tuple(w.shape) == (cfg.n_layers,) + shape
            continue
        assert w.shape == (cfg.n_layers,) + shape          # the logical shape
        assert torch.equal(getattr(w, field), getattr(b.layers[name], field))
        assert not torch.equal(getattr(w, field), getattr(c.layers[name], field))
        assert w[1].shape == shape
    assert a.output.shape == (cfg.vocab_size, cfg.dim)
    if kind == "int8":
        assert int(a.layers["wq"].q.min()) >= -127
    else:
        assert a.layers["wq"].packed.dtype == torch.uint8
