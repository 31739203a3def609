"""The port's tensor-parallel splits against the JAX package's, in process.

Each rank's slices (``parallel.sharding.shard_params_for``) must be byte-equal
to the shard that the JAX package's ``shard_params(params, make_mesh(tp))``
places on device ``r`` of the 8-device CPU mesh, for bf16, int8 and int4
leaves, a ``_fit_spec``-replicated int4 axis included; the same for the
dense cache (``shard_cache``) and the paged pool (``shard_pool``). Also: the
mesh on a one-rank gloo group, the loader's sharding function, the
``kv_heads % tp`` gate, the kernel-shard wrappers on the CPU (K6 on each
rank's heads against the JAX package's ``tp_paged_flash_decode`` on the CPU
mesh, its Pallas kernel in interpret mode), and K8's routing at the head
shards of Llama-3.1-8B."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu import quant as jquant
from llama_nuts_and_bolts_tpu.io.params import ModelArgs as JModelArgs
from llama_nuts_and_bolts_tpu.models.llama import model as jmodel
from llama_nuts_and_bolts_tpu.models.llama import paged as jpaged
from llama_nuts_and_bolts_tpu.parallel import make_mesh as jmake_mesh
from llama_nuts_and_bolts_tpu.parallel import shard_cache as jshard_cache
from llama_nuts_and_bolts_tpu.parallel import shard_params as jshard_params
from llama_nuts_and_bolts_tpu.parallel import shard_pool as jshard_pool
from llama_nuts_and_bolts_tpu.parallel.kernel_shard import (
    tp_paged_flash_decode as jtp_paged_flash_decode,
)

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.kernels.attention import flash_gqa_attention
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import flash_decode_attention
from llama_nuts_and_bolts_tpu_torch.kernels.paged_attention import paged_flash_decode
from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import k8_takes
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import (
    params_from_numpy,
    tensor_from_numpy,
    tensor_to_numpy,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache
from llama_nuts_and_bolts_tpu_torch.models.llama.paged import PagedKVPool
from llama_nuts_and_bolts_tpu_torch.parallel import (
    initialize_multihost,
    make_mesh,
    tp_rank,
    tp_size,
)
from llama_nuts_and_bolts_tpu_torch.parallel.kernel_shard import (
    tp_flash_decode_attention,
    tp_flash_gqa_attention,
    tp_paged_flash_decode,
)
from llama_nuts_and_bolts_tpu_torch.parallel.mesh import gather_last, reduce_partial
from llama_nuts_and_bolts_tpu_torch.parallel.sharding import (
    LAYER_SPECS,
    TOP_SPECS,
    POOL_SPEC,
    check_tp_shape,
    pool_sharding,
    shard_cache_for,
    shard_leaf,
    shard_params_for,
    shard_pool_for,
    sharding_fn_for,
)
from llama_nuts_and_bolts_tpu_torch.quant.int4 import host_quantize_q4
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests.test_torch_kernels_int8 import int8_cache
from tests.test_torch_quant_model import leaves

# 8 heads over 8 KV heads, so tp 2, 4 and 8 all keep whole heads; the int4
# layer weights have one group of 256 for wq..wo (in = 256), which
# _fit_spec replicates on every rank, and w_down 3 groups (in = 768)
SPEC = dict(dim=256, n_layers=2, n_heads=8, n_kv_heads=8, vocab_size=128,
            multiple_of=256, norm_eps=1e-5, max_sequence_length=64)


def jax_pair(quant):
    jcfg = JModelArgs(**SPEC)
    jparams = jax.jit(jmodel.init_random_params, static_argnums=(0,))(
        jcfg, jax.random.PRNGKey(5))
    if quant == "int8":
        jparams = jquant.quantize_params(jparams)
    elif quant == "int4":
        jparams = jquant.quantize_params_q4(jparams)
    return jparams, params_from_numpy(leaves(jparams), "cpu")


def fields(leaf):
    """(name, tensor) of a leaf of either package."""
    if hasattr(leaf, "packed"):
        return [("packed", leaf.packed), ("scale", leaf.scale)]
    if hasattr(leaf, "q"):
        return [("q", leaf.q), ("scale", leaf.scale)]
    return [("value", leaf)]


def assert_shard_equal(jleaf, leaf, r, what):
    for (name, ja), (_, t) in zip(fields(jleaf), fields(leaf)):
        want = np.asarray(ja.addressable_shards[r].data)
        got = tensor_to_numpy(t)
        assert got.shape == want.shape, (what, name, got.shape, want.shape)
        want = want.view(np.uint16) if want.dtype.name == "bfloat16" else want
        np.testing.assert_array_equal(got, want, err_msg=f"{what}.{name} rank {r}")


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_rank_slices_equal_jax_addressable_shards(quant, tp):
    jparams, params = jax_pair(quant)
    jsharded = jshard_params(jparams, jmake_mesh(tp=tp))
    for r in range(tp):
        mine = shard_params_for(params, r, tp)
        for k in params.layers:
            assert_shard_equal(jsharded.layers[k], mine.layers[k], r, k)
        for k in ("tok_embeddings", "norm", "output", "rope_cos", "rope_sin"):
            assert_shard_equal(getattr(jsharded, k), getattr(mine, k), r, k)


def test_fit_spec_replicates_few_int4_groups():
    """wo has one int4 group (in = 256): its group axis cannot split over
    tp 2, so every rank holds all of it; w_down's 3 groups neither."""
    _, params = jax_pair("int4")
    for name, G in (("wo", 1), ("w_down", 3)):
        w = params.layers[name]
        assert w.packed.shape[1] == G
        for r in range(2):
            s = shard_leaf(w, LAYER_SPECS[name], r, 2)
            assert torch.equal(s.packed, w.packed) and torch.equal(s.scale, w.scale)
    wq = shard_leaf(params.layers["wq"], LAYER_SPECS["wq"], 1, 2)
    assert wq.packed.shape[2] == params.layers["wq"].packed.shape[2] // 2


def test_a_dense_axis_tp_does_not_divide_is_refused():
    with pytest.raises(ValueError, match="does not divide over tp=3"):
        shard_leaf(torch.zeros(2, 8, 4), LAYER_SPECS["wq"], 0, 3)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_cache_shards_equal_jax(dtype):
    jcfg, cfg = JModelArgs(**SPEC), ModelArgs(**SPEC)
    jdt = jnp.int8 if dtype == "int8" else jnp.bfloat16
    rng = np.random.default_rng(0)
    jcache = jmodel.KVCache.create(jcfg, 2, 16, dtype=jdt)
    filled = {}
    for f in ("k", "v", "k_scale", "v_scale"):
        a = getattr(jcache, f)
        if a is None:
            continue
        vals = rng.integers(-100, 100, a.shape) if dtype == "int8" and f in "kv" else \
            rng.standard_normal(a.shape)
        filled[f] = jnp.asarray(vals, a.dtype)
    jcache = jmodel.KVCache(**filled)
    cache = KVCache(**{f: tensor_from_numpy(np.asarray(a), "cpu") for f, a in filled.items()})
    mesh = jmake_mesh(tp=4)
    jsharded = jshard_cache(jcache, mesh)
    for r in range(4):
        mine = shard_cache_for(cache, r, 4)
        assert mine.k.shape[2] == cfg.kv_heads // 4
        for f in filled:
            assert_shard_equal(getattr(jsharded, f), getattr(mine, f), r, f)
    local = KVCache.create(cfg, 2, 16, device="cpu", dtype=torch.int8 if dtype == "int8"
                           else torch.bfloat16, tp=4)
    assert local.k.shape == mine.k.shape and local.quantized == (dtype == "int8")


def filled_pools(jcfg, n_blocks, bs, int8, seed=0):
    """The same seeded values in a JAX and a port paged pool."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, n_blocks, jcfg.kv_heads, bs, jcfg.head_dim)
    if int8:
        (k, ks), (v, vs) = int8_cache(rng, shape), int8_cache(rng, shape)
        vals = dict(k=k, v=v, k_scale=ks, v_scale=vs)
    else:
        vals = {f: rng.standard_normal(shape).astype(np.float32).astype(jnp.bfloat16)
                for f in ("k", "v")}
    jpool = jpaged.PagedKVPool(**{f: jnp.asarray(a) for f, a in vals.items()})
    pool = PagedKVPool(**{f: tensor_from_numpy(a, "cpu") for f, a in vals.items()})
    return jpool, pool


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_pool_shards_equal_jax(dtype, tp):
    """A rank's KV heads of a paged pool (and of an int8 pool's scale
    pools) are byte-equal to the JAX package's ``shard_pool`` shards."""
    jcfg = JModelArgs(**SPEC)
    jpool, pool = filled_pools(jcfg, 6, 8, dtype == "int8")
    jsharded = jshard_pool(jpool, jmake_mesh(tp=tp))
    assert pool_sharding() == POOL_SPEC == (None, None, "tp", None, None)
    fields_ = ("k", "v", "k_scale", "v_scale") if dtype == "int8" else ("k", "v")
    for r in range(tp):
        mine = shard_pool_for(pool, r, tp)
        assert mine.k.shape[2] == jcfg.kv_heads // tp and mine.quantized == (dtype == "int8")
        assert mine.k.is_contiguous()
        for f in fields_:
            assert_shard_equal(getattr(jsharded, f), getattr(mine, f), r, f)
    local = PagedKVPool.create(ModelArgs(**SPEC), 6, 8, torch.int8 if dtype == "int8"
                               else torch.bfloat16, device="cpu", tp=tp)
    assert local.k.shape == mine.k.shape and local.quantized == (dtype == "int8")


def paged_case(seed, int8, n_blocks=9, KV=4, bs=8, B=3, M=2, H=16):
    """One layer's pool [1, n_blocks, KV, bs, 128] (int8 with scale pools),
    q [B, 1, H, 128] and seeded tables: the JAX sharding test's case at the
    kernels' head_dim and group of 4."""
    rng = np.random.default_rng(seed)
    shape = (1, n_blocks, KV, bs, 128)
    if int8:
        (k, ks), (v, vs) = int8_cache(rng, shape), int8_cache(rng, shape)
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32).astype(jnp.bfloat16)
                for _ in range(2))
        ks = vs = None
    q = rng.standard_normal((B, 1, H, 128)).astype(np.float32).astype(jnp.bfloat16)
    tables = (rng.permutation(n_blocks - 1)[:B * M] + 1).reshape(B, M).astype(np.int32)
    return q, k, v, ks, vs, tables, np.array([5, 11, 15], np.int32)[:B]


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_paged_flash_decode_matches_jax_tp(one_rank_group, tp):
    """K6's plain version on each rank's heads of a sharded bf16 pool,
    concatenated in rank order, against the JAX package's
    ``tp_paged_flash_decode`` (shard_map over the CPU mesh, the Pallas
    kernel in interpret mode): the bf16 tolerance of tests/test_torch_paged.py's
    unsharded K6 check (1e-2 absolute and relative), and bit-equal to the
    port's unsharded call, since attention is head-local."""
    mesh = make_mesh()
    q, k, v, _, _, tables, pos = paged_case(tp, int8=False)
    want = jax.jit(jtp_paged_flash_decode, static_argnums=(0,))(
        jmake_mesh(tp=tp), jnp.asarray(q), jnp.asarray(k[0]), jnp.asarray(v[0]),
        jnp.asarray(tables), jnp.asarray(pos))
    pool = PagedKVPool(k=tensor_from_numpy(k, "cpu"), v=tensor_from_numpy(v, "cpu"))
    qt, tbl, p = tensor_from_numpy(q, "cpu"), torch.from_numpy(tables), torch.from_numpy(pos)
    h = q.shape[2] // tp
    got = torch.cat([tp_paged_flash_decode(mesh, qt[:, :, r * h:(r + 1) * h].contiguous(),
                                           shard.k, shard.v, tbl, p, layer=0)
                     for r, shard in enumerate(shard_pool_for(pool, r, tp)
                                               for r in range(tp))], dim=2)
    compare_tensor(got.float().numpy(), np.asarray(want, np.float32), "bfloat16")
    assert torch.equal(got, paged_flash_decode(qt, pool.k, pool.v, tbl, p, layer=0))


def test_tp_paged_flash_decode_int8_pool_and_group_gate(one_rank_group):
    """K6's int8 mode on each rank's heads of a sharded int8 pool is the
    unsharded call's heads, bit for bit (q is quantized per head row); a
    shard whose group is not the kernels' 4 is refused."""
    mesh = make_mesh()
    q, k, v, ks, vs, tables, pos = paged_case(7, int8=True)
    pool = PagedKVPool(*(tensor_from_numpy(a, "cpu") for a in (k, v, ks, vs)))
    qt, tbl, p = tensor_from_numpy(q, "cpu"), torch.from_numpy(tables), torch.from_numpy(pos)
    whole = paged_flash_decode(qt, pool.k, pool.v, tbl, p, layer=0, pool_ks=pool.k_scale,
                               pool_vs=pool.v_scale)
    for tp in (2, 4):
        h = q.shape[2] // tp
        for r in range(tp):
            shard = shard_pool_for(pool, r, tp)
            heads = qt[:, :, r * h:(r + 1) * h].contiguous()
            got = tp_paged_flash_decode(mesh, heads, shard.k, shard.v, tbl, p, layer=0,
                                        pool_ks=shard.k_scale, pool_vs=shard.v_scale)
            assert torch.equal(got, whole[:, :, r * h:(r + 1) * h]), (tp, r)
    shard = shard_pool_for(pool, 0, 2)
    with pytest.raises(ValueError, match="does not keep whole GQA groups of 4"):
        tp_paged_flash_decode(mesh, qt[:, :, :6].contiguous(), shard.k, shard.v, tbl, p,
                              layer=0)


def test_loader_sharding_fn_cuts_one_layer():
    """The loader's function cuts one layer of a weight (the stacked spec
    without its layer axis), the top-level tensors whole, int4 after
    quantizing; unknown keys have none."""
    fn = sharding_fn_for(1, 2)
    assert fn("no_such_weight") is None
    w = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    assert torch.equal(fn("wq")(w), w[4:])
    assert torch.equal(fn("wo")(w), w[:, 3:])
    assert torch.equal(fn("output")(w), w[4:])
    assert torch.equal(fn("tok_embeddings")(w), w)
    packed, scale = host_quantize_q4(torch.randn(256, 512, dtype=torch.bfloat16))
    from llama_nuts_and_bolts_tpu_torch.quant import Q4Tensor

    q = fn("wo")(Q4Tensor(packed=packed, scale=scale))       # 2 groups: one a rank
    assert torch.equal(q.packed, packed[1:]) and torch.equal(q.scale, scale[1:])
    assert set(LAYER_SPECS) >= {"wq", "w_down"} and TOP_SPECS["output"] == ("tp", None)


def test_kv_heads_gate():
    cfg = ModelArgs(**dict(SPEC, n_kv_heads=2))
    check_tp_shape(cfg, 2)
    with pytest.raises(ValueError, match="tp=4 must divide the KV heads"):
        check_tp_shape(cfg, 4)


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process, torn down after."""
    from llama_nuts_and_bolts_tpu_torch.parallel.launch import free_port

    assert initialize_multihost(None) is None and not dist.is_initialized()
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_mesh()


def test_one_rank_mesh_and_its_collectives(one_rank_group):
    mesh = make_mesh()
    assert mesh.mesh_dim_names == ("dp", "sp", "tp") and tuple(mesh.shape) == (1, 1, 1)
    assert tp_size(mesh) == 1 and tp_rank(mesh) == 0
    assert tp_size(None) == 1 and tp_rank(None) == 0
    with pytest.raises(ValueError, match=r"dp\(1\) \* sp\(1\) \* tp\(2\) incompatible "
                                         r"with device count \(1\)"):
        make_mesh(tp=2)
    x = torch.randn(2, 3, 5)
    assert torch.equal(gather_last(x, mesh), x)
    y = reduce_partial(x.clone(), mesh, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, x.to(torch.bfloat16))


def test_kernel_shard_wrappers_on_local_heads(one_rank_group):
    """On the CPU the wrappers run the kernels' plain versions on the local
    heads: equal to the unsharded wrappers on the same tensors; a shard
    whose group is not the kernels' is refused."""
    mesh = make_mesh()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 4, 128, generator=g).to(torch.bfloat16)
    k = torch.randn(1, 1, 32, 128, generator=g).to(torch.bfloat16)
    v = torch.randn(1, 1, 32, 128, generator=g).to(torch.bfloat16)
    assert torch.equal(tp_flash_gqa_attention(mesh, q, k, v, 3),
                       flash_gqa_attention(q, k, v, 3))
    pos = torch.tensor([20], dtype=torch.int32)
    assert torch.equal(tp_flash_decode_attention(mesh, q[:, :1], k[None], v[None], pos, layer=0),
                       flash_decode_attention(q[:, :1], k[None], v[None], pos, layer=0))
    with pytest.raises(ValueError, match="does not keep whole GQA groups of 4"):
        tp_flash_gqa_attention(mesh, q[:, :, :2], k, v, 3)


@pytest.mark.parametrize("tp,takes", [(1, True), (2, True), (4, True), (8, False)])
def test_k8_routing_of_the_8b_head_shards(tp, takes):
    """Llama-3.1-8B's vocab-sharded int4 head: 128256 / tp rows of 16 groups.
    K8 takes ``out`` in whole tiles of 64 rows, so tp 2's 64128 rows and tp
    4's 32064 run the kernel and tp 8's 16032 the dense route; every layer
    weight of the 8B model keeps the kernel at tp 8."""
    half = 128
    assert k8_takes(1, torch.empty((16, 128256 // tp, half), dtype=torch.uint8)) == takes
    # wq, wk/wv, wo, w_gate/w_up, w_down: [G, out, K/2] of one rank
    for G, out_dim in ((16, 4096 // tp), (16, 1024 // tp), (16 // tp, 4096),
                       (16, 14336 // tp), (56 // tp, 4096)):
        assert k8_takes(1, torch.empty((G, out_dim, half), dtype=torch.uint8))


def test_shard_params_refuses_the_fused_layout():
    from llama_nuts_and_bolts_tpu_torch.models.llama import fuse_decode_params

    _, params = jax_pair(None)
    with pytest.raises(ValueError, match="fused decode layout is single-device"):
        shard_params_for(fuse_decode_params(params), 0, 2)
    assert dataclasses.is_dataclass(params)
