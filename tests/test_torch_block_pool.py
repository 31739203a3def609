"""The port's block allocators against the JAX package's: chained block
hashes equal, and the same seeded op stream (alloc, release, lookup,
register) gives equal results and statistics on the port's Python and native
backends and on the JAX package's Python allocator."""

import numpy as np
import pytest

from llama_nuts_and_bolts_tpu.runtime import block_pool as jbp
from llama_nuts_and_bolts_tpu.runtime.paged import BlockAllocator as JBlockAllocator

from llama_nuts_and_bolts_tpu_torch.runtime import block_pool as bp
from llama_nuts_and_bolts_tpu_torch.runtime.paged import BlockAllocator


@pytest.mark.parametrize("block_size", [1, 4, 32])
def test_chain_hashes_equal_jax(block_size):
    rng = np.random.default_rng(block_size)
    for n in (0, block_size - 1, 3 * block_size + 2, 200):
        tokens = rng.integers(0, 130000, n).tolist()
        assert bp.chain_block_hashes(tokens, block_size) == \
            jbp.chain_block_hashes(tokens, block_size)
    # a block's hash covers its whole prefix
    a = bp.chain_block_hashes([1] * 8 + [2] * 8, 8)
    b = bp.chain_block_hashes([3] * 8 + [2] * 8, 8)
    assert a[1] != b[1]


def run_stream(alloc, seed, steps=400):
    """A seeded op stream; returns every op's observable result."""
    rng = np.random.default_rng(seed)
    held, out = [], []
    for _ in range(steps):
        op = rng.integers(0, 4)
        if op == 0:
            got = alloc.alloc(int(rng.integers(0, 4)))
            out.append(("alloc", got))
            if got:
                held.extend(got)
        elif op == 1 and held:
            b = held.pop(int(rng.integers(0, len(held))))
            alloc.release([b])
            out.append(("release", b))
        elif op == 2:
            h = int(rng.integers(0, 12))
            got = alloc.lookup(h)
            out.append(("lookup", h, got))
            if got is not None:
                held.append(got)
        elif held:
            b = held[int(rng.integers(0, len(held)))]
            alloc.register(int(rng.integers(0, 12)), b)
            out.append(("register", b))
        out.append(("available", alloc.available))
    out.append(("stats", alloc.stats))
    # the trash block 0 is left out: there the JAX package's own backends
    # disagree (the Python twin counts 0, the C++ core -1)
    out.append(("refcounts", [alloc.refcount(b) for b in (-1, *range(1, alloc.n_blocks + 1))]))
    return out


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("seed", [0, 1])
def test_op_stream_equal_jax(backend, seed):
    want = run_stream(jbp.PrefixBlockAllocator(9, 4, backend="python"), seed)
    port = bp.PrefixBlockAllocator(9, 4, backend=backend)
    assert port.backend == backend
    assert run_stream(port, seed) == want


def test_backend_choice_and_refusals():
    auto = bp.PrefixBlockAllocator(4, 8)
    assert auto.backend == ("native" if bp.native_available() else "python")
    with pytest.raises(ValueError, match="backend"):
        bp.PrefixBlockAllocator(4, 8, backend="gpu")
    for backend in ("python", "native"):
        with pytest.raises(ValueError):
            bp.PrefixBlockAllocator(1, 8, backend=backend)   # trash block only
        a = bp.PrefixBlockAllocator(4, 8, backend=backend)
        with pytest.raises(ValueError):
            a.release([0])                                    # the trash block
        with pytest.raises(ValueError):
            a.register(5, 2)                                  # a free block
        assert a.alloc(4) is None and a.alloc(3) is not None  # all or nothing


def test_native_library_builds_into_the_port_build_dir():
    if not bp.native_available():
        pytest.skip("no g++ here")
    assert bp._SO.parent.name == "native" and bp._SO.parent.parent.name == "build"
    assert bp._SO.is_file()


def test_free_list_allocator_equal_jax():
    ours, theirs = BlockAllocator(6, 8), JBlockAllocator(6, 8)
    for n in (2, 4, 1, 3):
        assert ours.alloc(n) == theirs.alloc(n)
        assert ours.available == theirs.available
    ours.free([2, 1])
    theirs.free([2, 1])
    assert ours.alloc(2) == theirs.alloc(2)
    with pytest.raises(ValueError):
        ours.free([0])
