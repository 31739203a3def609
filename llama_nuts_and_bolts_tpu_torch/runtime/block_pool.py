"""Prefix-caching block allocator: native C++ core + pure-Python twin.

Port of ``llama_nuts_and_bolts_tpu/runtime/block_pool.py``: memory management
for the paged KV pool (``models/llama/paged.py``). Every block is refcounted;
full prompt blocks are registered under a chained FNV-1a content hash, so a
later request whose prompt starts with the same token blocks revives them
instead of recomputing their prefill (automatic prefix caching). Freed but
hashed blocks linger as a cached-free LRU that allocation evicts only under
memory pressure.

The native backend binds the repository's ``native/block_pool.cpp``, compiled
with ``g++`` at first use into ``build/native/`` at the repository root (a
directory ``.gitignore`` lists) and loaded with ``ctypes``. This is a host
allocator, not a device kernel: ``backend="auto"`` takes the Python twin
where ``g++`` or the source is missing, as the JAX package does. Both expose
identical semantics; the tests drive them with the same op stream.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

from llama_nuts_and_bolts_tpu_torch.utils.native_lib import NativeLibrary

_i32, _u64, _ptr = ctypes.c_int32, ctypes.c_uint64, ctypes.c_void_p
_i32p = ctypes.POINTER(ctypes.c_int32)
_LIB = NativeLibrary("block_pool", (
    ("bp_new", _ptr, [_i32]), ("bp_destroy", None, [_ptr]),
    ("bp_available", _i32, [_ptr]), ("bp_alloc", _i32, [_ptr, _i32, _i32p]),
    ("bp_release", _i32, [_ptr, _i32p, _i32]), ("bp_lookup", _i32, [_ptr, _u64]),
    ("bp_register", _i32, [_ptr, _u64, _i32]), ("bp_refcount", _i32, [_ptr, _i32]),
    ("bp_stat", ctypes.c_int64, [_ptr, _i32])))
_SRC, _SO = _LIB.src, _LIB.so
_load_library = _LIB.load


def native_available() -> bool:
    return _load_library() is not None


_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_U64 = (1 << 64) - 1


def chain_block_hashes(tokens: Sequence[int], block_size: int) -> List[int]:
    """Chained FNV-1a hash per FULL block of ``tokens``.

    hash[i] covers tokens[: (i+1) * block_size] -- chaining makes a block's
    identity depend on its whole prefix, so equal hashes mean equal usable
    cache content, not just equal local tokens."""
    hashes: List[int] = []
    h = _FNV_OFFSET
    for i in range(len(tokens) // block_size):
        for t in tokens[i * block_size:(i + 1) * block_size]:
            t = int(t) & 0xFFFFFFFF
            for shift in (0, 8, 16, 24):
                h = ((h ^ ((t >> shift) & 0xFF)) * _FNV_PRIME) & _U64
        hashes.append(h)
    return hashes


class _PyPool:
    """Pure-Python twin of native/block_pool.cpp (identical semantics)."""

    def __init__(self, n_blocks: int) -> None:
        if n_blocks < 2:
            raise ValueError("need at least one real block beyond trash")
        self.n_blocks = n_blocks
        self._ref = [0] * n_blocks
        self._hash: List[Optional[int]] = [None] * n_blocks
        self._free = list(range(n_blocks - 1, 0, -1))      # LIFO like the C++
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # block -> ()
        self._by_hash: Dict[int, int] = {}
        self.lookups = self.hits = self.evictions = 0

    def available(self) -> int:
        return len(self._free) + len(self._cached)

    def _pop_one(self) -> int:
        if self._free:
            return self._free.pop()
        b, _ = self._cached.popitem(last=False)            # LRU-oldest
        h = self._hash[b]
        if h is not None:
            del self._by_hash[h]
            self._hash[b] = None
        self.evictions += 1
        return b

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0 or self.available() < n:
            return None
        out = []
        for _ in range(n):
            b = self._pop_one()
            self._ref[b] = 1
            out.append(b)
        return out

    def release(self, ids: Sequence[int]) -> None:
        bad = [b for b in ids
               if not 0 < b < self.n_blocks or self._ref[b] <= 0]
        if bad:
            raise ValueError(f"releasing invalid/free block ids {bad}")
        for b in ids:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                if self._hash[b] is not None:
                    self._cached[b] = None                 # MRU end
                else:
                    self._free.append(b)

    def lookup(self, h: int) -> Optional[int]:
        self.lookups += 1
        b = self._by_hash.get(h & _U64)
        if b is None:
            return None
        if self._ref[b] == 0:
            del self._cached[b]
        self._ref[b] += 1
        self.hits += 1
        return b

    def register(self, h: int, block: int) -> None:
        if not 0 < block < self.n_blocks or self._ref[block] <= 0:
            raise ValueError(f"registering invalid/free block id {block}")
        h &= _U64
        if self._hash[block] is not None or h in self._by_hash:
            return
        self._hash[block] = h
        self._by_hash[h] = block

    def refcount(self, block: int) -> int:
        if not 0 <= block < self.n_blocks:
            return -1
        return self._ref[block]

    def cached_count(self) -> int:
        return len(self._cached)


class _NativePool:
    """ctypes facade over the C++ allocator with the _PyPool interface."""

    def __init__(self, n_blocks: int) -> None:
        lib = _load_library()
        if lib is None:
            raise RuntimeError(f"native block pool unavailable: g++ could not build "
                               f"{_SRC}")
        self._lib = lib
        self.n_blocks = n_blocks
        self._ctx = ctypes.c_void_p(lib.bp_new(n_blocks))
        if not self._ctx:
            raise ValueError("need at least one real block beyond trash")

    def available(self) -> int:
        return self._lib.bp_available(self._ctx)

    def alloc(self, n: int) -> Optional[List[int]]:
        out = (ctypes.c_int32 * max(n, 1))()
        if self._lib.bp_alloc(self._ctx, n, out) != 0:
            return None
        return list(out[:n])

    def release(self, ids: Sequence[int]) -> None:
        ids = list(ids)
        arr = (ctypes.c_int32 * max(len(ids), 1))(*ids)
        if self._lib.bp_release(self._ctx, arr, len(ids)) != 0:
            raise ValueError(f"releasing invalid/free block ids in {ids}")

    def lookup(self, h: int) -> Optional[int]:
        b = self._lib.bp_lookup(self._ctx, h & _U64)
        return None if b < 0 else b

    def register(self, h: int, block: int) -> None:
        if self._lib.bp_register(self._ctx, h & _U64, block) != 0:
            raise ValueError(f"registering invalid/free block id {block}")

    def refcount(self, block: int) -> int:
        return self._lib.bp_refcount(self._ctx, block)

    def cached_count(self) -> int:
        return int(self._lib.bp_stat(self._ctx, 3))

    @property
    def lookups(self) -> int:
        return int(self._lib.bp_stat(self._ctx, 0))

    @property
    def hits(self) -> int:
        return int(self._lib.bp_stat(self._ctx, 1))

    @property
    def evictions(self) -> int:
        return int(self._lib.bp_stat(self._ctx, 2))

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.bp_destroy(ctx)
            self._ctx = None


class PrefixBlockAllocator:
    """Refcounted block allocator with prefix-hash sharing.

    ``alloc``/``free`` as a plain free-list allocator, plus ``lookup`` /
    ``register`` for prefix-cache sharing and ``release`` (refcount-aware
    free). ``backend="native"`` (C++), ``"python"``, or ``"auto"`` (native
    when buildable)."""

    def __init__(self, n_blocks: int, block_size: int,
                 backend: str = "auto") -> None:
        self.n_blocks = n_blocks
        self.block_size = block_size
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown allocator backend {backend!r}")
        if backend == "python" or (backend == "auto" and not native_available()):
            self._impl = _PyPool(n_blocks)
            self.backend = "python"
        else:
            self._impl = _NativePool(n_blocks)
            self.backend = "native"

    @property
    def available(self) -> int:
        return self._impl.available()

    def alloc(self, n: int) -> Optional[List[int]]:
        return self._impl.alloc(n)

    def release(self, blocks: Sequence[int]) -> None:
        self._impl.release(blocks)

    # alias kept so PagedBatcher code reads the same with either allocator
    def free(self, blocks: Sequence[int]) -> None:
        self._impl.release(blocks)

    def lookup(self, h: int) -> Optional[int]:
        return self._impl.lookup(h)

    def register(self, h: int, block: int) -> None:
        self._impl.register(h, block)

    def refcount(self, block: int) -> int:
        return self._impl.refcount(block)

    @property
    def stats(self) -> Dict[str, int]:
        return {
            "prefix_lookups": int(self._impl.lookups),
            "prefix_hits": int(self._impl.hits),
            "evictions": int(self._impl.evictions),
            "cached_blocks": int(self._impl.cached_count()),
            "free_blocks": int(self.available),
        }
