"""ctypes binding to the C++ BPE merge (``native/bpe_merge.cpp``).

Port of ``llama_nuts_and_bolts_tpu/tokenizer/native.py``. The library is
built with ``g++`` at first use into ``build/native/`` at the repository root
(``utils/native_lib.py``), not next to its source. It is host code: where it
cannot be built, :func:`native_available` is False and ``encode_ordinary``
runs the Python merge, which computes the same ids.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

from llama_nuts_and_bolts_tpu_torch.utils.native_lib import NativeLibrary

_i32p = ctypes.POINTER(ctypes.c_int32)
_LIB = NativeLibrary("bpe_merge", (
    ("bpe_ctx_new", ctypes.c_void_p, [ctypes.c_char_p, _i32p, _i32p, ctypes.c_int32]),
    ("bpe_ctx_free", None, [ctypes.c_void_p]),
    ("bpe_encode", ctypes.c_int32, [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                                    _i32p])))


def native_available() -> bool:
    return _LIB.load() is not None


class NativeBpe:
    """Holds a native rank table; :meth:`encode_piece` runs the C++ merge."""

    def __init__(self, ranks: Dict[bytes, int]) -> None:
        lib = _LIB.load()
        if lib is None:
            raise RuntimeError(f"native BPE library unavailable: g++ could not build "
                               f"{_LIB.src}")
        self._lib = lib
        n = len(ranks)
        lens = (ctypes.c_int32 * n)(*(len(t) for t in ranks))
        rank_vals = (ctypes.c_int32 * n)(*ranks.values())
        self._ctx = ctypes.c_void_p(lib.bpe_ctx_new(b"".join(ranks), lens, rank_vals, n))
        if not self._ctx:
            raise RuntimeError("bpe_ctx_new failed")

    def encode_piece(self, piece: bytes) -> Optional[List[int]]:
        """Token ids for one pre-split piece, or None if a part of it is not
        in the table. Thread-safe: the output buffer is made per call (the
        server's handler threads share one tokenizer, and a shared buffer
        once corrupted concurrent prompts' ids in the JAX package); the C++
        side only reads the rank table."""
        out = (ctypes.c_int32 * max(len(piece), 1))()
        n = self._lib.bpe_encode(self._ctx, piece, len(piece), out)
        if n < 0:
            return None
        return list(out[:n])

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.bpe_ctx_free(ctx)
            self._ctx = None
