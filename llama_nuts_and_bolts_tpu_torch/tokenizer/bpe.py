"""Exact tiktoken byte-pair merge + GPT-4-style pre-tokenization.

Capability parity with the reference's BPE (reference:
src/inference/tokenize.go:109-195, itself following tiktoken's Rust
``_byte_pair_merge``), rebuilt in Python over ``bytes``. Unlike the reference's
Go-RE2 regex — which had to drop tiktoken's ``\\s+(?!\\S)`` negative lookahead
(reference: src/model/vocabulary.go:32 comment) — we use the real Llama-3
pattern via the ``regex`` module, matching Meta's tokenizer exactly.

The merge loop runs in the C++ fast path of ``native/`` (``tokenizer/native.py``)
where it can be built; this file is the always-available Python merge and
the oracle it is tested against.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import regex

# Llama-3 / cl100k-family pre-tokenization pattern (the real tiktoken one,
# with the negative lookahead the Go reference could not express).
LLAMA3_SPLIT_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
    r"|[^\r\n\p{L}\p{N}]?\p{L}+"
    r"|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+"
)

_SPLIT_RE = regex.compile(LLAMA3_SPLIT_PATTERN)

_MAX_RANK = 0x7FFFFFFF


def byte_pair_merge(piece: bytes, ranks: Dict[bytes, int]) -> List[int]:
    """Split ``piece`` into token ids via tiktoken's lowest-rank-first merges.

    Maintains a list of (start_index, rank-of-pair-starting-here) boundaries;
    repeatedly merges the boundary whose adjacent pair has the globally lowest
    rank until no mergeable pair remains.
    """
    n = len(piece)
    if n == 1:
        return [ranks[piece]]

    # parts[i] = [byte offset, rank of merging piece[offset_i : offset_{i+2}]]
    parts: List[List[int]] = []
    for i in range(n - 1):
        parts.append([i, ranks.get(piece[i : i + 2], _MAX_RANK)])
    parts.append([n - 1, _MAX_RANK])
    parts.append([n, _MAX_RANK])

    def pair_rank(i: int) -> int:
        if i + 3 <= len(parts) - 1:
            return ranks.get(piece[parts[i][0] : parts[i + 3][0]], _MAX_RANK)
        return _MAX_RANK

    while True:
        best_rank, best_i = _MAX_RANK, -1
        for i, (_, r) in enumerate(parts[:-1]):
            if r < best_rank:
                best_rank, best_i = r, i
        if best_i < 0:
            break
        i = best_i
        if i > 0:
            parts[i - 1][1] = pair_rank(i - 1)
        parts[i][1] = pair_rank(i)
        del parts[i + 1]

    return [
        ranks[piece[parts[i][0] : parts[i + 1][0]]] for i in range(len(parts) - 1)
    ]


# per-vocabulary native merge contexts (one vocab per process in practice),
# by id(ranks). Each entry holds its ranks: the JAX package keys on the id
# alone, so a freed table's id could hand its context to a new table.
_NATIVE_CACHE: Dict[int, Tuple[Dict[bytes, int], object]] = {}
_NATIVE_LOCK = threading.Lock()


def _native_for(ranks: Dict[bytes, int]):
    """The native merge context of ``ranks``, or None where the library
    cannot be built."""
    with _NATIVE_LOCK:
        entry = _NATIVE_CACHE.get(id(ranks))
        if entry is None or entry[0] is not ranks:
            from llama_nuts_and_bolts_tpu_torch.tokenizer.native import (
                NativeBpe,
                native_available,
            )

            entry = (ranks, NativeBpe(ranks) if native_available() else None)
            _NATIVE_CACHE[id(ranks)] = entry
        return entry[1]


def encode_ordinary(text: str, ranks: Dict[bytes, int],
                    use_native: bool = True) -> List[int]:
    """Encode plain text (no special tokens): regex pre-split, then BPE.

    The merge loop runs in the C++ fast path (native/bpe_merge.cpp) when the
    shared library is available, else in :func:`byte_pair_merge`; both
    implement the same tiktoken algorithm and are cross-tested. A piece the
    native merge cannot encode goes to the Python merge, as in the JAX
    package."""
    native = _native_for(ranks) if use_native else None
    out: List[int] = []
    for match in _SPLIT_RE.finditer(text):
        piece = match.group().encode("utf-8")
        if native is not None:
            ids: Optional[List[int]] = native.encode_piece(piece)
            if ids is not None:
                out.extend(ids)
                continue
        rank = ranks.get(piece)
        if rank is not None:
            out.append(rank)
        else:
            out.extend(byte_pair_merge(piece, ranks))
    return out
