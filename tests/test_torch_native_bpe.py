"""The PyTorch port's native BPE merge (``tokenizer/native.py`` over
``native/bpe_merge.cpp``) against its Python merge, the JAX package's
``encode_ordinary`` and the tiktoken oracle, on the JAX package's
synthetic ranks (tests/test_tokenizer.py); concurrent encodes; the
per-vocabulary context cache; and the ``utils/hexcodes.py`` copy. Where
``g++`` is missing the native tests skip inside the test."""

import random
import threading

import pytest

from llama_nuts_and_bolts_tpu.tokenizer.bpe import encode_ordinary as jax_encode_ordinary
from llama_nuts_and_bolts_tpu.utils.hexcodes import (
    replace_hex_with_bytes as jax_replace_hex_with_bytes,
)

from llama_nuts_and_bolts_tpu_torch.tokenizer import bpe
from llama_nuts_and_bolts_tpu_torch.tokenizer.bpe import byte_pair_merge, encode_ordinary
from llama_nuts_and_bolts_tpu_torch.tokenizer.native import (
    _LIB,
    NativeBpe,
    native_available,
)
from llama_nuts_and_bolts_tpu_torch.utils.hexcodes import replace_hex_with_bytes
from tests.test_tokenizer import ORACLE, RANKS

TEXTS = ["the quick brown fox", "What is your name?", "1234 tokens",
         "café 日本語 \U0001F600", "   spaces\n\nnewlines", "",
         "hello world ümläut \U0001F1FA\U0001F1F8 it's 42!\r\n 987"]


@pytest.fixture
def native():
    if not native_available():
        pytest.skip("g++ unavailable: the native merge is not built")
    return NativeBpe(RANKS)


def test_library_is_built_under_build_native(native):
    assert _LIB.so.parent.name == "native" and _LIB.so.parent.parent.name == "build"
    assert _LIB.so.is_file() and _LIB.src.name == "bpe_merge.cpp"


def test_pieces_match_the_python_merge(native):
    rng = random.Random(42)
    for _ in range(300):
        piece = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 24)))
        assert native.encode_piece(piece) == byte_pair_merge(piece, RANKS), piece


@pytest.mark.parametrize("text", TEXTS)
def test_encode_ordinary_native_and_python_match_jax_and_tiktoken(native, text):
    want = ORACLE.encode_ordinary(text)
    assert encode_ordinary(text, RANKS, use_native=True) == want
    assert encode_ordinary(text, RANKS, use_native=False) == want
    assert jax_encode_ordinary(text, RANKS) == want
    assert encode_ordinary(text, RANKS) == want                 # native by default


def test_unencodable_piece_returns_none(native):
    partial = {tok: r for tok, r in RANKS.items() if len(tok) > 1 or tok != b"q"}
    assert NativeBpe(partial).encode_piece(b"q") is None
    assert native.encode_piece(b"q") == [RANKS[b"q"]]


def test_concurrent_encodes_from_threads(native):
    """One context shared by threads (the server's handlers share the
    engine's tokenizer) gives each call its serial result: the output
    buffer is the call's own."""
    rng = random.Random(3)
    pieces = [bytes(rng.randrange(256) for _ in range(rng.randrange(1, 40)))
              for _ in range(16)]
    serial = {p: native.encode_piece(p) for p in pieces}
    errors = []

    def worker(seed):
        r = random.Random(seed)
        for _ in range(300):
            p = pieces[r.randrange(len(pieces))]
            got = native.encode_piece(p)
            if got != serial[p]:
                errors.append((p, got, serial[p]))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]


def test_context_cache_holds_its_table(native):
    """A context is kept with the table it was built from, so a table at a
    freed table's id never receives that context (the JAX package keys on
    the id alone)."""
    ranks = dict(RANKS)
    ctx = bpe._native_for(ranks)
    assert isinstance(ctx, NativeBpe) and bpe._native_for(ranks) is ctx
    assert bpe._NATIVE_CACHE[id(ranks)][0] is ranks
    other = {bytes([i]): i for i in range(256)}
    # a stale entry under other's id, built from another table
    bpe._NATIVE_CACHE[id(other)] = (ranks, ctx)
    fresh = bpe._native_for(other)
    assert fresh is not ctx and bpe._NATIVE_CACHE[id(other)][0] is other
    assert fresh.encode_piece(b"th") == [ord("t"), ord("h")]
    del bpe._NATIVE_CACHE[id(other)], bpe._NATIVE_CACHE[id(ranks)]


def test_python_merge_where_the_library_is_missing(monkeypatch):
    """Host code: without the library ``encode_ordinary`` runs the Python
    merge, which gives the same ids."""
    monkeypatch.setattr(bpe, "_NATIVE_CACHE", {})
    monkeypatch.setattr(_LIB, "load", lambda: None)
    assert not native_available()
    ranks = dict(RANKS)
    for text in TEXTS:
        assert encode_ordinary(text, ranks) == ORACLE.encode_ordinary(text)
    assert bpe._NATIVE_CACHE[id(ranks)] == (ranks, None)
    with pytest.raises(RuntimeError, match="native BPE library unavailable"):
        NativeBpe(ranks)


@pytest.mark.parametrize("s", ["<0xF0><0x9F>ab", "plain", "<0xZZ>", "é<0x00>", "<0x4",
                               "<0x41>", "x<0x0a>y<0xff>", "<<0x41>>", ""])
def test_replace_hex_with_bytes_matches_jax(s):
    assert replace_hex_with_bytes(s) == jax_replace_hex_with_bytes(s)
