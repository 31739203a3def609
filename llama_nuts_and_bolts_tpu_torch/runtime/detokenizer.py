"""UTF-8-safe streaming detokenizer with byte-fallback buffering.

Capability parity with the reference's TokenToString path (reference:
src/inference/tokenize.go:197-259): a generated token may be an arbitrary
byte fragment (a fraction of a codepoint, which itself may be a fraction of a
grapheme). Invalid-UTF-8 pieces — and lone combining-mark/ZWJ runes — are
treated as byte fallbacks and buffered in ``waiting_bytes`` until the buffer
decodes cleanly, at which point completed runes flow into the emoji
accumulator (runtime/emoji.py).
"""

from __future__ import annotations

import unicodedata
from typing import Tuple

from llama_nuts_and_bolts_tpu_torch.runtime.emoji import ZWJ, process_emoji
from llama_nuts_and_bolts_tpu_torch.runtime.types import DecodingContext, TokenPiece
from llama_nuts_and_bolts_tpu_torch.tokenizer.vocab import Vocabulary


def _piece_is_byte_fallback(piece: bytes) -> bool:
    try:
        text = piece.decode("utf-8")
    except UnicodeDecodeError:
        return True
    # a single rune occupying the whole piece, >2 bytes, that is a combining
    # mark or ZWJ: emitted alone it can't render; buffer it like raw bytes
    # (reference: src/inference/tokenize.go:206-215)
    if len(text) == 1 and len(piece) > 2:
        ch = text[0]
        if ch == ZWJ or unicodedata.category(ch).startswith("M"):
            return True
    return False


def token_to_string(
    vocab: Vocabulary, token_id: int, ctx: DecodingContext
) -> Tuple[TokenPiece, str, bool]:
    """Returns (token, emitted_string, added_to_waiting)."""
    piece = vocab.piece(token_id)
    if piece is None:
        return TokenPiece(piece=b"<UNKNOWN>", rank=token_id), "", False

    token = TokenPiece(piece=piece, rank=token_id)
    if _piece_is_byte_fallback(piece):
        token.is_byte = True
        token.byte_fallback = piece

    result = ""
    if ctx.waiting_runes_extra_str and not token.is_byte:
        # a normal token arrived while an emoji annotation was pending: flush it
        result = ctx.waiting_runes_extra_str
        ctx.waiting_runes = ""
        ctx.waiting_runes_extra_str = ""

    if token.is_byte:
        ctx.waiting_bytes.extend(token.byte_fallback)
        try:
            decoded = ctx.waiting_bytes.decode("utf-8")
        except UnicodeDecodeError:
            return token, result, True
        ch = decoded[0]
        del ctx.waiting_bytes[: len(ch.encode("utf-8"))]
        result += process_emoji(ctx, ch)
        return token, result, False

    result += piece.decode("utf-8")
    return token, result, False


def token_batch_to_string(vocab: Vocabulary, token_ids) -> Tuple[list, str]:
    """Decode a whole list at once with a fresh context (reference:
    src/inference/tokenize.go:241-259); stops at pad."""
    ctx = DecodingContext()
    tokens = []
    out = ""
    for tid in token_ids:
        if tid == vocab.pad_id:
            break
        token, s, added = token_to_string(vocab, tid, ctx)
        tokens.append(token)
        if not added:
            out += s
    return tokens, out
