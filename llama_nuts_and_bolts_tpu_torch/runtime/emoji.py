"""Emoji/grapheme streaming annotation.

Behavior parity with the reference's emoji processor (reference:
src/inference/emoji.go:54-164): graphic runes and ZWJ accumulate in
``waiting_runes``; the accumulated string is segmented greedily into the
longest substrings that are *exact keys of the gemoji alias table*
(runtime/gemoji.py — the same public data behind the reference's
``enescakir/emoji`` map); recognized sequences are annotated
``[:alias:\\UXXXXXXXX…]`` and everything else falls back to per-rune
``[:UNICODE NAME:\\UXXXXXXXX]`` — the reference's fallback format.

Segmentation is driven by the alias table itself, exactly like the
reference's ``searchMinimumEmojiCount`` (src/inference/emoji.go:95-164):
🕰 without VS16 is not a table key (gemoji lists only 🕰️), so it is
annotated ``[:MANTELPIECE CLOCK:\\U0001F570]``, while 🇹🇷 is a key and
becomes ``[:flag_for_turkey:\\U0001F1F9\\U0001F1F7]``.
"""

from __future__ import annotations

import unicodedata
from typing import List, Optional

from llama_nuts_and_bolts_tpu_torch.runtime.gemoji import alias_table, lookup
from llama_nuts_and_bolts_tpu_torch.runtime.types import DecodingContext

ZWJ = "‍"
VS16 = "️"


def is_emoji_sequence(s: str) -> bool:
    """True if ``s`` as a whole is a known emoji / emoji sequence (an exact
    key of the gemoji alias table, like the reference's map membership)."""
    return s in alias_table()


def emoji_alias(seq: str) -> Optional[str]:
    """``:alias:`` for a recognized emoji sequence, else None."""
    return lookup(seq)


def _rune_name(ch: str) -> str:
    try:
        return unicodedata.name(ch)
    except ValueError:
        return f"U+{ord(ch):04X}"


def _rune_annotation(s: str) -> str:
    return "".join(f"[:{_rune_name(ch)}:\\U{ord(ch):08X}]" for ch in s)


def _escapes(s: str) -> str:
    return "".join(f"\\U{ord(ch):08X}" for ch in s)


def segment_emoji(s: str) -> List[str]:
    """Greedy longest-known-emoji segmentation of ``s`` (reference:
    src/inference/emoji.go:95-164 does the same via substring replacement:
    for each start position, the longest substring that is a key of the
    alias map wins; unmatched positions emit single runes)."""
    table = alias_table()
    parts: List[str] = []
    i = 0
    while i < len(s):
        matched = None
        for j in range(len(s), i, -1):
            if s[i:j] in table:
                matched = s[i:j]
                break
        if matched is None:
            matched = s[i]
        parts.append(matched)
        i += len(matched)
    return parts


def _is_graphic(ch: str) -> bool:
    # Go's unicode.IsGraphic: letters/marks/numbers/punct/symbols/spaces
    return ch.isprintable() or ch == " "


def process_emoji(ctx: DecodingContext, ch: str) -> str:
    """Feed one decoded rune; returns the string to emit now and updates the
    annotation in ``ctx.waiting_runes_extra_str``
    (reference: src/inference/emoji.go:54-93)."""
    if ctx.decoding_finished:
        ctx.decoding_finished = False
    graphic = _is_graphic(ch) or ch == ZWJ
    if graphic:
        ctx.waiting_runes += ch
    extra = ""
    for part in segment_emoji(ctx.waiting_runes):
        alias = emoji_alias(part)
        if alias is not None:
            extra += f"[{alias}{_escapes(part)}]"
        else:
            extra += _rune_annotation(part)
    ctx.waiting_runes_extra_str = extra
    if not graphic:
        extra = ctx.waiting_runes_extra_str
        ctx.waiting_runes = ""
        ctx.waiting_runes_extra_str = ""
        return extra + ch
    return ch
