"""``<0xNN>`` escape expansion for byte-level token literals.

Capability parity with the reference's test helper (reference:
src/common/utils.go:79-107): test fixtures and docs write byte-fallback
tokens as ``<0xF0><0x9F>…``; this expands them to raw bytes. The inverse
rendering lives on TokenPiece.byte_fallback_string (runtime/types.py).
"""

from __future__ import annotations


def replace_hex_with_bytes(s: str) -> bytes:
    out = bytearray()
    i = 0
    while i < len(s):
        if (s[i] == "<" and i + 5 < len(s) and s[i + 1 : i + 3] == "0x"
                and s[i + 5] == ">"):
            try:
                out.append(int(s[i + 3 : i + 5], 16))
                i += 6
                continue
            except ValueError:
                pass
        out.extend(s[i].encode("utf-8"))
        i += 1
    return bytes(out)
