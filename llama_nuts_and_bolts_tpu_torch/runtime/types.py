"""Streaming generation datatypes.

Capability parity with the reference's generation types (reference:
src/inference/inference.go:11-46, src/model/model.go:78-107,
src/common/inferenceargs.go:3-11).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class GenerationState(enum.Enum):
    IN_PROGRESS = 1
    FINISHED_BY_REACHING_EOS = 2
    FINISHED_BY_REACHING_SEQ_LEN = 3
    # Beyond-reference extension (the reference's three states above map to
    # src/inference/inference.go's GenerationState values): the serving
    # schedulers deliver this as a terminal SENTINEL on request.cancel() so
    # a consumer blocked in Request.tokens() terminates instead of waiting
    # out its timeout. Request.tokens() swallows it — consumers never see a
    # token for it.
    CANCELLED = 4


@dataclass
class TokenPiece:
    piece: bytes
    rank: int
    is_byte: bool = False
    byte_fallback: Optional[bytes] = None

    def byte_fallback_string(self) -> str:
        """``<0xNN>`` rendering of byte-fallback tokens (reference:
        src/model/model.go:98-107)."""
        if self.byte_fallback is None:
            return ""
        return "".join(f"<0x{b:02X}>" for b in self.byte_fallback)

    def __str__(self) -> str:
        if self.is_byte:
            return f'"{self.byte_fallback_string()}" rank: {self.rank}, type: BYTE'
        return f'"{self.piece.decode("utf-8", errors="replace")}" rank: {self.rank}, type: NORMAL'


@dataclass
class GeneratedPart:
    token_id: int
    token: TokenPiece
    decoded_string: str
    added_to_waiting: bool
    waiting_runes_extra_str: str
    generation_state: GenerationState
    is_resend_of_waiting: bool = False


@dataclass
class InferenceArgs:
    """0 ⇒ use the model's max_sequence_length, like the reference."""

    sequence_length: int = 0
    batch_size: int = 1
    # idiomatic extensions beyond the greedy-only reference:
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # "auto" (the CUDA kernels on a card when head_dim is a multiple of 128,
    # else the plain path; engine._attn_impl) | "plain" | "flash" (the CUDA
    # kernels K1 and K2, or K4 for an int8 cache) | "flash_folded" (K4 to
    # decode)
    attn_impl: str = "auto"
    # decode steps per captured graph replay: 0 is auto (1 on a card), and
    # k > 1 streams in k-step chunks (runtime/decode_graph.py)
    decode_chunk: int = 0
    # n-gram prompt-lookup speculative decoding (ROADMAP.md; 0 disables)
    speculate_k: int = 0
    # "bf16" | "int8" (rows quantized per position and head, bf16 scales)
    kv_cache_dtype: str = "bf16"
    # process prompts longer than this many tokens in fixed-size chunks:
    # bounds prefill activation/attention memory at long context (0 = off)
    prefill_chunk: int = 0


@dataclass
class DecodingContext:
    """Waiting-bytes / waiting-runes state machine carried across tokens
    (reference: src/inference/inference.go:33-39)."""

    waiting_bytes: bytearray = field(default_factory=bytearray)
    waiting_parts: List[GeneratedPart] = field(default_factory=list)
    waiting_runes: str = ""
    waiting_runes_extra_str: str = ""
    decoding_finished: bool = False
