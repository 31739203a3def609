"""Vocabulary: id↔token maps over merged base + special tokens.

Capability parity with the reference's Vocabulary (reference:
src/model/vocabulary.go:9-50). Base tokens are raw ``bytes`` (tiktoken ranks);
special tokens are strings stored as UTF-8 bytes. Ids are dense
``0..vocab_size``; pad/unknown are -1 as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from llama_nuts_and_bolts_tpu_torch.tokenizer.tiktoken_io import TiktokenModel


@dataclass
class Vocabulary:
    token_to_id: Dict[bytes, int]
    id_to_token: List[bytes]
    special_token_to_id: Dict[str, int]
    special_ids: Set[int]
    bos_id: int
    eos_id: int
    pad_id: int = -1
    unknown_id: int = -1
    stop_token_ids: Set[int] = field(default_factory=set)

    @classmethod
    def from_tiktoken(cls, model: TiktokenModel) -> "Vocabulary":
        size = model.vocab_size
        id_to_token: List[bytes] = [b""] * size
        token_to_id: Dict[bytes, int] = {}
        for token, rank in model.mergeable_ranks.items():
            token_to_id[token] = rank
            id_to_token[rank] = token
        for token, rank in model.special_tokens.items():
            token_to_id[token.encode("utf-8")] = rank
            id_to_token[rank] = token.encode("utf-8")
        return cls(
            token_to_id=token_to_id,
            id_to_token=id_to_token,
            special_token_to_id=dict(model.special_tokens),
            special_ids=set(model.special_tokens.values()),
            bos_id=model.bos_id,
            eos_id=model.eos_id,
            pad_id=model.pad_id,
            unknown_id=model.unknown_id,
            stop_token_ids=set(model.stop_token_ids),
        )

    @property
    def size(self) -> int:
        return len(self.id_to_token)

    def piece(self, token_id: int) -> Optional[bytes]:
        if 0 <= token_id < len(self.id_to_token):
            return self.id_to_token[token_id]
        return None

    def is_special(self, token_id: int) -> bool:
        return token_id in self.special_ids

    def is_stop(self, token_id: int) -> bool:
        return token_id in self.stop_token_ids

    def debug_string(self, token_ids) -> str:
        """``[id: N, piece]``-style listing (reference: src/inference/tokenize.go:261-275)."""
        out = []
        for tid in token_ids:
            if tid == self.pad_id:
                break
            piece = self.piece(tid)
            if piece is None:
                out.append(f"[id: {tid}, UNKNOWN ID]")
            else:
                out.append(f"[id: {tid}, {piece.decode('utf-8', errors='replace')}]")
        return ", ".join(out)
