"""tiktoken ``tokenizer.model`` file ingest + Llama-3 special tokens.

Capability parity with the reference's tokenizer-model reader (reference:
src/tiktoken/tiktokenreader.go:12-85): each line of the file is
``<base64 token> <rank>``; 256 special tokens are appended after the base
vocabulary — 11 named ones and ``<|reserved_special_token_N|>`` fill — with
BOS/EOS/stop ids wired to the Llama-3 names and pad/unknown = -1.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

NUM_RESERVED_SPECIAL_TOKENS = 256

# the 11 leading named special tokens, in rank order (reference:
# src/tiktoken/tiktokenreader.go:48-60); the rest of the 256 slots are
# <|reserved_special_token_2|> .. <|reserved_special_token_246|>
NAMED_SPECIAL_TOKENS: Tuple[str, ...] = (
    "<|begin_of_text|>",
    "<|end_of_text|>",
    "<|reserved_special_token_0|>",
    "<|reserved_special_token_1|>",
    "<|finetune_right_pad_id|>",
    "<|step_id|>",
    "<|start_header_id|>",
    "<|end_header_id|>",
    "<|eom_id|>",
    "<|eot_id|>",
    "<|python_tag|>",
)


@dataclass
class TiktokenModel:
    mergeable_ranks: Dict[bytes, int]
    special_tokens: Dict[str, int]
    bos_id: int
    eos_id: int
    pad_id: int = -1
    unknown_id: int = -1
    stop_token_ids: List[int] = field(default_factory=list)

    @property
    def vocab_size(self) -> int:
        return len(self.mergeable_ranks) + len(self.special_tokens)


def build_special_tokens(base_vocab_size: int) -> Dict[str, int]:
    names = list(NAMED_SPECIAL_TOKENS)
    for i in range(NUM_RESERVED_SPECIAL_TOKENS - len(names)):
        names.append(f"<|reserved_special_token_{2 + i}|>")
    return {name: base_vocab_size + i for i, name in enumerate(names)}


def load_tiktoken_ranks(path: str) -> Dict[bytes, int]:
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token_b64, rank_str = line.split(b" ")
            ranks[base64.b64decode(token_b64)] = int(rank_str)
    return ranks


def load_tiktoken_model(path: str) -> TiktokenModel:
    ranks = load_tiktoken_ranks(path)
    special = build_special_tokens(len(ranks))
    return TiktokenModel(
        mergeable_ranks=ranks,
        special_tokens=special,
        bos_id=special["<|begin_of_text|>"],
        eos_id=special["<|end_of_text|>"],
        stop_token_ids=[special["<|eom_id|>"], special["<|eot_id|>"]],
    )
