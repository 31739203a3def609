"""Llama-3 chat template assembly.

Capability parity with the reference's prompt tokenizer (reference:
src/inference/tokenize.go:14-95): the prompt is framed as

    <|begin_of_text|>
    per part: <|start_header_id|>{header}<|end_header_id|>\\n\\n{content}<|eot_id|>

with an implicit empty ``assistant`` part appended last (no trailing
``<|eot_id|>`` on it) so the model continues as the assistant. Parts with empty
content that are not the final assistant part are skipped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from llama_nuts_and_bolts_tpu_torch.tokenizer.bpe import encode_ordinary
from llama_nuts_and_bolts_tpu_torch.tokenizer.vocab import Vocabulary

B_TXT = "<|begin_of_text|>"
B_HEADER = "<|start_header_id|>"
E_HEADER = "<|end_header_id|>"
E_TURN = "<|eot_id|>"


@dataclass
class PromptPart:
    header: str          # "system" | "user" | "assistant"
    content: str
    is_last_assistant: bool = False


def render_chat_tokens(
    parts: Sequence[PromptPart],
    vocab: Vocabulary,
    ranks: Dict[bytes, int],
) -> List[int]:
    special = vocab.special_token_to_id
    out: List[int] = [special[B_TXT]]

    all_parts = list(parts) + [PromptPart("assistant", "", is_last_assistant=True)]
    for part in all_parts:
        if not part.is_last_assistant and not part.content:
            continue
        out.append(special[B_HEADER])
        out.extend(encode_ordinary(part.header, ranks))
        out.append(special[E_HEADER])
        out.extend(encode_ordinary("\n\n", ranks))
        out.extend(encode_ordinary(part.content, ranks))
        if not part.is_last_assistant:
            out.append(special[E_TURN])
    return out


def render_prefix_tokens(
    parts: Sequence[PromptPart],
    vocab: Vocabulary,
    ranks: Dict[bytes, int],
) -> List[int]:
    """Tokens shared by EVERY conversation that begins with ``parts`` (e.g. a
    fixed system prompt) — render_chat_tokens without the implicit trailing
    assistant header, exactly the token prefix ``engine.cache_prefix`` wants.
    The template's special tokens bound each part, so BPE merges cannot cross
    the boundary and the prefix property is exact."""
    special = vocab.special_token_to_id
    out: List[int] = [special[B_TXT]]
    for part in parts:
        if not part.content:
            continue
        out.append(special[B_HEADER])
        out.extend(encode_ordinary(part.header, ranks))
        out.append(special[E_HEADER])
        out.extend(encode_ordinary("\n\n", ranks))
        out.extend(encode_ordinary(part.content, ranks))
        out.append(special[E_TURN])
    return out
