"""Model hyperparameter config loaded from Meta's ``params.json``.

Capability parity with the reference's ModelArgs (reference:
src/model/modelargs.go:12-64) including its defaults and derived fields
(N_Rep, HeadDim computed at transformer build, reference
src/model/llamatransformer.go:73-82). Rebuilt as a frozen dataclass.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelArgs:
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = -1          # -1 ⇒ same as n_heads (MHA)
    vocab_size: int = -1          # filled in from the tokenizer
    multiple_of: int = 256        # SwiGLU hidden size rounding
    ffn_dim_multiplier: float = -1.0
    norm_eps: float = 1e-5
    use_scaled_rope: bool = False
    rope_theta: float = 500000.0
    # Llama-3.1 defaults; Llama-3.2 1B/3B checkpoints ship
    # rope_scaling_factor=32 in params.json
    rope_scale_factor: float = 8.0
    rope_high_freq_factor: float = 4.0
    max_sequence_length: int = 2048

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads > 0 else self.n_heads

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.kv_heads

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def model_type(self) -> str:
        """Architecture label by layer count, like the reference's detection
        (reference: src/model/loader.go:60-63)."""
        return {16: "Llama-3.2-1B", 28: "Llama-3.2-3B",
                32: "Llama-3.1-8B", 80: "Llama-3.1-70B",
                126: "Llama-3.1-405B"}.get(self.n_layers,
                                           f"Llama-custom-{self.n_layers}L")

    @property
    def ffn_hidden_dim(self) -> int:
        """SwiGLU hidden size: 2/3·4d, scaled, rounded up to multiple_of.

        Same formula the reference applies when wiring the FFN
        (reference: src/model/llamatransformer.go:569-577); for the 8B config
        this yields 14336.
        """
        hidden = int(4 * self.dim * 2 / 3)
        if self.ffn_dim_multiplier > 0:
            hidden = int(self.ffn_dim_multiplier * hidden)
        return self.multiple_of * ((hidden + self.multiple_of - 1) // self.multiple_of)

    def with_(self, **updates) -> "ModelArgs":
        return dataclasses.replace(self, **updates)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


_JSON_FIELDS = {
    "dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size", "multiple_of",
    "ffn_dim_multiplier", "norm_eps", "use_scaled_rope", "rope_theta",
    "rope_scale_factor", "rope_high_freq_factor",
}


def load_model_args(path: str, max_sequence_length: Optional[int] = None) -> ModelArgs:
    """Load ``params.json``, keeping reference defaults for absent keys."""
    with open(path, "r", encoding="utf-8") as f:
        raw = json.load(f)
    # Meta's Llama-3.2 params.json spells the scaled-RoPE overrides
    # "rope_scaling_factor" / "high_freq_factor"
    aliases = {"rope_scaling_factor": "rope_scale_factor",
               "high_freq_factor": "rope_high_freq_factor"}
    for src, dst in aliases.items():
        if src in raw and dst not in raw:
            raw[dst] = raw[src]
    known = {k: v for k, v in raw.items() if k in _JSON_FIELDS}
    args = ModelArgs(**known)
    if max_sequence_length is not None:
        args = args.with_(max_sequence_length=max_sequence_length)
    return args


def find_model_dir(candidates) -> Optional[str]:
    """First directory containing the three required model files.

    Mirrors the reference's model-path discovery (reference: cmd/main.go:211-240).
    """
    required = ("consolidated.00.pth", "params.json", "tokenizer.model")
    for root in candidates:
        if all(os.path.isfile(os.path.join(root, r)) for r in required):
            return root
    return None
