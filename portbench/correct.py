"""How ``correct`` is decided: what the timed path served, against the
plain reference.

Once the window has closed and the program's state is freed, a sample of
the requests the program finished, drawn from the seed and always holding
the longest, is run through the plain reference of the cell's model family
(``Bench.family``; the Llama block's is ``reference.py`` here) once: each
prompt with its served tokens. At every served token the reference's
float32 logits give the gap by which that token's logit lies below the
reference's best; the widest gap over every compared token is held to the
cell's limit (``portbench/limits/<cell>.json``). Greedy tokens on random
weights part from the reference only at near ties, by about the bf16
path's rounding; a wrong cache row, position or token is far off.

The control (``control_gap``) is the reference in float8 put in the
program's place: at the same positions, the gap of the token that float8
puts first, judged by the same checks as the program's tokens.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.record import Served

SAMPLE_SALT = 0x5EED


def sample(done: Sequence[Served], k: int, seed: int) -> List[Served]:
    """``k`` finished requests drawn from ``seed``, the longest (prompt and
    output) among them."""
    done = [s for s in done if s.finished]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: done[i].prompt_len + len(done[i].tokens))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng(int(seed) ^ SAMPLE_SALT)
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [done[longest]] + [done[rest[i]] for i in sorted(pick)]


def _sequences(reqs: Sequence[Served]) -> Tuple[list, list]:
    # row t predicts token t + 1: the served tokens' rows start at the
    # prompt's last row, and the last served token needs no row
    seqs = [list(s.prompt) + list(s.tokens[:-1]) for s in reqs]
    return seqs, [s.prompt_len - 1 for s in reqs]


def _gaps(ref_rows: List[torch.Tensor], chosen: List[torch.Tensor]) -> float:
    widest = 0.0
    for logits, tok in zip(ref_rows, chosen):
        best = logits.max(dim=-1).values
        got = logits.gather(-1, tok[:, None].to(logits.device))[:, 0]
        widest = max(widest, float((best - got).max()))
    return widest


def served_gap(Reference: type, weights: Dict, cfg: Dict, reqs: Sequence[Served]) -> float:
    """The widest gap of a served token below ``Reference``'s best."""
    seqs, first = _sequences(reqs)
    ref = Reference(weights, cfg).logits(seqs, first)
    return _gaps(ref, [torch.tensor(s.tokens, dtype=torch.long) for s in reqs])


def control_gap(Reference: type, weights: Dict, cfg: Dict,
                reqs: Sequence[Served]) -> Tuple[float, float]:
    """The control's reading beside the program's on the same requests:
    (the widest gap of float8's first choice, the program's widest gap)."""
    seqs, first = _sequences(reqs)
    ref = Reference(weights, cfg).logits(seqs, first)
    low = Reference(weights, cfg, precision="fp8").logits(seqs, first)
    picks = [rows.argmax(dim=-1) for rows in low]
    tokens = [torch.tensor(s.tokens, dtype=torch.long) for s in reqs]
    return _gaps(ref, picks), _gaps(ref, tokens)


def checks(gap: float, n_tokens: int, limits: Dict) -> Dict[str, Dict]:
    """The numbers compared, each beside its limit."""
    return {
        "logit_gap": {"value": gap, "limit": limits["logit_gap"]["limit"], "at": "most"},
        "tokens_compared": {"value": n_tokens, "limit": limits["tokens_compared"]["limit"],
                            "at": "least"},
    }


def passed(c: Dict[str, Dict]) -> bool:
    return all((v["value"] <= v["limit"]) if v["at"] == "most" else (v["value"] >= v["limit"])
               for v in c.values())
