"""K8's split rule read on one card: the kernel timed at :func:`k8_split`'s
groups per split and at half and twice that (twice only where x's budget
allows it), at the nine shapes ``chip_smoke.py`` times (Llama-3.1-8B's wq, wk,
w_gate, w_down and head at R=1; wq and w_down at R=16 and 32). The weights
are random int4 in groups of 256, as many copies of each as keep a cycled
run's bytes outside the 50 MB L2; every split of a shape is timed in the
same rounds, so they compare within one call. Run from the repository root:

    python -m llama_nuts_and_bolts_tpu_torch.kernels.k8_splits

Prints one JSON line: per shape the chosen split and the ms per round at
each split tried, and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.k2_breakdown import cycled_ms
from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import K8_X_BYTES, k8_split, q4_matmul
from llama_nuts_and_bolts_tpu_torch.quant import quantize_tensor_q4

# (name, out, in) of Llama-3.1-8B's int4 products, and the rows timed
WEIGHTS = {"wq": (4096, 4096), "wk": (1024, 4096), "w_gate": (14336, 4096),
           "w_down": (4096, 14336), "head": (128256, 4096)}
SHAPES = [("wq", 1), ("wk", 1), ("w_gate", 1), ("w_down", 1), ("head", 1),
          ("wq", 16), ("w_down", 16), ("wq", 32), ("w_down", 32)]
L2_MISS_BYTES = 200 * 2**20      # packed bytes a cycled run spans


def splits_tried(R: int, in_dim: int, out_dim: int, G: int) -> list:
    """Groups per split to time: :func:`k8_split`'s, half it and twice it,
    each within 1 and the most the kernel takes (all G, and no more than x's
    budget holds)."""
    split = k8_split(R, in_dim, out_dim, G)
    cap = min(G, K8_X_BYTES // (R * in_dim // G * 2))
    return sorted({max(1, split // 2), split, min(cap, split * 2)})


def main(rounds: int = 3) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    weights = {}
    for name, (out_dim, in_dim) in WEIGHTS.items():
        copies = max(1, -(-L2_MISS_BYTES // (out_dim * in_dim // 2)))
        weights[name] = [quantize_tensor_q4(torch.randn(
            (out_dim, in_dim), generator=gen, device="cuda") / in_dim ** 0.5)
            for _ in range(copies)]
    result = {}
    for name, R in SHAPES:
        ws = weights[name]
        G, out_dim, half = ws[0].packed.shape
        x = torch.randn((R, 2 * G * half), generator=gen, device="cuda").to(torch.bfloat16)
        split = k8_split(R, x.shape[1], out_dim, G)
        splits = splits_tried(R, x.shape[1], out_dim, G)
        ms = {sp: [] for sp in splits}
        for _ in range(rounds):
            for sp in splits:
                ms[sp].append(cycled_ms(lambda li, sp=sp: q4_matmul(
                    x, ws[li % len(ws)].packed, ws[li % len(ws)].scale, sp), len(ws)))
        result[f"{name} R={R}"] = dict(G=G, k8_split=split, ms=ms)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return dict(shapes=result, card=smi.stdout.strip())


if __name__ == "__main__":
    print(json.dumps(main()))
