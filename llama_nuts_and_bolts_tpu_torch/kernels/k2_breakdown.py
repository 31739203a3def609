"""Where K2's time goes: the decode kernel timed beside two stripped builds
of its own source, on one card, at request B's first decode step of the
bf16 CLI path (B=1, T=4096, position 3000, Llama-3.1-8B's 8 KV heads; a
32-layer cache cycled, so that every launch reads its bytes from HBM):

  * ``full``: ``csrc/decode_attention.cu`` as it is;
  * ``no_combine``: every active split writes its own output, as a row with
    one active split does: no partials, tickets or combine (the output is
    wrong; only the time is read);
  * ``loads_only``: that, and no scores, softmax or PV: each block only
    streams its split through the ring.

``full - no_combine`` is what the combine costs, ``no_combine - loads_only``
what the products and the softmax add to the loads. Run from the
repository root:

    python -m llama_nuts_and_bolts_tpu_torch.kernels.k2_breakdown

Prints one JSON line: each build's time in ms per round, the bytes bound,
and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Dict

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
    _decode_kernel,
    flash_decode_attention,
)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
SPIN_CYCLES = 100_000_000        # ~50 ms at the H100's boost clock
# (text of csrc/decode_attention.cu, its replacement) per stripped build
_NO_COMBINE = ("  if (n_active == 1) {\n", "  if (true) {\n")
_LOADS_ONLY = ("    issue(i + STAGES - 1);\n", "    issue(i + STAGES - 1);\n    continue;\n")
VARIANTS = {"full": (), "no_combine": (_NO_COMBINE,),
            "loads_only": (_NO_COMBINE, _LOADS_ONLY)}


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Each variant's source written out and compiled, one ``nvcc`` each,
    all started together."""
    out_dir = BUILD_DIR / "k2_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "decode_attention.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old.strip()!r} is not in the source once")
            text = text.replace(old, new)
        cu, so = out_dir / f"k2_{name}.cu", out_dir / f"libk2_{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        output, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} build:\n{output}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def cycled_ms(fn, n_layers: int, iters: int = 64) -> float:
    """Mean device time of ``fn(layer)`` over ``iters`` calls cycling the
    layers, by CUDA events behind a spin kernel (so the host's launch pace
    does not count), as ``chip_smoke.py`` times the kernels."""
    for li in range(2):
        fn(li)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fn(i % n_layers)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(rounds: int = 3) -> dict:
    L, B, H, KV, T, D, pos = 32, 1, 32, 8, 4096, 128, 3000
    gen = torch.Generator(device="cuda").manual_seed(0)
    k, v = (torch.randn((L, B, KV, T, D), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    positions = torch.full((B,), pos, dtype=torch.int32, device="cuda")
    libs = build_variants()

    def call(name):
        return lambda li: _decode_kernel("lnb_flash_decode_attention", q, k, v, (),
                                         positions, li, lib=libs[name])

    if not torch.equal(call("full")(0), flash_decode_attention(q, k, v, positions, layer=0)):
        raise RuntimeError("the full build differs from the package's K2")
    times = {name: [] for name in VARIANTS}
    for _ in range(rounds):
        for name in VARIANTS:
            times[name].append(cycled_ms(call(name), L))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return dict(shape=f"B={B} L={L} T={T} pos={pos} H={H} KV={KV} D={D} bf16",
                ms=times, bound_ms=2 * 2 * KV * (pos + 1) * D / HBM_BYTES_PER_S * 1e3,
                card=smi.stdout.strip())


if __name__ == "__main__":
    print(json.dumps(main()))
