"""Where K6's time goes: the paged decode kernel timed beside stripped builds
of its own source, on one card, at the three shapes of ``k6_splits`` (the
server smoke's pool: 32 layers of 257 blocks of 32 positions, cycled, so
every launch reads its bytes from HBM), on a bf16 and an int8 pool:

  * ``full``: ``csrc/paged_attention.cu`` as it is;
  * ``no_combine``: every active split writes its own output, as a row with
    one active split does: no partials, tickets or combine;
  * ``loads_only``: that, and no scores, softmax or PV: the consumer warps
    wait for each slot of the ring and release it, so the producer streams
    the split's slices as in the full kernel;
  * ``prologue_only``: every block leaves once it has read its position:
    the launch and that first round trip.

The stripped builds' outputs are wrong; only their times are read.
``full - no_combine`` is what the combine costs, ``no_combine -
loads_only`` what the products and the softmax add to the copies, and
``prologue_only`` the floor under any launch of this grid. Run from the
repository root:

    python -m llama_nuts_and_bolts_tpu_torch.kernels.k6_breakdown

Prints one JSON line: per shape and pool each build's ms per round, the
bytes bound, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
from typing import Dict

import torch

from llama_nuts_and_bolts_tpu_torch.kernels import paged_attention as pa
from llama_nuts_and_bolts_tpu_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc
from llama_nuts_and_bolts_tpu_torch.kernels.k2_breakdown import cycled_ms
from llama_nuts_and_bolts_tpu_torch.kernels.k6_splits import BS, D, H, KV, L, M, N_BLOCKS, SHAPES
from llama_nuts_and_bolts_tpu_torch.models.llama.model import quantize_kv_rows

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
# (text of csrc/paged_attention.cu, its replacement) per stripped build
_NO_COMBINE = ("  if (n_active == 1) {\n", "  if (true) {\n")
_NO_SCORES = ("      for (int t0 = 0; t0 < bs; t0 += 32) {\n",
              "      for (int t0 = bs; t0 < bs; t0 += 32) {\n")
_NO_SOFTMAX_BF16 = ("      if (warp < G) {\n        const int g = warp;\n",
                    "      if (false) {\n        const int g = warp;\n")
_NO_SOFTMAX_INT8 = ("      {\n        const int g = g8, jp = kh;\n",
                    "      if (false) {\n        const int g = g8, jp = kh;\n")
_NO_PV_BF16 = ("        for (int t = kq * (bs / 4); t < t1; ++t) {\n",
               "        for (int t = t1; t < t1; ++t) {\n")
_NO_PV_INT8 = ("          for (int kg = kh * half; kg < (kh + 1) * half && 4 * kg < nv; ++kg) {\n",
               "          for (int kg = (kh + 1) * half; kg < (kh + 1) * half; ++kg) {\n")
_PROLOGUE = ("  if (s >= n_active) return;\n", "  if (s >= n_active - (1 << 30)) return;\n")
VARIANTS = {"full": (), "no_combine": (_NO_COMBINE,),
            "loads_only": (_NO_COMBINE, _NO_SCORES, _NO_SOFTMAX_BF16, _NO_SOFTMAX_INT8,
                           _NO_PV_BF16, _NO_PV_INT8),
            "prologue_only": (_PROLOGUE,)}


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Each variant's source written out and compiled, one ``nvcc`` each,
    all started together."""
    out_dir = BUILD_DIR / "k6_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "paged_attention.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old.strip()!r} is not in the source once")
            text = text.replace(old, new)
        cu, so = out_dir / f"k6_{name}.cu", out_dir / f"libk6_{name}.so"
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


def main(rounds: int = 3) -> dict:
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (L, N_BLOCKS, KV, BS, D)
    k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    (k8, ks), (v8, vs) = (quantize_kv_rows(torch.randn(shape, generator=gen, device="cuda"))
                          for _ in range(2))
    pools = {"bf16": (k, v), "int8": (k8, v8, ks, vs)}
    perm = torch.randperm(N_BLOCKS - 1, generator=torch.Generator().manual_seed(11)) + 1
    result = {}
    for name, positions in SHAPES.items():
        B = len(positions)
        tables = perm[:B * M].reshape(B, M).to(torch.int32).cuda()
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        for kind, pool in pools.items():
            entry = "lnb_paged_decode_int8" if kind == "int8" else "lnb_paged_decode"
            chunk = None if kind == "int8" else pa.paged_chunk(M, BS)

            def call(variant, pool=pool, entry=entry, chunk=chunk):
                return lambda li: pa._launch(entry, q, pool, tables, pos, li, chunk,
                                             1.0 / math.sqrt(D), None, lib=libs[variant])

            want = pa.paged_flash_decode(q, *pool[:2], tables, pos, layer=0,
                                         **(dict(pool_ks=ks, pool_vs=vs) if chunk is None
                                            else {}))
            if not torch.equal(call("full")(0), want):
                raise RuntimeError("the full build differs from the package's K6")
            ms = {variant: [] for variant in VARIANTS}
            for _ in range(rounds):
                for variant in VARIANTS:
                    ms[variant].append(cycled_ms(call(variant), L))
            rows = sum(p + 1 for p in positions)
            per_row = KV * (2 * D + 4) if kind == "int8" else KV * D * 4
            result[f"{name} {kind}"] = dict(
                ms=ms, bound_ms=(rows * per_row + 4 * B * H * D) / HBM_BYTES_PER_S * 1e3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return dict(shapes=result, card=smi.stdout.strip())


if __name__ == "__main__":
    print(json.dumps(main()))
