"""K6's split rule read on one card: the paged decode kernel timed at
:func:`paged_split`'s entries per split and at half and twice that, on a
bf16 and an int8 pool, at three shapes of the server path (Llama-3.1-8B's 8
KV heads, pool blocks of 32 positions, a 2048-token context: M = 64 table
entries): B = 4 at position 114 (the server smoke's batched step), B = 4
with every row at 2047 (a full context), and B = 1 at 1850 (the smoke's long
chat). The pools hold 32 layers of 257 blocks, as the server's do, and each
row's table is a slice of one seeded permutation of them; the layers are
cycled, so every launch reads its bytes from HBM. Every split of a shape is
timed in the same rounds, so they compare within one call. Run from the
repository root:

    python -m llama_nuts_and_bolts_tpu_torch.kernels.k6_splits [--parent DIR]

``--parent DIR`` also builds ``csrc/paged_attention.cu`` of another
checkout of the repository (one whose K6 entry points take no split or
workspace: the one-block-per-(head, row) kernel) and times it in the same
rounds, in the order parent, this kernel's splits, again in reverse, parent,
after checking it against the plain version. Prints one JSON line: per
shape and pool the rule's split and the ms per round at each split tried
(and of the parent), each output's relative L2 from the plain version, and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
from pathlib import Path
from typing import Optional

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.build import (
    BUILD_DIR,
    NVCC_FLAGS,
    check_launch,
    cuda_stream,
    nvcc,
)
from llama_nuts_and_bolts_tpu_torch.kernels.k2_breakdown import cycled_ms
from llama_nuts_and_bolts_tpu_torch.kernels.paged_attention import (
    paged_chunk,
    paged_flash_decode,
    paged_flash_decode_int8_plain,
    paged_flash_decode_plain,
    paged_split,
)
from llama_nuts_and_bolts_tpu_torch.ops import quantize_kv_rows

H, KV, D, BS = 32, 8, 128, 32
L, N_BLOCKS, M = 32, 257, 64          # the server smoke's pool: 1 trash + 4 x 64 blocks
SHAPES = {"B=4 pos 114": [114] * 4, "B=4 pos 2047": [2047] * 4, "B=1 pos 1850": [1850]}


def splits_tried(B: int) -> list:
    """Entries per split to time: :func:`paged_split`'s, half it and twice
    it, within 1 and M."""
    split = paged_split(B, KV, M, BS)
    return sorted({max(1, split // 2), split, min(M, 2 * split)})


def parent_kernel(checkout: Path):
    """K6 built from another checkout's source, called through its entry
    points without a split or a workspace (the parent's C interface)."""
    out_dir = BUILD_DIR / "k6_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libk6_parent.so"
    src = checkout / "llama_nuts_and_bolts_tpu_torch" / "csrc" / "paged_attention.cu"
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the parent's K6:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    bf16, int8 = lib.lnb_paged_decode, lib.lnb_paged_decode_int8
    for fn, n_ptr, n_int in ((bf16, 6, 8), (int8, 8, 7)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_float, ctypes.c_void_p]

    def call(q, k, v, scales, tables, pos, layer):
        out = torch.empty_like(q)
        ints = (q.shape[0], H, KV, M, N_BLOCKS, BS)
        if scales:
            err = int8(q.data_ptr(), k.data_ptr(), v.data_ptr(), scales[0].data_ptr(),
                       scales[1].data_ptr(), tables.data_ptr(), pos.data_ptr(),
                       out.data_ptr(), *ints, layer, 1.0 / math.sqrt(D),
                       cuda_stream(q.device))
        else:
            err = bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(),
                       pos.data_ptr(), out.data_ptr(), *ints, paged_chunk(M, BS), layer,
                       1.0 / math.sqrt(D), cuda_stream(q.device))
        check_launch(err, "parent K6")
        return out
    return call


def main(rounds: int = 3, parent: Optional[Path] = None) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    old = parent_kernel(parent) if parent is not None else None
    shape = (L, N_BLOCKS, KV, BS, D)
    pools = {"bf16": (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16),
                      torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16),
                      ())}
    (k8, ks), (v8, vs) = (quantize_kv_rows(torch.randn(shape, generator=gen, device="cuda"))
                          for _ in range(2))
    pools["int8"] = (k8, v8, (ks, vs))
    perm = torch.randperm(N_BLOCKS - 1, generator=torch.Generator().manual_seed(11)) + 1
    result = {}
    for name, positions in SHAPES.items():
        B = len(positions)
        tables = perm[:B * M].reshape(B, M).to(torch.int32).cuda()
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        splits = splits_tried(B)
        for kind, (k, v, scales) in pools.items():
            kw = dict(pool_ks=scales[0], pool_vs=scales[1]) if scales else {}
            calls = {f"split={sp}": (lambda li, sp=sp, k=k, v=v, kw=kw: paged_flash_decode(
                q, k, v, tables, pos, layer=li, split=sp, **kw)) for sp in splits}
            if old is not None:
                calls["parent"] = lambda li, k=k, v=v, scales=scales: old(
                    q, k, v, scales, tables, pos, li)
            rel = {}
            for key, fn in calls.items():
                split = int(key.split("=")[1]) if key != "parent" else None
                ref = (paged_flash_decode_int8_plain(q, k, v, *scales, tables, pos, 0,
                                                     split=split) if scales else
                       paged_flash_decode_plain(q, k, v, tables, pos, 0, paged_chunk(M, BS),
                                                split=split)).float()
                rel[key] = float((fn(0).float() - ref).norm() / ref.norm())
            order = [key for key in calls if key != "parent"]
            order = (["parent"] + order + order[::-1] + ["parent"]) if old else order
            ms = {key: [] for key in calls}
            for _ in range(rounds):
                for key in order:
                    ms[key].append(cycled_ms(calls[key], L))
            result[f"{name} {kind}"] = dict(paged_split=paged_split(B, KV, M, BS), ms=ms,
                                            rel_l2=rel)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return dict(shapes=result, card=smi.stdout.strip())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose K6 is timed beside this one")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    print(json.dumps(main(args.rounds, args.parent)))
