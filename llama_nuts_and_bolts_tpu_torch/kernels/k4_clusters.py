"""K4's cluster rule read on one card: the int8-dot decode kernel timed at
:func:`k4_cluster`'s size, at half and twice it and at the largest size the
rule may pick (8), at the two shapes of the
int4 + int8-KV CLI path (Llama-3.1-8B's 8 KV heads, the JAX tile): request
A's decode (B=1, T=256, position 103, one 256-key tile) and request B's
(B=1, T=4096, position 3000, two 2048-key tiles). The int8 caches are
random, as many layers of each as keep a cycled run's bytes outside the 50
MB L2; every size of a shape is timed in the same rounds, so they compare
within one call. Beside each size, how many of its clusters the card holds
at once (``cudaOccupancyMaxActiveClusters``; a cluster of 16 must sit in one
GPC). Run from the repository root:

    python -m llama_nuts_and_bolts_tpu_torch.kernels.k4_clusters [--parent DIR]

``--parent DIR`` also builds ``csrc/decode_attention_int8.cu`` of another
checkout of the repository (one whose K4 entry point takes no cluster: the
one-block-per-head kernel) and times it in the same rounds, in the order
parent, this kernel, this kernel, parent, after checking it against the plain
version. Prints one JSON line: per shape the chosen size and the ms per round
of each size (and of the parent), and the card's name and power limit.
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
    library,
    nvcc,
)
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
    K4_MAX_CLUSTER,
    decode_block_k,
    flash_decode_attention_int8_mxu,
    flash_decode_attention_int8_mxu_plain,
    k4_cluster,
    k4_cluster_takes,
)
from llama_nuts_and_bolts_tpu_torch.kernels.k2_breakdown import cycled_ms
from llama_nuts_and_bolts_tpu_torch.ops import quantize_kv_rows

H, KV, D = 32, 8, 128
SHAPES = {"A": (256, 103), "B": (4096, 3000)}     # (T, position), B = 1
L2_MISS_BYTES = 200 * 2**20                      # cache bytes a cycled run spans


def clusters_tried(B: int, T: int) -> list:
    """Cluster sizes to time: :func:`k4_cluster`'s, half it and twice it,
    and the largest the rule may pick, each one the kernel can cut the tile
    over (twice may be 16)."""
    bk = decode_block_k(T, KV, D, True)
    C = k4_cluster(B, KV, T, bk)
    return sorted({c for c in (max(1, C // 2), C, 2 * C, K4_MAX_CLUSTER)
                   if k4_cluster_takes(bk, c)})


def max_active_clusters(T: int, cluster: int) -> int:
    bk = decode_block_k(T, KV, D, True)
    fn = library("decode_attention_int8").lnb_k4_max_active_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    n = ctypes.c_int(0)
    check_launch(fn(T, bk, cluster, ctypes.byref(n)), "cudaOccupancyMaxActiveClusters")
    return n.value


def parent_kernel(checkout: Path):
    """K4 built from another checkout's source, called through its entry
    point without a cluster argument (the parent's C interface)."""
    out_dir = BUILD_DIR / "k4_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libk4_parent.so"
    src = checkout / "llama_nuts_and_bolts_tpu_torch" / "csrc" / "decode_attention_int8.cu"
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the parent's K4:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(so)).lnb_flash_decode_int8_mxu
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                               ctypes.c_void_p]

    def call(q, k, v, ks, vs, pos, layer, bk):
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                 pos.data_ptr(), out.data_ptr(), q.shape[0], H, KV, k.shape[3], layer, bk,
                 1.0 / math.sqrt(D), cuda_stream(q.device))
        check_launch(err, "parent K4")
        return out
    return call


def main(rounds: int = 3, parent: Optional[Path] = None) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    old = parent_kernel(parent) if parent is not None else None
    result = {}
    for name, (T, p) in SHAPES.items():
        bk = decode_block_k(T, KV, D, True)
        L = max(1, -(-L2_MISS_BYTES // (2 * KV * T * (D + 2))))
        k, ks = quantize_kv_rows(torch.randn((L, 1, KV, T, D), generator=gen, device="cuda"))
        v, vs = quantize_kv_rows(torch.randn((L, 1, KV, T, D), generator=gen, device="cuda"))
        q = torch.randn((1, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        pos = torch.tensor([p], dtype=torch.int32, device="cuda")
        ref = flash_decode_attention_int8_mxu_plain(q, k, v, ks, vs, pos, 0, bk)
        sizes = clusters_tried(1, T)
        calls = {f"C={c}": (lambda li, c=c: flash_decode_attention_int8_mxu(
            q, k, v, ks, vs, pos, li, bk, c)) for c in sizes}
        rel = {}
        if old is not None:
            calls["parent"] = lambda li: old(q, k, v, ks, vs, pos, li, bk)
        for key, fn in calls.items():
            got = fn(0).float()
            rel[key] = float((got - ref.float()).norm() / ref.float().norm())
        order = [k for k in calls if k != "parent"]
        order = (["parent"] + order + order[::-1] + ["parent"]) if old else order
        ms = {key: [] for key in calls}
        for _ in range(rounds):
            for key in order:
                ms[key].append(cycled_ms(calls[key], L))
        result[name] = dict(T=T, position=p, block_k=bk, layers_cycled=L,
                            k4_cluster=k4_cluster(1, KV, T, bk), ms=ms, rel_l2=rel,
                            max_active_clusters={c: max_active_clusters(T, c)
                                                 for c in sizes})
        del k, v, ks, vs
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return dict(shapes=result, max_cluster_picked=K4_MAX_CLUSTER, card=smi.stdout.strip())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose K4 is timed beside this one")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    print(json.dumps(main(args.rounds, args.parent)))
