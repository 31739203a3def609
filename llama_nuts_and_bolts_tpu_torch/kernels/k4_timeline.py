"""Where K4's time goes inside one launch: a copy of
``csrc/decode_attention_int8.cu`` with ``clock64()`` stamps at its phase
boundaries, written by thread 0 of every rank of KV head 0's cluster, read
back after a run of launches over a cycled cache. Shapes: request A's decode
step (B=1, T=256, position 103) at :func:`k4_cluster`'s size (1) and at 8,
and request B's (B=1, T=4096, position 3000) at its size (8). Run from the
repository root:

    python -m llama_nuts_and_bolts_tpu_torch.kernels.k4_timeline

Prints one JSON line: per shape and rank the SM cycles from rank 0's first
stamp at each phase boundary (``PHASES``; per tile for the tile phases), the
SM clock nvidia-smi reports, and the card's name and power limit. Stamps of
different ranks come from different SMs' counters, which need not agree.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.build import (
    BUILD_DIR,
    CSRC,
    NVCC_FLAGS,
    check_launch,
    cuda_stream,
    nvcc,
)
from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
    decode_block_k,
    k4_cluster,
)
from llama_nuts_and_bolts_tpu_torch.models.llama.model import quantize_kv_rows

H, KV, D = 32, 8, 128
SLOTS = 32                                   # stamps a rank, in the copy's buffer
_STAMP = "if (tid == 0 && kvh == 0) k4_stamps[rank * 32 + (%s)] = clock64();"
# (text of the kernel, the same text with a stamp before or after it)
EDITS = (
    ("namespace {\n\nconstexpr int D = 128;",
     "__device__ long long k4_stamps[16 * 32];\nnamespace {\n\nconstexpr int D = 128;"),
    ("  int pieces = 0;", "  %s\n  int pieces = 0;" % (_STAMP % "0")),
    ("  // quantize the G query rows", "  %s\n  // quantize the G query rows" % (_STAMP % "1")),
    ("  int4 q_r[4];  ", "  %s\n  int4 q_r[4];  " % (_STAMP % "2")),
    ("      mbar_wait(&full[stage], (consumed / s.stages) & 1);\n      score_piece(",
     "      mbar_wait(&full[stage], (consumed / s.stages) & 1);\n      if (p == 0) %s\n"
     "      score_piece(" % (_STAMP % "3 + kt * 10")),
    ("#pragma unroll\n    for (int off = 4; off < 32; off <<= 1)\n      lmax",
     "    %s\n#pragma unroll\n    for (int off = 4; off < 32; off <<= 1)\n      lmax"
     % (_STAMP % "4 + kt * 10")),
    ("    if (C > 1 && rank == 0 && kt > 0) {",
     "    %s\n    if (C > 1 && rank == 0 && kt > 0) {" % (_STAMP % "5 + kt * 10")),
    ("    // p and p * vs of the warp's keys",
     "    %s\n    // p and p * vs of the warp's keys" % (_STAMP % "6 + kt * 10")),
    ("    float ps[G];\n", "    %s\n    float ps[G];\n" % (_STAMP % "7 + kt * 10")),
    ("    if (nv == 0) continue;", "    %s\n    if (nv == 0) continue;" % (_STAMP % "8 + kt * 10")),
    ("    // PV: warp = 4-key slice", "    %s\n    // PV: warp = 4-key slice"
     % (_STAMP % "9 + kt * 10")),
    ("#pragma unroll\n    for (int g = 0; g < G; ++g)\n#pragma unroll\n      for (int i = 0; "
     "i < 4; ++i) part[",
     "    %s\n#pragma unroll\n    for (int g = 0; g < G; ++g)\n#pragma unroll\n      for (int "
     "i = 0; i < 4; ++i) part[" % (_STAMP % "10 + kt * 10")),
    ("        red_async_add(mapa(tot + o, 0), sum, mapa(&xbar[2], 0));\n    }\n",
     "        red_async_add(mapa(tot + o, 0), sum, mapa(&xbar[2], 0));\n    }\n    %s\n"
     % (_STAMP % "11 + kt * 10")),
    ("  if (C > 1) {\n    // a rank leaving", "  %s\n  if (C > 1) {\n    // a rank leaving"
     % (_STAMP % "29")),
    ("  __nv_bfloat16* oh = out", "  %s\n  __nv_bfloat16* oh = out" % (_STAMP % "30")),
)
# what each stamp marks: before the copies, after them, after q is quantized;
# per tile (kt = 0, 1) the first k piece in, the scores, the maxima
# exchanged, m_new, the sums exchanged, ps and l, p quantized, PV, the sums
# sent; the end of the last tile, the last sum folded (rank 0)
PHASES = ["start", "copies issued", "q quantized"] + [
    f"tile {kt}: {name}" for kt in range(2) for name in (
        "k arrived", "scores", "maxima exchanged", "m_new", "sums exchanged", "ps and l",
        "p quantized", "PV", "sums sent", "-")] + ["-"] * 6 + ["tiles done", "last sum folded", "-"]
SHAPES = {"A": (256, 103, None), "A, C=8": (256, 103, 8), "B": (4096, 3000, None)}


def stamped_source() -> str:
    src = (CSRC / "decode_attention_int8.cu").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"{old.strip()[:60]!r} is not in the kernel source once")
        src = src.replace(old, new)
    return src + ('\nextern "C" int lnb_k4_stamps(void* host, int clear) {\n'
                  "  if (clear) return (int)cudaMemcpyToSymbol(k4_stamps, host, sizeof(k4_stamps));\n"
                  "  return (int)cudaMemcpyFromSymbol(host, k4_stamps, sizeof(k4_stamps));\n}\n")


def main(launches: int = 20) -> dict:
    out_dir = BUILD_DIR / "k4_timeline"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "k4_timeline.cu", out_dir / "libk4_timeline.so"
    cu.write_text(stamped_source())
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the stamped K4:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.lnb_flash_decode_int8_mxu
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for name, (T, p, forced) in SHAPES.items():
        bk = decode_block_k(T, KV, D, True)
        C = forced or k4_cluster(1, KV, T, bk)
        L = max(1, -(-200 * 2**20 // (2 * KV * T * (D + 2))))
        k, ks = quantize_kv_rows(torch.randn((L, 1, KV, T, D), generator=gen, device="cuda"))
        v, vs = quantize_kv_rows(torch.randn((L, 1, KV, T, D), generator=gen, device="cuda"))
        q = torch.randn((1, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        pos = torch.tensor([p], dtype=torch.int32, device="cuda")
        out = torch.empty_like(q)
        buf = (ctypes.c_longlong * (16 * SLOTS))()
        check_launch(lib.lnb_k4_stamps(buf, 1), "cudaMemcpyToSymbol")   # zeros
        for li in range(launches):               # the last launch's stamps are read
            check_launch(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
                            vs.data_ptr(), pos.data_ptr(), out.data_ptr(), 1, H, KV, T,
                            li % L, bk, C, 1.0 / math.sqrt(D), cuda_stream(q.device)),
                         "stamped K4")
        torch.cuda.synchronize()
        check_launch(lib.lnb_k4_stamps(buf, 0), "cudaMemcpyFromSymbol")
        base = buf[0]
        result[name] = dict(T=T, position=p, cluster=C, ranks={
            r: {PHASES[i]: buf[r * SLOTS + i] - base for i in range(SLOTS)
                if buf[r * SLOTS + i] and PHASES[i] != "-"} for r in sorted({0, C - 1})})
        del k, v, ks, vs
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return dict(shapes=result, card=smi.stdout.strip())


if __name__ == "__main__":
    print(json.dumps(main()))
