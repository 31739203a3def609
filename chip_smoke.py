"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the CUDA kernels from ``llama_nuts_and_bolts_tpu_torch/csrc``, holds
each against its plain PyTorch version at Llama-3.1-8B widths and at the
main paths' own shapes, checks the forward pass with the kernels against the
plain path on 2-layer full-width models, and drives the two main paths --
greedy streaming chat through ``InferenceEngine.generate_string`` on the
full 32-layer 8B architecture with seeded random weights: bf16 weights with
a bf16 KV cache (K1, K2), then int4 weights with an int8 KV cache (K8, K4),
with a last request on int8 weights -- and times the kernels. Every limit is
also read against planted faults, which must fail it. Any failed check
exits non-zero.

Run from the repository root: ``python3 chip_smoke.py``. The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it is
the kernel table as JSON, and before that the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores, published
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor cores, published
# Kernel vs its plain version. Both round the same fp32 function to bf16,
# and summation order moves a rounding by at most one ulp, 2^-7 |x|: so per
# element |kernel - plain| <= KERNEL_ATOL + 2^-7 |plain|, and over the whole
# output a relative L2 error <= KERNEL_REL_L2. Every run also reads planted
# faults (a causal mask off by one, a skipped key tile) against the same
# limits, and fails if one of them passes. On an H100 the sound kernels read
# at most 1.6e-4 relative L2, the nearest planted fault 3.6e-3 (PERF.md).
KERNEL_ATOL, KERNEL_RTOL, KERNEL_REL_L2 = 1e-3, 2.0 ** -7, 1e-3
# Flash vs plain logits of the whole forward, relative L2 per logits row.
# The two paths round p at different places (the plain path normalises p
# before rounding it, the kernels after), and random layers amplify that
# with depth. Each limit sits between the sound reading and the nearest
# planted fault's on an H100 (2 layers: 1.1e-2 and 9.3e-2; 32 layers:
# 3.7e-2 and 0.52; PERF.md), and every run reads both again.
LOGITS_REL_L2 = 3e-2             # 2 layers
DEEP_REL_L2 = 0.1                # 32 layers
# K8's fp32 output against its plain version's: the same exact products
# (bf16 x times integer weights) summed in another order, so only fp32
# rounding, ~1e-7 of the output's scale; a dropped group's scale moves a
# 16-group output by ~1/4 of its norm.
K8_ATOL, K8_RTOL, K8_REL_L2 = 1e-4, 1e-5, 1e-5
# Int4 weights and an int8 cache, kernels (K8, K4's int8 dots) vs the plain
# path (dequantized weights, dequantized attention), relative L2 per logits
# row on 2 layers. K4 quantizes q and p to int8 where the plain path keeps
# them in fp32. On these random int4 weights attention moves the logits
# little: on an H100 the sound path reads at most 6.9e-4, K4 skipping its
# only tile (attention zeroed) 5.8e-3, K8 dropping a group 7.2e-2; the limit
# sits between the first two (PERF.md), and every run reads all three again.
QUANT_LOGITS_REL_L2 = 2e-3
# torch._weight_int4pack_mm, K8's library counterpart, against K8's plain
# version: its bf16 output is one rounding (2^-9 relative on average) away
# from K8's fp32 one; a weight packed in the wrong order reads ~1.4.
TINYGEMM_REL_L2 = 1e-2
SPIN_CYCLES = 100_000_000        # ~50 ms at the H100's 1.98 GHz boost clock

T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:8.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


FAILED = []


def check_failed(msg: str) -> None:
    """A check that failed: the run goes on to read the other numbers, and
    exits non-zero at the end."""
    log(f"CHECK FAILED: {msg}")
    FAILED.append(msg)


def cuda_ms(fn, iters: int, warmup: int = 2):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events, and
    the last call's result. A spin kernel (~50 ms) runs ahead of the first
    event, so the host queues every launch before the card reaches them and
    a wrapper's host cost between launches does not count as device time
    (a kernel of ~20 us is shorter than its wrapper's Python); a function
    that synchronises inside (the plain versions read positions back) is
    timed with its host work, and the log says so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    if start.query():
        log(f"  (timing of {iters} calls includes host time: the card reached "
            f"the first event before the last launch was queued)")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def kernel_err(got: torch.Tensor, ref: torch.Tensor, what: str,
               planted: bool = False, limits=(KERNEL_ATOL, KERNEL_RTOL, KERNEL_REL_L2),
               judged: bool = True) -> float:
    """``got`` against the plain version's ``ref`` at the kernel tolerance
    (``limits`` = per-element atol and rtol, relative L2); returns the
    max-abs error. A sound kernel must pass; a planted fault must fail.
    ``judged=False`` only reads the numbers."""
    atol, rtol, rel_limit = limits
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    worst = float(err.max())
    excess = float((err - (atol + rtol * ref.abs())).max())
    rel = rel_l2(got, ref)
    ok = bool(torch.isfinite(got).all()) and excess <= 0 and rel <= rel_limit
    log(f"{'planted fault, ' if planted else ''}{what}: max_abs_err={worst:.3e}, "
        f"relative L2 {rel:.3e} (limits {atol} + {rtol:.3g}*|ref| per element, "
        f"{rel_limit} relative L2): {'passes' if ok else 'fails'}")
    if judged and ok == planted:
        check_failed(f"{what}: " + ("the planted fault passes the kernel limits"
                                    if planted else "outside the kernel limits"))
    return worst


def logits_err(got: torch.Tensor, ref: torch.Tensor, limit: float, what: str,
               planted: bool = False) -> float:
    """Relative L2 error of ``got`` logits against the plain path's; a sound
    path must be within ``limit``, a planted fault outside it."""
    rel = rel_l2(got, ref)
    ok = bool(torch.isfinite(got).all()) and rel <= limit
    log(f"{'planted fault, ' if planted else ''}{what}: relative L2 {rel:.3e} "
        f"(limit {limit}), max_abs_err {float((got - ref).abs().max()):.3e}: "
        f"{'passes' if ok else 'fails'}")
    if ok == planted:
        check_failed(f"{what}: " + ("the planted fault passes the logits limit"
                                    if planted else "outside the logits limit"))
    return rel


# ---------------------------------------------------------------- phase 1

def setup():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    from llama_nuts_and_bolts_tpu_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    for src, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"ptxas {src}: {line.strip()}")
    log(f"kernel build: {time.perf_counter() - t0:.1f}s "
        f"({', '.join(build.SOURCES)})")
    return name, smi


# ---------------------------------------------------------------- phase 2

H, KV, D = 32, 8, 128            # Llama-3.1-8B attention widths


def randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def k1_work(S, T, start_pos, B=1):
    n_keys = sum(min(T, start_pos + s + 1) for s in range(S))
    nbytes = 2 * B * S * H * D * 2 + 2 * B * KV * min(T, start_pos + S) * D * 2
    return nbytes, 4.0 * B * H * D * n_keys


def k2_work(positions, T):
    vis = sum(min(p + 1, T) for p in positions)
    B = len(positions)
    return 2 * B * H * D * 2 + 2 * KV * vis * D * 2, 4.0 * H * D * vis


def k1_mask_off_by_one(q, k, v, start_pos):
    """Planted fault: K1 with its causal mask off by one, so row s sees
    t < start_pos + s (a first row with nothing left to see keeps its own
    slot). Built from the sound kernel on shifted inputs."""
    from llama_nuts_and_bolts_tpu_torch.kernels.attention import flash_gqa_attention

    if start_pos > 0:
        return flash_gqa_attention(q, k, v, start_pos - 1)
    out = flash_gqa_attention(q, k, v, 0)
    out[:, 1:] = flash_gqa_attention(q[:, 1:].contiguous(), k, v, 0)
    return out


def k2_mask_off_by_one(q, k, v, start_pos, layer=None, **kw):
    """Planted fault: the decode kernel (K2, or K3/K4 with an int8 cache's
    keywords) with its mask off by one, so row b sees t < start_pos[b]."""
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        flash_decode_attention)

    return flash_decode_attention(q, k, v, start_pos - 1, layer=layer, **kw)


def k4_last_tile_skipped(q, k, v, start_pos, layer=None, **kw):
    """Planted fault: K4 (or K3) skipping the row's last key tile of the
    int8-dot mode's tile size."""
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        decode_block_k, flash_decode_attention)

    bk = decode_block_k(k.shape[3], k.shape[2], k.shape[4], k.dtype == torch.int8)
    return flash_decode_attention(q, k, v, start_pos // bk * bk - 1, layer=layer, **kw)


def k8_group_dropped(x, packed, scale):
    """Planted fault: K8 with one group's scale dropped (its partial lost)."""
    from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import q4_matmul

    scale = scale.clone()
    scale[scale.shape[0] // 2] = 0
    return q4_matmul(x, packed, scale)


def tinygemm_pack(w):
    """One layer's ``Q4Tensor`` in the layout of ``torch._weight_int4pack_mm``
    (the library's grouped int4 x bf16 product, which takes each weight as
    ``(q - 8) * scale + zero``): the +8-offset nibbles in ``[out, in]`` order,
    two to a byte with the even element high, repacked by
    ``_convert_weight_to_int4pack``, and ``[G, out, 2]`` scales with zero 0.
    Returns the arguments after ``x``: that call computes K8's function."""
    from llama_nuts_and_bolts_tpu_torch.quant.int4 import unpack_nibbles

    G, out_dim, half = w.packed.shape
    q = (unpack_nibbles(w.packed) + 8).permute(1, 0, 2).reshape(out_dim, G * 2 * half)
    q8 = ((q[:, 0::2] << 4) | q[:, 1::2]).to(torch.uint8).contiguous()
    scale_zero = torch.stack([w.scale, torch.zeros_like(w.scale)], dim=-1).contiguous()
    return torch._convert_weight_to_int4pack(q8, 8), 2 * half, scale_zero


def group_dropped_params(params):
    """Planted fault for K8 over a whole forward: every int4 weight's middle
    group scale zeroed, what K8 computes if it drops that group's partial."""
    def drop(w):
        if not hasattr(w, "packed"):
            return w
        scale = w.scale.clone()
        scale[..., scale.shape[-2] // 2, :] = 0
        return type(w)(packed=w.packed, scale=scale)

    return dataclasses.replace(params, output=drop(params.output),
                               layers={k: drop(w) for k, w in params.layers.items()})


def counters():
    """Every kernel's wrapper, whose ``launches`` counts its kernel."""
    from llama_nuts_and_bolts_tpu_torch.kernels.attention import flash_gqa_attention
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        flash_decode_attention, flash_decode_attention_int8_mxu,
        flash_decode_attention_q8)
    from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import q4_matmul

    return {"K1": flash_gqa_attention, "K2": flash_decode_attention,
            "K3": flash_decode_attention_q8, "K4": flash_decode_attention_int8_mxu,
            "K8": q4_matmul}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def check_kernels():
    """Each kernel against its plain version at 8B attention widths: K1 with
    and without history and with a ragged q edge, K2 over a range of
    positions, per-row positions and a stacked cache; request A's shapes."""
    from llama_nuts_and_bolts_tpu_torch.kernels.attention import (
        flash_gqa_attention, flash_gqa_attention_plain)
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        flash_decode_attention, flash_decode_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"K1": 0.0, "K2": 0.0}
    for S, start, T in ((512, 0, 2048), (333, 700, 2048), (128, 0, 256)):
        q = randn((1, S, H, D), gen)
        k, v = randn((1, KV, T, D), gen), randn((1, KV, T, D), gen)
        got = flash_gqa_attention(q, k, v, start)
        torch.cuda.synchronize()
        ref = flash_gqa_attention_plain(q, k, v, start)
        what = f"K1 S={S} start_pos={start} T={T}"
        errs["K1"] = max(errs["K1"], kernel_err(got, ref, what))
        if start:
            kernel_err(k1_mask_off_by_one(q, k, v, start), ref,
                       what + ", mask off by one", planted=True)

    cases = [(1, 1, 0, 8192, [p]) for p in (0, 511, 512, 4095, 8191)]
    cases += [(4, 1, 0, 2048, [3, 700, 2047, 1000]), (2, 4, 2, 1024, [130, 1023]),
              (1, 1, 0, 256, [70]), (1, 1, 0, 256, [134])]
    for B, L, layer, T, positions in cases:
        k, v = randn((L, B, KV, T, D), gen), randn((L, B, KV, T, D), gen)
        q = randn((B, 1, H, D), gen)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        got = flash_decode_attention(q, k, v, pos, layer=layer)
        torch.cuda.synchronize()
        ref = flash_decode_attention_plain(q, k, v, pos, layer)
        errs["K2"] = max(errs["K2"], kernel_err(
            got, ref, f"K2 B={B} L={L} layer={layer} T={T} pos={positions}"))
    return errs


def int8_cache(shape, gen):
    """A random int8 cache written as the model writes it: rows quantized
    per (position, head), bf16 scales."""
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import quantize_kv_rows

    return quantize_kv_rows(torch.randn(shape, generator=gen, device="cuda"))


def k3_call(q, k, v, ks, vs, pos, layer):
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        flash_decode_attention)

    return flash_decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs, layer=layer)


def k4_call(q, k, v, ks, vs, pos, layer, block_k=None):
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        flash_decode_attention)

    return flash_decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs, layer=layer,
                                  fold_heads=True, int8_mxu=True, block_k=block_k)


def check_quant_kernels():
    """K3, K4 and K8 against their plain versions at 8B widths: K3 and K4's
    int8-dot mode (at the JAX tile) over a range of positions, per-row
    positions and a stacked cache; K4's bf16 and int8-dequantizing modes,
    which launch the K2 and K3 kernels; K8 at the 8B projection shapes for
    R = 1, 16, 32."""
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        decode_block_k, flash_decode_attention, flash_decode_attention_int8_mxu_plain,
        flash_decode_attention_plain)
    from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import (
        q4_matmul, q4_matmul_plain)
    from llama_nuts_and_bolts_tpu_torch.quant import quantize_tensor_q4

    gen = torch.Generator(device="cuda").manual_seed(4)
    errs = {"K3": 0.0, "K4": 0.0, "K8": 0.0}
    cases = [(1, 1, 0, 8192, [p]) for p in (0, 511, 2047, 2048, 8191)]
    cases += [(4, 1, 0, 2048, [3, 700, 2047, 1000]), (2, 4, 2, 1024, [130, 1023]),
              (1, 1, 0, 256, [70]), (1, 1, 0, 256, [134])]
    for B, L, layer, T, positions in cases:
        k, ks = int8_cache((L, B, KV, T, D), gen)
        v, vs = int8_cache((L, B, KV, T, D), gen)
        q = randn((B, 1, H, D), gen)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        what = f"B={B} L={L} layer={layer} T={T} pos={positions}"
        got = k3_call(q, k, v, ks, vs, pos, layer)
        torch.cuda.synchronize()
        ref3 = flash_decode_attention_plain(q, k, v, pos, layer, ks, vs)
        errs["K3"] = max(errs["K3"], kernel_err(got, ref3, "K3 " + what))
        bk = decode_block_k(T, KV, D, True)
        got = k4_call(q, k, v, ks, vs, pos, layer)
        torch.cuda.synchronize()
        ref4 = flash_decode_attention_int8_mxu_plain(q, k, v, ks, vs, pos, layer, bk)
        errs["K4"] = max(errs["K4"], kernel_err(got, ref4, f"K4 int8 dots, tile {bk}, "
                                                + what))
    # K4's other two modes compute K2's and K3's functions on their kernels
    before = read_counts()
    got = flash_decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs, layer=layer,
                                 fold_heads=True)
    kernel_err(got, ref3, "K4 int8 dequant mode (K3's kernel) " + what)
    kb, vb = randn(k.shape, gen), randn(v.shape, gen)
    got = flash_decode_attention(q, kb, vb, pos, layer=layer, fold_heads=True)
    torch.cuda.synchronize()
    kernel_err(got, flash_decode_attention_plain(q, kb, vb, pos, layer),
               "K4 bf16 mode (K2's kernel) " + what)
    after = read_counts()
    if (after["K2"] - before["K2"], after["K3"] - before["K3"]) != (1, 1):
        check_failed(f"K4's bf16/dequant modes launched {after} from {before}, "
                     "expected one K2 and one K3 launch")

    for out_dim, in_dim in ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336)):
        w = torch.randn((out_dim, in_dim), generator=gen, device="cuda") / in_dim ** 0.5
        qt = quantize_tensor_q4(w)
        for R in (1, 16, 32):
            x = randn((R, in_dim), gen)
            got = q4_matmul(x, qt.packed, qt.scale)
            torch.cuda.synchronize()
            ref = q4_matmul_plain(x, qt.packed, qt.scale)
            errs["K8"] = max(errs["K8"], kernel_err(
                got, ref, f"K8 R={R} out={out_dim} in={in_dim}",
                limits=(K8_ATOL, K8_RTOL, K8_REL_L2)))
    return errs


def time_kernels(errs, prompt_len_b: int, cache_len_b: int, prefill_len_b: int):
    """Each kernel at the main path's shapes -- request B's prefill (K1) and
    its first decode step (K2, every layer of a 32-layer cache) -- against
    its plain version on the same inputs, with planted faults read against
    the same limits, then timed. K2's timing cycles the layer, so that every
    launch finds its tiles outside the 50 MB L2."""
    import torch.nn.functional as F

    from llama_nuts_and_bolts_tpu_torch.kernels.attention import (
        K1_BLOCK_K, flash_gqa_attention, flash_gqa_attention_plain, k1_geometry)
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        K2_BLOCK_K, flash_decode_attention, flash_decode_attention_plain)

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []

    # K1: S = T = request B's prefill bucket, from position 0
    S = T = prefill_len_b
    q = randn((1, S, H, D), gen)
    k, v = randn((1, KV, T, D), gen), randn((1, KV, T, D), gen)
    ms, got = cuda_ms(lambda: flash_gqa_attention(q, k, v, 0), iters=20)
    plain, ref = cuda_ms(lambda: flash_gqa_attention_plain(q, k, v, 0),
                         iters=1, warmup=1)
    what = f"K1 S=T={S} start_pos=0 (request B's prefill)"
    errs["K1"] = max(errs["K1"], kernel_err(got, ref, what))
    kernel_err(k1_mask_off_by_one(q, k, v, 0), ref, what + ", mask off by one",
               planted=True)
    # the last q tile loses its last key tile (the one on its diagonal)
    p0 = S - k1_geometry(1, S, H, KV, T, 0).block_q
    t_cut = (S - 1) // K1_BLOCK_K * K1_BLOCK_K
    faulty = got.clone()
    faulty[:, p0:] = flash_gqa_attention(
        q[:, p0:].contiguous(), k[:, :, :t_cut].contiguous(),
        v[:, :, :t_cut].contiguous(), p0)
    kernel_err(faulty, ref, what + ", last key tile of the last q tile skipped",
               planted=True)
    del got, ref, faulty
    qt = q.transpose(1, 2)
    lib, _ = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, k, v, is_causal=True, enable_gqa=True), iters=20)
    b_ms, b_by = bound_ms(*k1_work(S, T, 0))
    log(f"K1 S=T={S}: {ms:.4f} ms (plain {plain:.2f}, sdpa {lib:.4f}, "
        f"bound {b_ms:.4f} by {b_by})")
    rows.append(dict(name="flash_gqa_attention (K1)", route="cuda",
                     source="llama_nuts_and_bolts_tpu_torch/csrc/flash_attention.cu",
                     replaces="llama_nuts_and_bolts_tpu/kernels/attention.py:33",
                     max_abs_err=errs["K1"], ms=ms, plain_ms=plain,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                     shape=f"B=1 S=T={S} start_pos=0 H={H} KV={KV} D={D}"))
    del q, k, v, qt

    # K2: request B's first decode step, every layer of a 32-layer cache
    L, T, p = 32, cache_len_b, prompt_len_b
    kc, vc = randn((L, 1, KV, T, D), gen), randn((L, 1, KV, T, D), gen)
    qd = randn((1, 1, H, D), gen)
    pos = torch.tensor([p], dtype=torch.int32, device="cuda")
    got = torch.stack([flash_decode_attention(qd, kc, vc, pos, layer=li)
                       for li in range(L)])
    ref = torch.stack([flash_decode_attention_plain(qd, kc, vc, pos, li)
                       for li in range(L)])
    what = f"K2 B=1 L={L} T={T} pos={p}, every layer (request B's first step)"
    errs["K2"] = max(errs["K2"], kernel_err(got, ref, what))
    kernel_err(k2_mask_off_by_one(qd, kc, vc, pos, 0), ref[0],
               f"K2 T={T} pos={p} layer 0, mask off by one", planted=True)
    kernel_err(flash_decode_attention(qd, kc, vc, pos // K2_BLOCK_K * K2_BLOCK_K - 1,
                                      layer=0), ref[0],
               f"K2 T={T} pos={p} layer 0, last key tile skipped", planted=True)
    del got, ref
    state = {"li": 0}

    def k2_call():
        state["li"] = (state["li"] + 1) % L
        flash_decode_attention(qd, kc, vc, pos, layer=state["li"])

    ms, _ = cuda_ms(k2_call, iters=64)
    plain, _ = cuda_ms(lambda: flash_decode_attention_plain(qd, kc, vc, pos, 1),
                       iters=2, warmup=1)
    vis_k = [kc[li, :, :, :p + 1].contiguous() for li in range(L)]
    vis_v = [vc[li, :, :, :p + 1].contiguous() for li in range(L)]
    qdt = qd.transpose(1, 2)

    def sdpa_call():
        state["li"] = (state["li"] + 1) % L
        F.scaled_dot_product_attention(qdt, vis_k[state["li"]],
                                       vis_v[state["li"]], enable_gqa=True)

    lib, _ = cuda_ms(sdpa_call, iters=64)
    b_ms, b_by = bound_ms(*k2_work([p], T))
    log(f"K2 B=1 T={T} pos={p}: {ms:.4f} ms (plain {plain:.2f}, sdpa "
        f"{lib:.4f}, bound {b_ms:.4f} by {b_by}); grid = {KV} blocks on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    rows.append(dict(name="flash_decode_attention (K2)", route="cuda",
                     source="llama_nuts_and_bolts_tpu_torch/csrc/decode_attention.cu",
                     replaces="llama_nuts_and_bolts_tpu/kernels/decode_attention.py:46",
                     max_abs_err=errs["K2"], ms=ms, plain_ms=plain,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                     shape=f"B=1 L=32 T={T} pos={p} H={H} KV={KV} D={D}"))
    del kc, vc, vis_k, vis_v
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- phase 3/4

def cfg_8b(n_layers: int):
    from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs

    # Meta-Llama-3.1-8B-Instruct params.json, depth cut to n_layers
    return ModelArgs(dim=4096, n_layers=n_layers, n_heads=32, n_kv_heads=8,
                     vocab_size=128256, multiple_of=1024, ffn_dim_multiplier=1.3,
                     norm_eps=1e-5, rope_theta=500000.0, use_scaled_rope=True,
                     max_sequence_length=8192)


def synthetic_tokenizer(seed: int = 0):
    """128,000 ranks like Meta's file: 256 single bytes, all 65,536 byte
    pairs, then 62,208 seeded 3-byte printable pieces; the 256 special ids
    land at 128000..128255 and every id detokenizes."""
    import numpy as np

    from llama_nuts_and_bolts_tpu_torch.tokenizer import TiktokenModel, Vocabulary
    from llama_nuts_and_bolts_tpu_torch.tokenizer.tiktoken_io import (
        build_special_tokens)

    ranks = {bytes([i]): i for i in range(256)}
    for a in range(256):
        for b in range(256):
            ranks[bytes([a, b])] = len(ranks)
    printable = list(range(32, 127))
    n = len(printable)
    picks = np.random.default_rng(seed).choice(n ** 3, 128000 - len(ranks),
                                               replace=False)
    for idx in picks.tolist():
        ranks[bytes([printable[idx // (n * n)], printable[(idx // n) % n],
                     printable[idx % n]])] = len(ranks)
    special = build_special_tokens(len(ranks))
    tk = TiktokenModel(
        mergeable_ranks=ranks, special_tokens=special,
        bos_id=special["<|begin_of_text|>"], eos_id=special["<|end_of_text|>"],
        stop_token_ids=[special["<|eom_id|>"], special["<|eot_id|>"]])
    return tk, Vocabulary.from_tiktoken(tk)


def cyclic_params(params, cycle: int):
    """Constructed-cyclic model: wo and w_down zeroed, so the residual stream
    is the token embedding, and head rows 0..C-1 hold the embeddings of the
    previous cycle element, so greedy output walks 0→1→…→C-1→0. Bf16
    params in either layout."""
    layers = dict(params.layers)
    layers["wo"] = torch.zeros_like(layers["wo"])
    layers["w_down"] = torch.zeros_like(layers["w_down"])
    out = torch.zeros_like(params.output)
    idx = (torch.arange(cycle) - 1) % cycle
    if "wqkv" in layers:                               # fused: [dim, vocab]
        out[:, :cycle] = params.tok_embeddings[idx].t()
    else:
        out[:cycle] = params.tok_embeddings[idx]
    return dataclasses.replace(params, layers=layers, output=out)


@contextlib.contextmanager
def planted_faults(k1=None, k2=None):
    """``forward``'s kernel wrappers swapped for planted faults, for a
    control run; the sound wrappers come back on exit."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import model as mod

    saved = mod.flash_gqa_attention, mod.flash_decode_attention
    mod.flash_gqa_attention = k1 or saved[0]
    mod.flash_decode_attention = k2 or saved[1]
    try:
        yield
    finally:
        mod.flash_gqa_attention, mod.flash_decode_attention = saved


def dequantized(params):
    """``params`` with every int4 leaf dequantized to bf16 once, a layer at
    a time (``unpack_q4``): the plain side of a comparison, whose products
    are the plain path's ``unpack_q4`` and a dense product."""
    from llama_nuts_and_bolts_tpu_torch.quant import unpack_q4

    def dense(w):
        if not hasattr(w, "packed"):
            return w
        if w.packed.dim() == 3:
            return unpack_q4(w)
        return torch.stack([unpack_q4(w[li]) for li in range(w.packed.shape[0])])

    return dataclasses.replace(params, output=dense(params.output),
                               layers={k: dense(w) for k, w in params.layers.items()})


def check_model_path(tk, vocab):
    from llama_nuts_and_bolts_tpu_torch.models.llama import (
        KVCache, LoadedModel, forward, init_random_params)
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    cfg = cfg_8b(2)
    params = init_random_params(cfg, seed=2, device="cuda", fused=True)
    tokens = torch.randint(0, 128000, (1, 100), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))

    # the plain path: a prefill of 100 tokens, then 4 greedy decode steps
    cache = KVCache.create(cfg, 1, 256, device="cuda")
    plain = [forward(params, cfg, tokens, 0, cache, attn_impl="plain",
                     logits_at=99)[0]]
    feed = []
    for step in range(4):
        feed.append(torch.tensor([[int(torch.argmax(plain[-1][0, -1]))]],
                                 dtype=torch.int32, device="cuda"))
        plain.append(forward(params, cfg, feed[-1], 100 + step, cache,
                             attn_impl="plain")[0])

    def flash_run(**faults):
        """The same calls with the kernels, fed the plain path's tokens."""
        cache = KVCache.create(cfg, 1, 256, device="cuda")
        with planted_faults(**faults):
            out = [forward(params, cfg, tokens, 0, cache, attn_impl="flash",
                           logits_at=99)[0]]
            for step, tok in enumerate(feed):
                out.append(forward(params, cfg, tok, 100 + step, cache,
                                   attn_impl="flash")[0])
        return out

    names = ["2-layer 8B-width prefill logits"] + [
        f"2-layer decode step {step} logits" for step in range(4)]
    for got, ref, what in zip(flash_run(), plain, names):
        logits_err(got, ref, LOGITS_REL_L2, what)
    got = flash_run(k1=k1_mask_off_by_one)[0]
    logits_err(got, plain[0], LOGITS_REL_L2, names[0] + ", K1 mask off by one",
               planted=True)
    for got, ref, what in list(zip(flash_run(k2=k2_mask_off_by_one), plain,
                                   names))[1:]:
        logits_err(got, ref, LOGITS_REL_L2, what + ", K2 mask off by one",
                   planted=True)
    del cache

    cycle = 8
    model = LoadedModel(params=cyclic_params(params, cycle), cfg=cfg, vocab=vocab,
                        mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    streams = {}
    for impl in ("plain", "flash"):
        eng = InferenceEngine(model, InferenceArgs(sequence_length=512,
                                                   attn_impl=impl), device="cuda")
        streams[impl] = [t for _, t in eng.generate_tokens(
            list(range(cycle)) * 3, max_new_tokens=32)]
    expect = [i % cycle for i in range(32)]
    if streams["plain"] != expect or streams["flash"] != expect:
        fail(f"cyclic model tokens differ: plain {streams['plain']}, flash "
             f"{streams['flash']}, expected {expect}")
    log("cyclic 2-layer model: 32 greedy tokens equal (plain, flash, expected)")
    del params, model
    torch.cuda.empty_cache()


def check_quant_model_path(tk, vocab):
    """A 2-layer full-width model with int4 weights and an int8 cache: the
    kernels (K8 for every product of at most 32 rows, K4's int8 dots to
    decode) against the plain path (dequantized weights, dequantized
    attention) over a 32-token prefill (bucket 32: K8 at R = 32) and 4
    decode steps, with planted faults read against the same limit; then
    greedy tokens of the cyclic model on both paths."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import (
        KVCache, LoadedModel, forward, init_random_params)
    from llama_nuts_and_bolts_tpu_torch.quant import (
        init_random_params_q4, quantize_params_q4)
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    cfg = cfg_8b(2)
    params = init_random_params_q4(cfg, seed=2, device="cuda")
    S = 32
    tokens = torch.randint(0, 128000, (1, S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))

    def new_cache():
        return KVCache.create(cfg, 1, 256, device="cuda", dtype=torch.int8)

    dense = dequantized(params)      # the plain path, feeding its greedy tokens
    cache = new_cache()
    plain = [forward(dense, cfg, tokens, 0, cache, attn_impl="plain",
                     logits_at=S - 1)[0]]
    feed = []
    for step in range(4):
        feed.append(torch.tensor([[int(torch.argmax(plain[-1][0, -1]))]],
                                 dtype=torch.int32, device="cuda"))
        plain.append(forward(dense, cfg, feed[-1], S + step, cache,
                             attn_impl="plain")[0])
    del dense

    def kernel_run(weights=params, **faults):
        """The same calls with the kernels (an int8 cache prefills on the
        plain attention path; its products still take K8)."""
        cache = new_cache()
        with planted_faults(**faults):
            out = [forward(weights, cfg, tokens, 0, cache, attn_impl="plain",
                           logits_at=S - 1)[0]]
            for step, tok in enumerate(feed):
                out.append(forward(weights, cfg, tok, S + step, cache,
                                   attn_impl="flash")[0])
        return out

    names = [f"2-layer int4/int8-KV prefill (S={S}) logits"] + [
        f"2-layer int4/int8-KV decode step {step} logits" for step in range(4)]
    reset_counts()
    sound = kernel_run()
    counts = read_counts()
    per_pass = 7 * cfg.n_layers + 1
    if (counts["K8"], counts["K4"]) != (5 * per_pass, 4 * cfg.n_layers):
        check_failed(f"2-layer int4/int8-KV run launched {counts}, expected K8 "
                     f"{5 * per_pass} and K4 {4 * cfg.n_layers}")
    for got, ref, what in zip(sound, plain, names):
        logits_err(got, ref, QUANT_LOGITS_REL_L2, what)
    # K4's mask off by one drops one key of ~33: below what these logits
    # resolve (read, not judged; the kernel checks judge it)
    for got, ref, what in list(zip(kernel_run(k2=k2_mask_off_by_one), plain,
                                   names))[1:]:
        log(f"planted fault, {what}, K4 mask off by one (read, not judged): "
            f"relative L2 {rel_l2(got, ref):.3e}")
    for got, ref, what in list(zip(kernel_run(k2=k4_last_tile_skipped), plain,
                                   names))[1:]:
        logits_err(got, ref, QUANT_LOGITS_REL_L2, what + ", K4 last tile skipped",
                   planted=True)
    for got, ref, what in zip(kernel_run(group_dropped_params(params)), plain, names):
        logits_err(got, ref, QUANT_LOGITS_REL_L2, what + ", K8 group scale dropped",
                   planted=True)
    del params, cache

    cycle = 8
    bf16 = init_random_params(cfg, seed=2, device="cuda")
    model = LoadedModel(params=quantize_params_q4(cyclic_params(bf16, cycle)), cfg=cfg,
                        vocab=vocab, mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    del bf16
    models = {"plain": dataclasses.replace(model, params=dequantized(model.params)),
              "auto": model}
    streams = {}
    for impl in ("plain", "auto"):
        eng = InferenceEngine(models[impl], InferenceArgs(
            sequence_length=512, attn_impl=impl, kv_cache_dtype="int8"), device="cuda")
        reset_counts()
        streams[impl] = [t for _, t in eng.generate_tokens(
            list(range(cycle)) * 3, max_new_tokens=32)]
        log(f"cyclic int4/int8-KV model, {impl}: launches {read_counts()}")
    expect = [i % cycle for i in range(32)]
    if streams["plain"] != expect or streams["auto"] != expect:
        fail(f"cyclic int4/int8-KV tokens differ: plain {streams['plain']}, kernels "
             f"{streams['auto']}, expected {expect}")
    log("cyclic 2-layer int4/int8-KV model: 32 greedy tokens equal (plain, kernels, "
        "expected)")
    del model, models
    torch.cuda.empty_cache()


def run_request(engine, tokens, max_new, expect, what):
    """One request through ``generate_string``, with every kernel count set to
    0 just before and read just after. ``expect(steps, prefill_len)`` gives
    the launches each kernel must show (absent: 0)."""
    from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

    cache_len = engine.cache_bucket(len(tokens), max_new)
    prefill_len = prefill_bucket(len(tokens), cache_len)
    reset_counts()
    t0 = time.perf_counter()
    parts, t_first = [], None
    for part in engine.generate_string(tokens, max_new_tokens=max_new):
        if t_first is None:
            t_first = time.perf_counter()
        parts.append(part)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = read_counts()
    ids = [p.token_id for p in parts if not p.is_resend_of_waiting]
    if not ids or any(not 0 <= i < engine.model.cfg.vocab_size for i in ids):
        fail(f"{what}: bad token ids {ids[:8]}")
    text = "".join(p.decoded_string for p in parts)
    steps = len(ids) - 1            # every emitted token but the last ran a step
    want = {name: 0 for name in launches}
    want.update(expect(steps, prefill_len))
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want} ({steps} decode steps, "
             f"prefill bucket {prefill_len})")
    ttft = t_first - t0
    tok_s = steps / (t_end - t_first) if steps else float("nan")
    log(f"{what}: prompt {len(tokens)} tokens, {len(ids)} generated, "
        f"TTFT {ttft * 1e3:.1f} ms, decode {tok_s:.2f} tok/s, launches "
        f"{ {k: n for k, n in launches.items() if n} }; text[:60]={text[:60]!r}")
    return dict(prompt=len(tokens), generated=len(ids), ttft_ms=ttft * 1e3,
                cache_len=cache_len, prefill_len=prefill_len, decode_tok_s=tok_s,
                launches=launches)


def prompts(engine, vocab):
    """Request A's chat prompt, request B's 3000-token prompt and request
    C's 24-token prompt (prefill bucket 32)."""
    from llama_nuts_and_bolts_tpu_torch.tokenizer import PromptPart

    chat = engine.tokenize([
        PromptPart("system", "You are a helpful assistant."),
        PromptPart("user", "Explain what a key-value cache is, in a few sentences."),
    ])
    words = ("the quick brown fox jumps over a lazy dog while seven wizards "
             "quietly box with jovial frogs near the old mill; ").split()
    text = " ".join(words[(i * 7) % len(words)] for i in range(4000))
    ids = engine.tokenize_string(text)
    return chat, [vocab.bos_id] + ids[:2999], [vocab.bos_id] + ids[:23]


def main_path(tk, vocab):
    from llama_nuts_and_bolts_tpu_torch.models.llama import (
        KVCache, LoadedModel, forward, init_random_params)
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    cfg = cfg_8b(32)
    t0 = time.perf_counter()
    params = init_random_params(cfg, seed=0, device="cuda", fused=True)
    torch.cuda.synchronize()
    log(f"8B random init (fused layout): {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    model = LoadedModel(params=params, cfg=cfg, vocab=vocab,
                        mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    engine = InferenceEngine(model, InferenceArgs(sequence_length=8192),
                             device="cuda")
    if engine._attn_impl() != "flash":
        fail("auto attention on the card did not pick the kernels")

    chat, long_prompt, _ = prompts(engine, vocab)

    def expect(steps, prefill_len):
        return {"K1": cfg.n_layers, "K2": cfg.n_layers * steps}

    torch.cuda.reset_peak_memory_stats()
    results = {}
    results["A"] = run_request(engine, chat, 64, expect,
                               "request A (chat, 64 new tokens)")
    results["B"] = run_request(engine, long_prompt, 32, expect,
                               "request B (3000-token prompt, 32 new tokens)")
    peak = torch.cuda.max_memory_allocated()
    log(f"peak device memory: {peak / 2**30:.2f} GiB")

    # the first token's logits on the full model, kernels vs plain path
    logits = {}
    bucket = results["A"]["prefill_len"]
    padded = torch.zeros((1, bucket), dtype=torch.int32, device="cuda")
    padded[0, :len(chat)] = torch.tensor(chat, dtype=torch.int32)
    for name, impl, faults in (("plain", "plain", {}), ("flash", "flash", {}),
                               ("planted", "flash", {"k1": k1_mask_off_by_one})):
        cache = KVCache.create(cfg, 1, results["A"]["cache_len"], device="cuda")
        with planted_faults(**faults):
            logits[name], _ = forward(params, cfg, padded, 0, cache, attn_impl=impl,
                                      logits_at=len(chat) - 1)
        del cache
    if logits["flash"].shape != (1, 1, cfg.vocab_size):
        fail(f"logits shape {tuple(logits['flash'].shape)}")
    what = "32-layer 8B request A prefill logits, kernels vs plain"
    logits_err(logits["flash"], logits["plain"], DEEP_REL_L2, what)
    logits_err(logits["planted"], logits["plain"], DEEP_REL_L2,
               what + ", K1 mask off by one", planted=True)
    worst = float((logits["flash"] - logits["plain"]).abs().max())
    top2 = torch.topk(logits["plain"][0, 0], 2).values
    if float(top2[0] - top2[1]) > 2 * worst and (
            int(logits["flash"][0, 0].argmax()) != int(logits["plain"][0, 0].argmax())):
        fail("32-layer first token differs where the plain argmax is decisive")
    results["peak_memory_gib"] = peak / 2**30
    results["decode_profile"] = profile_decode(engine, long_prompt)
    return results


def k34_work(positions, T, int8_ops: bool):
    """Bytes and operations of K3/K4 over the visible keys: q in and out in
    bf16, int8 k/v rows and their bf16 scales read once."""
    vis = sum(min(p + 1, T) for p in positions)
    B = len(positions)
    nbytes = 2 * B * H * D * 2 + 2 * KV * vis * (D + 2)
    ops = 4.0 * H * D * vis
    return nbytes, ops * (BF16_FLOPS_PER_S / INT8_OPS_PER_S if int8_ops else 1.0)


def k8_work(R, in_dim, out_dim, G, half):
    """Bytes and operations of K8: x, packed weights, scales read once, fp32
    out written once; 2 R in out operations at the bf16 rate."""
    return (R * in_dim * 2 + G * out_dim * half + G * out_dim * 2 + R * out_dim * 4,
            2.0 * R * in_dim * out_dim)


def time_quant_kernels(params, errs, prompt_len_b: int, cache_len_b: int):
    """K3 and K4 at request B's first decode step (every layer of a 32-layer
    int8 cache), and K8 on the main path's own int4 weights at R = 1 (wq, wk,
    w_gate, w_down, the head) and R = 16, 32, each against its plain version
    with planted faults read against the same limits, then timed beside its
    bound, its plain version and, for K8, the library's grouped int4 product
    (``torch._weight_int4pack_mm``) and a bf16 torch.mm on the dequantized
    weight. Timings cycle the layer, so each launch finds its bytes outside
    the 50 MB L2."""
    import torch.nn.functional as F

    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        K2_BLOCK_K, decode_block_k, flash_decode_attention,
        flash_decode_attention_int8_mxu_plain, flash_decode_attention_plain)
    from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import (
        q4_matmul, q4_matmul_plain)
    from llama_nuts_and_bolts_tpu_torch.quant import unpack_q4

    gen = torch.Generator(device="cuda").manual_seed(5)
    L, T, p = 32, cache_len_b, prompt_len_b
    k, ks = int8_cache((L, 1, KV, T, D), gen)
    v, vs = int8_cache((L, 1, KV, T, D), gen)
    qd = randn((1, 1, H, D), gen)
    pos = torch.tensor([p], dtype=torch.int32, device="cuda")
    rows, extra = [], {}
    state = {"li": 0}

    def cycled(fn):
        def call():
            state["li"] = (state["li"] + 1) % L
            return fn(state["li"])
        return call

    # K3: the int8 cache on K2's 64-key tiles
    what = f"K3 B=1 L={L} T={T} pos={p}, every layer (request B's first step)"
    got = torch.stack([k3_call(qd, k, v, ks, vs, pos, li) for li in range(L)])
    ref = torch.stack([flash_decode_attention_plain(qd, k, v, pos, li, ks, vs)
                       for li in range(L)])
    errs["K3"] = max(errs["K3"], kernel_err(got, ref, what))
    kernel_err(k3_call(qd, k, v, ks, vs, pos - 1, 0), ref[0],
               f"K3 T={T} pos={p} layer 0, mask off by one", planted=True)
    kernel_err(k3_call(qd, k, v, ks, vs, pos // K2_BLOCK_K * K2_BLOCK_K - 1, 0), ref[0],
               f"K3 T={T} pos={p} layer 0, last key tile skipped", planted=True)
    ms, _ = cuda_ms(cycled(lambda li: k3_call(qd, k, v, ks, vs, pos, li)), iters=64)
    plain, _ = cuda_ms(lambda: flash_decode_attention_plain(qd, k, v, pos, 1, ks, vs),
                       iters=2, warmup=1)
    b_ms, b_by = bound_ms(*k34_work([p], T, int8_ops=False))
    log(f"K3 B=1 T={T} pos={p}: {ms:.4f} ms (plain {plain:.2f}, bound {b_ms:.4f} by "
        f"{b_by}; no single PyTorch call computes it)")
    rows.append(dict(name="flash_decode_attention, int8 cache (K3)", route="cuda",
                     source="llama_nuts_and_bolts_tpu_torch/csrc/decode_attention.cu",
                     replaces="llama_nuts_and_bolts_tpu/kernels/decode_attention.py:46",
                     max_abs_err=errs["K3"], ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None,
                     shape=f"B=1 L=32 T={T} pos={p} H={H} KV={KV} D={D} int8"))

    # K4, int8 dots, at the JAX tile
    bk = decode_block_k(T, KV, D, True)
    what = f"K4 int8 dots, tile {bk}, B=1 L={L} T={T} pos={p}, every layer"
    got = torch.stack([k4_call(qd, k, v, ks, vs, pos, li) for li in range(L)])
    ref = torch.stack([flash_decode_attention_int8_mxu_plain(qd, k, v, ks, vs, pos, li, bk)
                       for li in range(L)])
    errs["K4"] = max(errs["K4"], kernel_err(got, ref, what))
    kernel_err(k4_call(qd, k, v, ks, vs, pos - 1, 0), ref[0],
               f"K4 T={T} pos={p} layer 0, mask off by one", planted=True)
    kernel_err(k4_call(qd, k, v, ks, vs, pos // bk * bk - 1, 0), ref[0],
               f"K4 T={T} pos={p} layer 0, last key tile skipped", planted=True)
    sub = k4_call(qd, k, v, ks, vs, pos, 0, block_k=64)
    kernel_err(sub, ref[0], f"K4 T={T} pos={p} layer 0, p quantized over 64-key "
               f"sub-tiles instead of the {bk}-key tile (read, not judged)", judged=False)
    extra["k4_subtile64_rel_l2"] = rel_l2(sub, ref[0])
    ms, _ = cuda_ms(cycled(lambda li: k4_call(qd, k, v, ks, vs, pos, li)), iters=64)
    plain, _ = cuda_ms(lambda: flash_decode_attention_int8_mxu_plain(
        qd, k, v, ks, vs, pos, 1, bk), iters=2, warmup=1)
    b_ms, b_by = bound_ms(*k34_work([p], T, int8_ops=True))
    log(f"K4 int8 dots B=1 T={T} pos={p}: {ms:.4f} ms (plain {plain:.2f}, bound "
        f"{b_ms:.4f} by {b_by}; no single PyTorch call computes it)")
    rows.append(dict(name="flash_decode_attention, folded heads, int8 dots (K4)",
                     route="cuda",
                     source="llama_nuts_and_bolts_tpu_torch/csrc/decode_attention_int8.cu",
                     replaces="llama_nuts_and_bolts_tpu/kernels/decode_attention.py:123",
                     max_abs_err=errs["K4"], ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None,
                     shape=f"B=1 L=32 T={T} pos={p} H={H} KV={KV} D={D} int8, tile {bk}"))

    # K4's bf16 mode (it launches K2's kernel), beside SDPA
    kb, vb = randn(k.shape, gen), randn(v.shape, gen)
    bf_ms, _ = cuda_ms(cycled(lambda li: flash_decode_attention(
        qd, kb, vb, pos, layer=li, fold_heads=True)), iters=64)
    vis = [(kb[li, :, :, :p + 1].contiguous(), vb[li, :, :, :p + 1].contiguous())
           for li in range(L)]
    qdt = qd.transpose(1, 2)
    lib, _ = cuda_ms(cycled(lambda li: F.scaled_dot_product_attention(
        qdt, vis[li][0], vis[li][1], enable_gqa=True)), iters=64)
    extra["k4_bf16_mode"] = dict(ms=bf_ms, library_ms=lib,
                                 bound_ms=bound_ms(*k2_work([p], T))[0])
    log(f"K4 bf16 mode (K2's kernel) B=1 T={T} pos={p}: {bf_ms:.4f} ms, sdpa {lib:.4f}")
    del k, v, ks, vs, kb, vb, vis, got, ref
    torch.cuda.empty_cache()

    # K8 on the path's own weights
    shapes = [("wq", 1), ("wk", 1), ("w_gate", 1), ("w_down", 1), ("output", 1),
              ("wq", 16), ("w_down", 16), ("wq", 32), ("w_down", 32)]
    extra["k8"] = []
    for name, R in shapes:
        ws = [params.output] if name == "output" else [
            params.layers[name][li] for li in range(params.layers[name].packed.shape[0])]
        G, out_dim, half = ws[0].packed.shape
        in_dim = 2 * G * half
        x = randn((R, in_dim), gen)
        what = f"K8 {name} R={R} out={out_dim} in={in_dim}"
        got = q4_matmul(x, ws[0].packed, ws[0].scale)
        torch.cuda.synchronize()
        ref = q4_matmul_plain(x, ws[0].packed, ws[0].scale)
        limits = (K8_ATOL, K8_RTOL, K8_REL_L2)
        errs["K8"] = max(errs["K8"], kernel_err(got, ref, what, limits=limits))
        if name in ("output", "w_down") and R in (1, 32):
            kernel_err(k8_group_dropped(x, ws[0].packed, ws[0].scale), ref,
                       what + ", one group's scale dropped", planted=True, limits=limits)
        ms, _ = cuda_ms(cycled(lambda li: q4_matmul(x, ws[li % len(ws)].packed,
                                                    ws[li % len(ws)].scale)), iters=64)
        plain, _ = cuda_ms(lambda: q4_matmul_plain(x, ws[0].packed, ws[0].scale),
                           iters=1, warmup=1)
        # the library's grouped int4 product and a dense bf16 product at the
        # same shape, each over enough copies of the weight to stay outside L2
        n_copies = max(1, -(-200 * 2**20 // (out_dim * in_dim // 2)))
        lib_w = [tinygemm_pack(w) for w in ws[:n_copies]]
        lib_out = torch._weight_int4pack_mm(x, *lib_w[0])
        lib_rel = rel_l2(lib_out, ref)
        log(f"{what}: torch._weight_int4pack_mm against K8's plain version: relative "
            f"L2 {lib_rel:.3e} (its output is bf16; limit {TINYGEMM_REL_L2})")
        if not lib_rel <= TINYGEMM_REL_L2:
            check_failed(f"{what}: torch._weight_int4pack_mm computes another function")
        lib_ms, _ = cuda_ms(cycled(lambda li: torch._weight_int4pack_mm(
            x, *lib_w[li % len(lib_w)])), iters=64)
        del lib_w
        dense = [unpack_q4(w) for w in ws[:max(1, -(-200 * 2**20 // (out_dim * in_dim * 2)))]]
        mm_ms, _ = cuda_ms(cycled(lambda li: torch.mm(x, dense[li % len(dense)].t())),
                           iters=64)
        b_ms, b_by = bound_ms(*k8_work(R, in_dim, out_dim, G, half))
        log(f"{what}: {ms:.4f} ms (plain {plain:.2f}, torch._weight_int4pack_mm "
            f"{lib_ms:.4f}, dense bf16 mm {mm_ms:.4f}, bound {b_ms:.4f} by {b_by})")
        extra["k8"].append(dict(weight=name, R=R, out=out_dim, ms=ms, plain_ms=plain,
                                library_ms=lib_ms, library_rel_l2=lib_rel,
                                dense_bf16_mm_ms=mm_ms, bound_ms=b_ms, bound_by=b_by))
        if name == "output" and R == 1:
            rows.append(dict(name="q4_matmul (K8)", route="cuda",
                             source="llama_nuts_and_bolts_tpu_torch/csrc/q4_matmul.cu",
                             replaces="llama_nuts_and_bolts_tpu/kernels/q4_matmul.py:36",
                             max_abs_err=errs["K8"], ms=ms, plain_ms=plain,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             library="torch._weight_int4pack_mm (bf16 out)",
                             dense_bf16_mm_ms=mm_ms,
                             shape=f"R=1 x [1,{in_dim}] bf16, head packed [{G},{out_dim},"
                                   f"{half}] (128256-row logits head)"))
        del dense, ws
    torch.cuda.empty_cache()
    return rows, extra


def quant_main_path(tk, vocab, errs):
    """The quantized main path: the 32-layer 8B with int4 weights (seed 0)
    and an int8 cache at a context of 8192, through generate_string --
    request A (chat), B (3000-token prompt), C (24-token prompt: prefill
    bucket 32, so K8 runs in its prefill too) -- with K8 and K4 launch counts
    per request; then a decode-step profile at B's shapes, the kernels timed
    at the path's shapes, and request A on int8 weights with a bf16 cache."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel
    from llama_nuts_and_bolts_tpu_torch.quant import (
        init_random_params_q4, init_random_params_q8)
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    cfg = cfg_8b(32)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_random_params_q4(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"8B random init (int4 weights): {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    model = LoadedModel(params=params, cfg=cfg, vocab=vocab,
                        mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    engine = InferenceEngine(model, InferenceArgs(sequence_length=8192,
                                                  kv_cache_dtype="int8"), device="cuda")
    chat, long_prompt, short = prompts(engine, vocab)

    def expect(steps, prefill_len):
        # every projection of a prefill of at most 32 rows takes K8, a larger
        # one only the head (logits_at: one row); each decode step runs all
        # 7 x 32 projections and the head on K8, and K4 once per layer
        k8_prefill = 7 * L + 1 if prefill_len <= 32 else 1
        return {"K8": k8_prefill + (7 * L + 1) * steps, "K4": L * steps}

    results = {}
    for key, tokens, max_new, what in (
            ("A", chat, 64, "int4/int8-KV request A (chat, 64 new tokens)"),
            ("B", long_prompt, 32, "int4/int8-KV request B (3000-token prompt, 32 new)"),
            ("C", short, 32, "int4/int8-KV request C (24-token prompt, 32 new)")):
        results[key] = run_request(engine, tokens, max_new, expect, what)
    if results["C"]["prefill_len"] != 32:
        fail(f"request C's prefill bucket is {results['C']['prefill_len']}, not 32")
    peak = torch.cuda.max_memory_allocated()
    log(f"int4/int8-KV peak device memory: {peak / 2**30:.2f} GiB")
    results["peak_memory_gib"] = peak / 2**30
    results["decode_profile"] = profile_decode(engine, long_prompt)
    rows, extra = time_quant_kernels(params, errs, results["B"]["prompt"],
                                     results["B"]["cache_len"])
    results["kernels"] = extra
    del engine, model, params
    torch.cuda.empty_cache()

    params = init_random_params_q8(cfg, seed=0, device="cuda")
    model = LoadedModel(params=params, cfg=cfg, vocab=vocab,
                        mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    engine = InferenceEngine(model, InferenceArgs(sequence_length=8192), device="cuda")
    results["int8_weights_A"] = run_request(
        engine, chat, 64, lambda steps, _: {"K1": L, "K2": L * steps},
        "int8-weight request A (chat, 64 new tokens, bf16 cache)")
    del engine, model, params
    torch.cuda.empty_cache()
    return results, rows


def profile_decode(engine, prompt, steps: int = 8):
    """Decode steps at request B's shapes: the host clock per step without
    the profiler, then the device time of the kernels under torch.profiler
    -- the device's idle share and the kernels that take its time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache_len = engine.cache_bucket(len(prompt), 32)
    logits, cache = engine._prefill(prompt, cache_len)
    tok = int(torch.argmax(logits[0, -1]))

    def run(first):
        for i in range(steps):
            engine._forward([[tok]], first + i, cache)
        torch.cuda.synchronize()

    run(len(prompt))                                        # warm
    t0 = time.perf_counter()
    run(len(prompt) + steps)
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(len(prompt) + 2 * steps)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"decode step at request B's shapes: wall {wall_ms:.2f} ms, device busy "
        f"{device_ms:.2f} ms ({1 - device_ms / wall_ms:.1%} idle), "
        f"{sum(e.count for e in kernels) // steps} kernels/step")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{e.count // steps:5d} calls/step  {e.key[:90]}")
    # the port's kernels by name: their device ms per step and share of it
    ours = {}
    for tag, name in (("K2", "flash_decode_kernel"), ("K4", "int8_dot_decode_kernel"),
                      ("K8", "q4_matmul_kernel")):
        ms = sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3 / steps
        calls = sum(e.count for e in kernels if name in e.key) // steps
        if calls:
            ours[tag] = dict(ms=ms, calls=calls, share=ms / device_ms)
            log(f"  {tag} ({name}): {ms:.3f} ms/step, {calls} calls/step, "
                f"{ms / device_ms:.1%} of device busy time")
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                kernels_per_step=sum(e.count for e in kernels) // steps,
                top=[(e.key[:90], e.self_device_time_total / 1e3 / steps) for e in top],
                ours=ours)


def main() -> int:
    name, smi = setup()
    log("phase 2: kernels vs plain at 8B widths")
    errs = check_kernels()
    errs.update(check_quant_kernels())
    tk, vocab = synthetic_tokenizer()
    log("phase 3: 2-layer full-width models, kernels vs plain path")
    check_model_path(tk, vocab)
    check_quant_model_path(tk, vocab)
    log("phase 4: main path, 32-layer 8B, bf16 weights and cache, random weights")
    results = main_path(tk, vocab)
    rows = time_kernels(errs, results["B"]["prompt"], results["B"]["cache_len"],
                        results["B"]["prefill_len"])
    log("phase 5: main path, 32-layer 8B, int4 weights and an int8 cache")
    qresults, qrows = quant_main_path(tk, vocab, errs)
    rows += qrows
    # each kernel's launches are those of its path's requests
    for row, tag, runs in zip(rows, ("K1", "K2", "K3", "K4", "K8"),
                              ((results,) * 2 + (qresults,) * 3)):
        row["launches"] = sum(runs[r]["launches"][tag] for r in ("A", "B", "C")
                              if r in runs)
    log(f"summary: {json.dumps(results)}")
    log(f"summary, quantized path: {json.dumps(qresults)}")
    if FAILED:
        fail(f"{len(FAILED)} checks failed: " + "; ".join(FAILED))
    log(f"total {time.perf_counter() - T_START:.1f}s on {smi}")
    print(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "dense_bf16_mm_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
