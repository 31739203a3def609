"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the CUDA kernels from ``llama_nuts_and_bolts_tpu_torch/csrc``, holds
each against its plain PyTorch version at Llama-3.1-8B widths and at the
main paths' own shapes, checks the forward pass with the kernels against the
plain path on 2-layer full-width models, and drives the main paths on the
full 32-layer 8B architecture with seeded random weights: greedy streaming
chat through ``InferenceEngine.generate_string`` with bf16 weights and
cache (K1, K2), then int4 weights with an int8 cache (K8, K4), with a last
request on int8 weights; then the OpenAI-compatible server
(``LlamaHTTPServer``) over the paged continuous batcher, with concurrent
HTTP requests on a bf16 pool (K6) and an int8 pool (K6's int8 mode) -- and
times the kernels (K5 and K7 too, which serve no path). Then speculative
decoding (k = 4): the sequential engine on the 32-layer 8B, bf16, with
n-gram drafts on the constructed-cyclic model and on the random-weight one,
and with draft models at Llama-3.2-1B's widths (a 2-layer cyclic draft, a
16-layer random one), each against plain greedy, with acceptance, the
captured verify step's device time and host wall, and exact launch counts,
and the planted fault "the slot's position not rewound after a rejection";
the same with int4 weights and an int8 cache (K8 in the verify step); the
dense and paged speculative batchers on the 2-layer cyclic model (a pool
that clamps the drafts, greedy beside sampled); the speculative server over
HTTP with its ``llama_spec_*`` counters and ``continuous.speculation``.
Then the single-device modules on the 32-layer 8B: the measured attention
probe (``attn_impl="probe"``) on bf16 and int8 caches beside ``auto``, with
exact launches, the probe's replays included; request B's prefill narrated
a layer at a time on K1, bit-equal to ``forward`` (a skipped layer must not
be), and traced (``device_trace``) with a replayed decode step, each trace's
device time by kernel; request B's text through the native BPE merge and
the Python merge; a 2-layer 8B-width model saved as Meta's 2-shard
checkpoint and loaded by ``load_llama_model``, its logits bit-equal to the
state dict's (the shards reversed must not be). Then tensor parallelism
(phases 18-21): K1, K2, K4 and K8 at one rank's shapes at tp 2 and 4; one
NCCL rank (``make_mesh(tp=1)``) through generate_string on captured graphs,
bit-equal to the engine without a mesh; two gloo ranks on the one card
against the unsharded 32-layer forward; and, on a machine of 2 cards or
more, NCCL at tp = min(4, cards) on the CLI's process model (one card: a
line says it did not run). Then tensor parallelism for serving (phases
22-25): K6 through ``tp_paged_flash_decode`` at tp 2 and 4 rank shapes; one
NCCL rank through the HTTP server (paged bf16 pool speculating, int8 pool,
dense batcher on int4 weights and an int8 cache), texts, /metrics and
launches equal to the server's without a mesh; two gloo ranks on the one
card through the eager paged functions against the unsharded ones; and, on
2 cards or more, the server at --tp min(4, cards) against one card's
texts. These run in child processes (``--tp-rank``) after the parent's
models are freed. Every limit is also read against
planted faults, which must fail it. Any failed check exits non-zero.

Run from the repository root: ``python3 chip_smoke.py``. The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it is
the kernel table as JSON, and before that the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import json
import os
import re
import subprocess
import sys
import threading
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
# faults (a causal mask off by one, a skipped key tile, K2's last active
# split skipped) against the same limits, and fails if one of them passes.
# On an H100 the sound kernels read at most 2.4e-4 relative L2, the nearest
# planted fault 5.5e-3 (PERF.md).
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
# SDPA, the attention kernels' one-call yardstick, against the kernel's plain
# version: a bf16 output of the same function with other tiles and another
# place of rounding p. On an H100 it reads 4e-5 to 3e-3 (PERF.md); the limit
# holds it to the same function up to bf16 rounding, no closer.
SDPA_REL_L2 = 1e-2
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


def library_err(out: torch.Tensor, ref: torch.Tensor, what: str,
                limit: float = SDPA_REL_L2) -> float:
    """A one-call yardstick's ``out`` against the plain version's ``ref`` on
    the same inputs: it must compute the same function, within ``limit``
    relative L2, or its time is no yardstick. Returns the relative L2."""
    rel = rel_l2(out, ref)
    ok = bool(torch.isfinite(out.float()).all()) and rel <= limit
    log(f"{what}: its output {rel:.3e} relative L2 from the plain version's "
        f"(limit {limit}): {'passes' if ok else 'fails'}")
    if not ok:
        check_failed(f"{what} computes another function than the plain version")
    return rel


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
            # the kernel's name in its mangled symbol (after the anonymous
            # namespace's "_cu_<hash>", a length and the name), and a cache
            # template's element type
            entry = re.search(r"Compiling entry function '.*?_cu_[0-9a-f]{8}(\d+)", line)
            if entry:
                kernel = line[entry.end():entry.end() + int(entry.group(1))]
                rest = line[entry.end() + len(kernel):]
                count = re.match(r"ILi(\d+)E", rest)          # an int template argument
                flag = re.match(r"ILb([01])E", rest)          # K6's int8 flag
                kind = ("<int8>" if rest.startswith("IaE") or (flag and flag.group(1) == "1")
                        else "<bf16>" if rest.startswith("I13__nv_bfloat16E") or flag else
                        f"<{count.group(1)}>" if count else "")
                log(f"ptxas {src}: {kernel}{kind}")
            elif "registers" in line or "spill" in line or "error" in line.lower():
                log(f"ptxas {src}: {line.strip()}")
    log(f"kernel build: {time.perf_counter() - t0:.1f}s "
        f"({', '.join(build.SOURCES)})")
    from llama_nuts_and_bolts_tpu_torch.tokenizer.native import native_available

    # host code: the prompts below are encoded by the native merge
    if not native_available():
        check_failed("the native BPE merge (native/bpe_merge.cpp) did not build")
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


def k4_last_rank_dropped(q, k, v, ks, vs, pos, layer):
    """Planted fault: K4 adding every rank's PV sum but that of the last
    rank holding keys of the row's last tile (k4_cluster's partition): those
    keys' v scales zeroed."""
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        decode_block_k, k4_geometry)

    B, T = k.shape[1], k.shape[3]
    bk = decode_block_k(T, KV, D, True)
    geo = k4_geometry(B, KV, T, bk)
    vs = vs.clone()
    for b, p in enumerate(pos.tolist()):
        n = min(p + 1, T)
        t0 = (n - 1) // bk * bk
        start, end = geo.rank_keys(n, t0, geo.active_ranks(n, t0) - 1)
        vs[layer, b, :, start:end] = 0
    return k4_call(q, k, v, ks, vs, pos, layer)


def k8_group_dropped(x, packed, scale):
    """Planted fault: K8 with one group's scale dropped (its partial lost)."""
    from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import q4_matmul

    scale = scale.clone()
    scale[scale.shape[0] // 2] = 0
    return q4_matmul(x, packed, scale)


def k8_last_split_dropped(x, packed, scale):
    """Planted fault: K8 combining every split but the last (k8_split's
    partition): the last split's groups' scales zeroed."""
    from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import k8_split, q4_matmul

    G, out_dim, _ = packed.shape
    split = k8_split(x.shape[0], x.shape[1], out_dim, G)
    scale = scale.clone()
    scale[(G - 1) // split * split:] = 0
    return q4_matmul(x, packed, scale)


def k8_halves_swapped(x, packed, scale):
    """Planted fault: K8 with x's low and high halves swapped within each
    group, what a wrong fragment permutation (low nibbles on the high half's
    x) computes."""
    from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import q4_matmul

    G = packed.shape[0]
    swapped = x.reshape(x.shape[0], G, 2, -1).flip(2).reshape(x.shape).contiguous()
    return q4_matmul(swapped, packed, scale)


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
    """Every kernel's wrapper, whose ``launches`` counts its kernel (K6's
    bf16 and int8 modes apart), in ``KERNEL_WRAPPERS``' order."""
    from llama_nuts_and_bolts_tpu_torch.runtime.decode_graph import KERNEL_WRAPPERS

    return dict(zip(("K1", "K2", "K3", "K4", "K5", "K6", "K6i8", "K7", "K8"),
                    KERNEL_WRAPPERS))


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

    # K2's splits: 256 keys at T=8192 (511, 512 on a split edge), 512 keys at
    # B=3, T=4096; rows at 0 and T - 1 side by side
    cases = [(1, 1, 0, 8192, [p]) for p in (0, 511, 512, 4095, 8191)]
    cases += [(4, 1, 0, 2048, [3, 700, 2047, 1000]), (2, 4, 2, 1024, [130, 1023]),
              (1, 1, 0, 256, [70]), (1, 1, 0, 256, [134]), (2, 1, 0, 4096, [0, 4095]),
              (3, 2, 1, 4096, [511, 512, 513])]
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
    R = 1, 3, 9, 16, 17, 32."""
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
        for R in (1, 3, 9, 16, 17, 32):          # every row bucket, at and past its edge
            x = randn((R, in_dim), gen)
            got = q4_matmul(x, qt.packed, qt.scale)
            torch.cuda.synchronize()
            ref = q4_matmul_plain(x, qt.packed, qt.scale)
            errs["K8"] = max(errs["K8"], kernel_err(
                got, ref, f"K8 R={R} out={out_dim} in={in_dim}",
                limits=(K8_ATOL, K8_RTOL, K8_REL_L2)))
        if in_dim == 14336:
            # w_down's 56 groups in splits of 11 (the last of 1 group)
            got = q4_matmul(x[:1], qt.packed, qt.scale, 11)
            torch.cuda.synchronize()
            errs["K8"] = max(errs["K8"], kernel_err(
                got, q4_matmul_plain(x[:1], qt.packed, qt.scale, 11),
                f"K8 R=1 out={out_dim} in={in_dim}, splits of 11 groups",
                limits=(K8_ATOL, K8_RTOL, K8_REL_L2)))
    return errs


def k1_sdpa(q, k, v, start_pos: int):
    """One PyTorch call computing K1's function, for its yardstick: SDPA over
    the visible keys, causal to the query's own position. At start_pos 0 with
    S = T, ``is_causal`` on the GQA heads; otherwise the keys up to the last
    row's position, the causal mask aligned to its end (lower right), and
    the KV heads repeated for the G query heads outside the call. Returns
    the call and its output's layout as K1's, ``[B, S, H, D]``."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    S, T = q.shape[1], k.shape[2]
    qt = q.transpose(1, 2)
    if start_pos == 0 and S == T:
        return lambda: F.scaled_dot_product_attention(qt, k, v, is_causal=True,
                                                      enable_gqa=True)
    n = min(T, start_pos + S)
    kx = k[:, :, :n].repeat_interleave(H // KV, dim=1)
    vx = v[:, :, :n].repeat_interleave(H // KV, dim=1)
    bias = causal_lower_right(S, n)
    return lambda: F.scaled_dot_product_attention(qt, kx, vx, attn_mask=bias)


def time_k1(gen, errs, S: int, start_pos: int, T: int, what: str):
    """K1 at one shape against its plain version (mask off by one planted),
    timed beside SDPA (checked to compute the same function) and the bound.
    Returns the numbers and the inputs with the kernel's and plain output."""
    from llama_nuts_and_bolts_tpu_torch.kernels.attention import (
        flash_gqa_attention, flash_gqa_attention_plain)

    q = randn((1, S, H, D), gen)
    k, v = randn((1, KV, T, D), gen), randn((1, KV, T, D), gen)
    ms, got = cuda_ms(lambda: flash_gqa_attention(q, k, v, start_pos), iters=20)
    plain, ref = cuda_ms(lambda: flash_gqa_attention_plain(q, k, v, start_pos),
                         iters=1, warmup=1)
    what = f"K1 S={S} start_pos={start_pos} T={T} ({what})"
    errs["K1"] = max(errs["K1"], kernel_err(got, ref, what))
    kernel_err(k1_mask_off_by_one(q, k, v, start_pos), ref, what + ", mask off by one",
               planted=True)
    sdpa = k1_sdpa(q, k, v, start_pos)
    lib, lib_out = cuda_ms(sdpa, iters=20)
    library_err(lib_out.transpose(1, 2), ref, what + ", SDPA")
    b_ms, b_by = bound_ms(*k1_work(S, T, start_pos))
    log(f"{what}: {ms:.4f} ms (plain {plain:.2f}, sdpa {lib:.4f}, bound {b_ms:.4f} "
        f"by {b_by})")
    numbers = dict(shape=f"B=1 S={S} start_pos={start_pos} T={T} H={H} KV={KV} D={D}",
                   ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    return numbers, (q, k, v, got, ref)


def k2_last_split_skipped(q, k, v, positions, layer, **kw):
    """Planted fault: the decode kernel (K2, or K3 with an int8 cache's
    keywords) with the last active split of the row at the largest position
    skipped, i.e. the sound kernel run with that row's position at its last
    split's first key - 1."""
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        flash_decode_attention, k2_split_k)

    split = k2_split_k(q.shape[0], k.shape[2], k.shape[3])
    b = int(torch.argmax(positions))
    cut = positions.clone()
    cut[b] = positions[b] // split * split - 1
    return flash_decode_attention(q, k, v, cut, layer=layer, **kw)


def time_k2(gen, errs, positions, T: int, what: str, every_layer: bool = False):
    """K2 on a 32-layer stacked cache at ``positions`` (one per row) against
    its plain version (one layer, or every layer), planted faults read
    against the same limits (mask off by one, the row's last key tile
    skipped, its last active split skipped); then timed cycling the layer,
    so that every launch finds its bytes outside the 50 MB L2, beside SDPA
    over the visible keys (checked to compute the same function) and the
    bound. Logs the launch's split geometry, by k2_geometry's rule."""
    import torch.nn.functional as F

    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        K2_BLOCK_K, flash_decode_attention, flash_decode_attention_plain, k2_geometry)

    L, B = 32, len(positions)
    kc, vc = randn((L, B, KV, T, D), gen), randn((L, B, KV, T, D), gen)
    qd = randn((B, 1, H, D), gen)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    layers = range(L) if every_layer else [0]
    got = torch.stack([flash_decode_attention(qd, kc, vc, pos, layer=li) for li in layers])
    ref = torch.stack([flash_decode_attention_plain(qd, kc, vc, pos, li) for li in layers])
    what = f"K2 B={B} L={L} T={T} pos={positions} ({what})"
    errs["K2"] = max(errs["K2"], kernel_err(
        got, ref, what + (", every layer" if every_layer else ", layer 0")))
    kernel_err(k2_mask_off_by_one(qd, kc, vc, pos, 0), ref[0], what + ", mask off by one",
               planted=True)
    kernel_err(flash_decode_attention(qd, kc, vc, pos // K2_BLOCK_K * K2_BLOCK_K - 1,
                                      layer=0), ref[0],
               what + ", last key tile skipped", planted=True)
    kernel_err(k2_last_split_skipped(qd, kc, vc, pos, 0), ref[0],
               what + ", last active split of the longest row skipped", planted=True)
    qdt, vis = qd.transpose(1, 2), None
    if B == 1:           # the visible keys only
        vis = [(kc[li, :, :, :positions[0] + 1].contiguous(),
                vc[li, :, :, :positions[0] + 1].contiguous()) for li in range(L)]

        def sdpa(li):
            return F.scaled_dot_product_attention(qdt, *vis[li], enable_gqa=True)
    else:                # rows at other positions: every key, the rest masked
        visible = torch.arange(T, device="cuda")[None, None, None, :] <= \
            pos.long()[:, None, None, None]

        def sdpa(li):
            return F.scaled_dot_product_attention(qdt, kc[li], vc[li], attn_mask=visible,
                                                  enable_gqa=True)
    library_err(sdpa(0).transpose(1, 2), ref[0], what + ", SDPA at layer 0")
    del got, ref
    state = {"li": 0}

    def cycled(fn):
        def call():
            state["li"] = (state["li"] + 1) % L
            return fn(state["li"])
        return call

    ms, _ = cuda_ms(cycled(lambda li: flash_decode_attention(qd, kc, vc, pos, layer=li)),
                    iters=64)
    plain, _ = cuda_ms(lambda: flash_decode_attention_plain(qd, kc, vc, pos, 1),
                       iters=2, warmup=1)
    lib, _ = cuda_ms(cycled(sdpa), iters=64)
    b_ms, b_by = bound_ms(*k2_work(positions, T))
    # the launch's geometry by k2_geometry's rule (not read from the card)
    geo = k2_geometry(B, KV, T, positions)
    blocks = geo.grid[0] * geo.grid[1] * geo.grid[2]
    active = KV * sum(geo.active_splits)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"{what}: {ms:.4f} ms (plain {plain:.2f}, sdpa {lib:.4f}, bound {b_ms:.4f} by "
        f"{b_by}); geometry: split_k {geo.split_k}, {geo.grid[0]} splits a row, "
        f"active splits {geo.active_splits}: {active} of {blocks} blocks pass the early "
        f"exit, on {sms} SMs")
    numbers = dict(shape=f"B={B} L={L} T={T} pos={positions} H={H} KV={KV} D={D}",
                   ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    del kc, vc, vis, sdpa
    torch.cuda.empty_cache()
    return numbers


def time_kernels(errs, prompt_len_b: int, cache_len_b: int, prefill_len_b: int,
                 prefill_len_a: int, cache_len_a: int):
    """K1 and K2 at the main path's shapes, each against its plain version
    on the same inputs with planted faults read against the same limits,
    then timed: K1 at request B's prefill (the row), at request A's and at a
    512-row chunk with 3000 positions of history; K2 at request B's first
    decode step over every layer of a 32-layer cache (the row), at the last
    position of an 8192-slot cache and at the dense batcher's shape (4 rows
    at mixed positions)."""
    from llama_nuts_and_bolts_tpu_torch.kernels.attention import (
        K1_BLOCK_K, flash_gqa_attention, k1_geometry)

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []

    # K1: S = T = request B's prefill bucket, from position 0
    S = T = prefill_len_b
    k1, (q, k, v, got, ref) = time_k1(gen, errs, S, 0, T, "request B's prefill")
    # the last q tile loses its last key tile (the one on its diagonal)
    p0 = S - k1_geometry(1, S, H, KV, T, 0).block_q
    t_cut = (S - 1) // K1_BLOCK_K * K1_BLOCK_K
    faulty = got.clone()
    faulty[:, p0:] = flash_gqa_attention(
        q[:, p0:].contiguous(), k[:, :, :t_cut].contiguous(),
        v[:, :, :t_cut].contiguous(), p0)
    kernel_err(faulty, ref, f"K1 S=T={S}, last key tile of the last q tile skipped",
               planted=True)
    del q, k, v, got, ref, faulty
    more = [time_k1(gen, errs, prefill_len_a, 0, cache_len_a, "request A's prefill")[0],
            time_k1(gen, errs, 512, 3000, 4096, "a chunk with history")[0]]
    rows.append(dict(name="flash_gqa_attention (K1)", route="cuda",
                     source="llama_nuts_and_bolts_tpu_torch/csrc/flash_attention.cu",
                     replaces="llama_nuts_and_bolts_tpu/kernels/attention.py:33",
                     max_abs_err=errs["K1"], more_shapes=more, **k1))
    torch.cuda.empty_cache()

    # K2: request B's first decode step, every layer of a 32-layer cache
    k2 = time_k2(gen, errs, [prompt_len_b], cache_len_b, "request B's first step",
                 every_layer=True)
    more = [time_k2(gen, errs, [8191], 8192, "the last slot of an 8192 cache"),
            time_k2(gen, errs, [3, 700, 2047, 1000], 2048, "the dense batcher's shape")]
    rows.append(dict(name="flash_decode_attention (K2)", route="cuda",
                     source="llama_nuts_and_bolts_tpu_torch/csrc/decode_attention.cu",
                     replaces="llama_nuts_and_bolts_tpu/kernels/decode_attention.py:46",
                     max_abs_err=errs["K2"], more_shapes=more, **k2))
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
    # captured decode: auto replays a one-step graph per token, decode_chunk 8
    # an 8-step one, generate_block a stop-tracking 8-step one; the eager
    # per-token path is the yardstick
    from llama_nuts_and_bolts_tpu_torch.runtime.device_loop import generate_block

    prompt = list(range(cycle)) * 3
    streams = {}
    for name, args in (("plain", dict(attn_impl="plain")), ("flash", {}),
                       ("flash, decode_chunk 8", dict(decode_chunk=8))):
        eng = InferenceEngine(model, InferenceArgs(sequence_length=512, **args),
                              device="cuda")
        streams[name] = [t for _, t in eng.generate_tokens(prompt, max_new_tokens=32)]
    streams["generate_block"] = generate_block(eng, prompt, 32)[0]
    streams["eager steps"] = eager_greedy(eng, prompt, 32, eng.cache_bucket(len(prompt), 32))
    expect = [i % cycle for i in range(32)]
    if any(tokens != expect for tokens in streams.values()):
        fail(f"cyclic model tokens differ: {streams}, expected {expect}")
    log(f"cyclic 2-layer model: 32 greedy tokens equal ({', '.join(streams)}, expected)")
    del params, model, eng
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


def decode_steps(n_tokens: int, k: int, room: int) -> int:
    """Decode steps the card runs for a request that emits ``n_tokens``,
    with ``room`` cache positions past the prompt: at k = 1 one a token after
    the prefill's; at k > 1 the k-step chunks the later tokens need, and the
    one chunk in flight when the last of them is read (the engine queues the
    next chunk before it reads one). Far from the horizon only, where no
    per-token tail runs."""
    if k == 1 or n_tokens <= 1:
        return max(n_tokens - 1, 0)
    if n_tokens + 2 * k >= room:
        fail(f"{n_tokens} tokens at decode_chunk {k} reach the horizon ({room})")
    return k * (-(-(n_tokens - 1) // k) + 1)


def run_request(engine, tokens, max_new, expect, what, captures=()):
    """One request through ``generate_string``, with every kernel count set to
    0 just before and read just after. ``expect(steps, prefill_len)`` gives
    the launches each kernel must show (absent: 0), where ``steps`` counts
    every decode step the card ran: the replayed ones (:func:`decode_steps`)
    and the one warm-up step of each decode graph the request captures.
    ``captures`` lists those graphs' k: a cache bucket's first request on
    an engine captures its graph."""
    from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

    cache_len = engine.cache_bucket(len(tokens), max_new)
    prefill_len = prefill_bucket(len(tokens), cache_len)
    graphs_before = dict(engine._chunk_fns)
    replays_before = {key: g.replays for key, g in graphs_before.items()}
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
    k = engine._decode_chunk_size()
    new = [key for key in engine._chunk_fns if key not in graphs_before]
    if sorted(key[0] for key in new) != sorted(captures):
        fail(f"{what}: captured decode graphs {new}, expected graphs of k = "
             f"{list(captures)}")
    warm = len(captures)
    steps = decode_steps(len(ids), k, cache_len - len(tokens))
    # the graphs' own tally of the steps they ran must agree
    ran = sum(g.k * (g.replays - replays_before.get(key, 0))
              + (g.warmup_steps if key in new else 0)
              for key, g in engine._chunk_fns.items())
    if ran != steps + warm:
        fail(f"{what}: the decode graphs ran {ran} steps, expected {steps} replayed "
             f"+ {warm} warm-up")
    want = {name: 0 for name in launches}
    want.update(expect(steps + warm, prefill_len))
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want} ({steps} decode steps "
             f"+ {warm} warm-up at decode_chunk {k}, prefill bucket {prefill_len})")
    ttft = t_first - t0
    tok_s = (len(ids) - 1) / (t_end - t_first) if len(ids) > 1 else float("nan")
    log(f"{what}: prompt {len(tokens)} tokens, {len(ids)} generated, "
        f"TTFT {ttft * 1e3:.1f} ms, decode {tok_s:.2f} tok/s at decode_chunk {k} "
        f"({steps} steps + {warm} warm-up), launches "
        f"{ {k: n for k, n in launches.items() if n} }; text[:60]={text[:60]!r}")
    return dict(prompt=len(tokens), generated=len(ids), ttft_ms=ttft * 1e3,
                cache_len=cache_len, prefill_len=prefill_len, decode_tok_s=tok_s,
                decode_chunk=k, steps=steps, warmup_steps=warm, launches=launches,
                ids=ids)


def prompts(engine, vocab):
    """Request A's chat prompt, request B's 3000-token prompt and request
    C's 24-token prompt (prefill bucket 32)."""
    from llama_nuts_and_bolts_tpu_torch.tokenizer import PromptPart

    chat = engine.tokenize([
        PromptPart("system", "You are a helpful assistant."),
        PromptPart("user", "Explain what a key-value cache is, in a few sentences."),
    ])
    ids = engine.tokenize_string(long_text())
    return chat, [vocab.bos_id] + ids[:2999], [vocab.bos_id] + ids[:23]


def long_text() -> str:
    """The text whose first tokens are request B's prompt (and C's)."""
    words = ("the quick brown fox jumps over a lazy dog while seven wizards "
             "quietly box with jovial frogs near the old mill; ").split()
    return " ".join(words[(i * 7) % len(words)] for i in range(4000))


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
                               "request A (chat, 64 new tokens)", captures=(1,))
    results["B"] = run_request(engine, long_prompt, 32, expect,
                               "request B (3000-token prompt, 32 new tokens)",
                               captures=(1,))
    peak = torch.cuda.max_memory_allocated()
    log(f"peak device memory: {peak / 2**30:.2f} GiB")
    chunked = InferenceEngine(model, InferenceArgs(sequence_length=8192, decode_chunk=8),
                              device="cuda")
    for key, tokens, max_new, what in (
            ("A", chat, 64, "request A at decode_chunk 8"),
            ("B", long_prompt, 32, "request B at decode_chunk 8")):
        results[key + "_chunk8"] = run_request(chunked, tokens, max_new, expect, what,
                                               captures=(8,))
    results["graphs"] = graph_costs(chunked, "bf16, decode_chunk 8")
    del chunked

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
    results["captured_vs_eager"] = check_captured_deep(engine, long_prompt, chat)
    results["graphs"] += graph_costs(engine, "bf16, auto")
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


def time_quant_kernels(params, errs, prompt_len_b: int, cache_len_b: int,
                       pos_a: int = 103, cache_len_a: int = 256):
    """K3 and K4 at request B's first decode step (every layer of a 32-layer
    int8 cache), K4 also at a decode step of request A (``pos_a`` in a
    ``cache_len_a`` cache), and K8 on the main path's own int4 weights at
    R = 1 (wq, wk, w_gate, w_down, the head) and R = 16, 32, each against its
    plain version with planted faults read against the same limits, then
    timed beside its bound, its plain version and, for K8, the library's
    grouped int4 product (``torch._weight_int4pack_mm``) and a bf16 torch.mm
    on the dequantized weight. Timings cycle the layer, so each launch finds
    its bytes outside the 50 MB L2."""
    import torch.nn.functional as F

    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        K2_BLOCK_K, decode_block_k, flash_decode_attention,
        flash_decode_attention_int8_mxu_plain, flash_decode_attention_plain, k2_geometry,
        k2_split_k, k4_geometry)
    from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import (
        k8_split, q4_matmul, q4_matmul_plain)
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

    # K3: the int8 cache on K2's split key walk and 64-key tiles
    what = f"K3 B=1 L={L} T={T} pos={p}, every layer (request B's first step)"
    got = torch.stack([k3_call(qd, k, v, ks, vs, pos, li) for li in range(L)])
    ref = torch.stack([flash_decode_attention_plain(qd, k, v, pos, li, ks, vs)
                       for li in range(L)])
    errs["K3"] = max(errs["K3"], kernel_err(got, ref, what))
    kernel_err(k3_call(qd, k, v, ks, vs, pos - 1, 0), ref[0],
               f"K3 T={T} pos={p} layer 0, mask off by one", planted=True)
    kernel_err(k3_call(qd, k, v, ks, vs, pos // K2_BLOCK_K * K2_BLOCK_K - 1, 0), ref[0],
               f"K3 T={T} pos={p} layer 0, last key tile skipped", planted=True)
    kernel_err(k2_last_split_skipped(qd, k, v, pos, 0, k_scale=ks, v_scale=vs), ref[0],
               f"K3 T={T} pos={p} layer 0, last active split skipped (split_k "
               f"{k2_split_k(1, KV, T)})", planted=True)
    ms, _ = cuda_ms(cycled(lambda li: k3_call(qd, k, v, ks, vs, pos, li)), iters=64)
    plain, _ = cuda_ms(lambda: flash_decode_attention_plain(qd, k, v, pos, 1, ks, vs),
                       iters=2, warmup=1)
    b_ms, b_by = bound_ms(*k34_work([p], T, int8_ops=False))
    geo = k2_geometry(1, KV, T, [p])      # by the rule, not read from the card
    blocks, active = geo.grid[0] * KV, geo.active_splits[0] * KV
    log(f"K3 B=1 T={T} pos={p}: {ms:.4f} ms (plain {plain:.2f}, bound {b_ms:.4f} by "
        f"{b_by}; no single PyTorch call computes it); geometry: split_k "
        f"{geo.split_k}, {active} of {blocks} blocks pass the early exit")
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
    kernel_err(k4_last_rank_dropped(qd, k, v, ks, vs, pos, 0), ref[0],
               f"K4 T={T} pos={p} layer 0, the last active rank's keys dropped",
               planted=True)
    sub = k4_call(qd, k, v, ks, vs, pos, 0, block_k=64)
    kernel_err(sub, ref[0], f"K4 T={T} pos={p} layer 0, p quantized over 64-key "
               f"sub-tiles instead of the {bk}-key tile (read, not judged)", judged=False)
    extra["k4_subtile64_rel_l2"] = rel_l2(sub, ref[0])
    ms, _ = cuda_ms(cycled(lambda li: k4_call(qd, k, v, ks, vs, pos, li)), iters=64)
    plain, _ = cuda_ms(lambda: flash_decode_attention_int8_mxu_plain(
        qd, k, v, ks, vs, pos, 1, bk), iters=2, warmup=1)
    b_ms, b_by = bound_ms(*k34_work([p], T, int8_ops=True))
    log(f"K4 int8 dots B=1 T={T} pos={p}: {ms:.4f} ms (plain {plain:.2f}, bound "
        f"{b_ms:.4f} by {b_by}; no single PyTorch call computes it); "
        + k4_geometry_note(k4_geometry(1, KV, T, bk), p + 1))
    k4_row = dict(name="flash_decode_attention, folded heads, int8 dots (K4)",
                  route="cuda",
                  source="llama_nuts_and_bolts_tpu_torch/csrc/decode_attention_int8.cu",
                  replaces="llama_nuts_and_bolts_tpu/kernels/decode_attention.py:123",
                  max_abs_err=errs["K4"], ms=ms, plain_ms=plain, bound_ms=b_ms,
                  bound_by=b_by, library_ms=None,
                  shape=f"B=1 L=32 T={T} pos={p} H={H} KV={KV} D={D} int8, tile {bk}")
    rows.append(k4_row)

    # K4's bf16 mode (it launches K2's kernel), beside SDPA
    kb, vb = randn(k.shape, gen), randn(v.shape, gen)
    bf_ms, _ = cuda_ms(cycled(lambda li: flash_decode_attention(
        qd, kb, vb, pos, layer=li, fold_heads=True)), iters=64)
    vis = [(kb[li, :, :, :p + 1].contiguous(), vb[li, :, :, :p + 1].contiguous())
           for li in range(L)]
    qdt = qd.transpose(1, 2)
    library_err(F.scaled_dot_product_attention(qdt, *vis[0], enable_gqa=True).transpose(1, 2),
                flash_decode_attention_plain(qd, kb, vb, pos, 0),
                f"K4 bf16 mode B=1 T={T} pos={p}, SDPA at layer 0")
    lib, _ = cuda_ms(cycled(lambda li: F.scaled_dot_product_attention(
        qdt, vis[li][0], vis[li][1], enable_gqa=True)), iters=64)
    extra["k4_bf16_mode"] = dict(ms=bf_ms, library_ms=lib,
                                 bound_ms=bound_ms(*k2_work([p], T))[0])
    log(f"K4 bf16 mode (K2's kernel) B=1 T={T} pos={p}: {bf_ms:.4f} ms, sdpa {lib:.4f}; "
        f"geometry: split_k {geo.split_k}, {active} of {blocks} blocks pass the early exit")
    del k, v, ks, vs, kb, vb, vis, got, ref
    torch.cuda.empty_cache()
    k4_row["more_shapes"] = [time_k4_at(gen, errs, pos_a, cache_len_a)]

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
        split = k8_split(R, in_dim, out_dim, G)
        kernel_err(k8_last_split_dropped(x, ws[0].packed, ws[0].scale), ref,
                   what + f", the last of {-(-G // split)} splits dropped", planted=True,
                   limits=limits)
        kernel_err(k8_halves_swapped(x, ws[0].packed, ws[0].scale), ref,
                   what + ", x's halves swapped in each group", planted=True, limits=limits)
        ms, _ = cuda_ms(cycled(lambda li: q4_matmul(x, ws[li % len(ws)].packed,
                                                    ws[li % len(ws)].scale)), iters=64)
        plain, _ = cuda_ms(lambda: q4_matmul_plain(x, ws[0].packed, ws[0].scale),
                           iters=1, warmup=1)
        # the library's grouped int4 product and a dense bf16 product at the
        # same shape, each over enough copies of the weight to stay outside L2
        n_copies = max(1, -(-200 * 2**20 // (out_dim * in_dim // 2)))
        lib_w = [tinygemm_pack(w) for w in ws[:n_copies]]
        lib_rel = library_err(torch._weight_int4pack_mm(x, *lib_w[0]), ref,
                              what + ", torch._weight_int4pack_mm (bf16 output)",
                              limit=TINYGEMM_REL_L2)
        lib_ms, _ = cuda_ms(cycled(lambda li: torch._weight_int4pack_mm(
            x, *lib_w[li % len(lib_w)])), iters=64)
        del lib_w
        dense = [unpack_q4(w) for w in ws[:max(1, -(-200 * 2**20 // (out_dim * in_dim * 2)))]]
        mm_ms, _ = cuda_ms(cycled(lambda li: torch.mm(x, dense[li % len(dense)].t())),
                           iters=64)
        del dense
        b_ms, b_by = bound_ms(*k8_work(R, in_dim, out_dim, G, half))
        entry = dict(shape=f"{name} R={R} x [{R},{in_dim}] bf16, packed [{G},{out_dim},"
                           f"{half}], {split} of {G} groups a split",
                     ms=ms, plain_ms=plain, library_ms=lib_ms, library_rel_l2=lib_rel,
                     dense_bf16_mm_ms=mm_ms, bound_ms=b_ms, bound_by=b_by)
        route = ""
        if R > 1:
            # ops/linear.py's route above 32 rows (unpack_q4, then a product
            # with fp32 out), at K8's row counts: another function, since it
            # rounds each weight times its scale to bf16 (read, not judged)
            entry["unpack_mm_rel_l2"] = rel_l2(torch.mm(
                x, unpack_q4(ws[0]).t(), out_dtype=torch.float32), ref)
            entry["unpack_mm_ms"], _ = cuda_ms(cycled(lambda li: torch.mm(
                x, unpack_q4(ws[li % len(ws)]).t(), out_dtype=torch.float32)), iters=32)
            route = (f", unpack_q4 + mm {entry['unpack_mm_ms']:.4f} "
                     f"({entry['unpack_mm_rel_l2']:.2e} relative L2 from K8's function)")
        log(f"{what}: {ms:.4f} ms (split {split}; plain {plain:.2f}, "
            f"torch._weight_int4pack_mm {lib_ms:.4f}, dense bf16 mm {mm_ms:.4f}{route}, "
            f"bound {b_ms:.4f} by {b_by})")
        extra["k8"].append(entry)
        if name == "output" and R == 1:
            head = entry
        del ws
    rows.append(dict(name="q4_matmul (K8)", route="cuda",
                     source="llama_nuts_and_bolts_tpu_torch/csrc/q4_matmul.cu",
                     replaces="llama_nuts_and_bolts_tpu/kernels/q4_matmul.py:36",
                     max_abs_err=errs["K8"], library="torch._weight_int4pack_mm (bf16 out)",
                     more_shapes=[e for e in extra["k8"] if e is not head], **head))
    torch.cuda.empty_cache()
    return rows, extra


def k4_geometry_note(geo, n_keys: int) -> str:
    """K4's launch geometry by the rule (not read from the card), and how
    many ranks hold keys of the row's last tile."""
    active = geo.active_ranks(n_keys, (n_keys - 1) // geo.block_k * geo.block_k)
    return (f"geometry: clusters of {geo.cluster} ({geo.grid[0] * geo.grid[1] * geo.grid[2]} "
            f"blocks), {geo.chunk} keys a rank in copies of {geo.piece} keys at most; "
            f"{active} of {geo.cluster} ranks hold keys of the last tile")


def time_k4_at(gen, errs, p: int, T: int, label: str = "request A's decode"):
    """K4 at one decode step (request A's unless ``label`` says): B=1,
    position ``p`` in a ``T`` cache, as many layers as keep a cycled run
    outside the L2 (the whole tile in one call), against its plain version
    with the last active rank dropped as a planted fault, then timed beside
    its bound."""
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        decode_block_k, flash_decode_attention_int8_mxu_plain, k4_geometry)

    L = -(-200 * 2**20 // (2 * KV * T * (D + 2)))
    k, ks = int8_cache((L, 1, KV, T, D), gen)
    v, vs = int8_cache((L, 1, KV, T, D), gen)
    qd = randn((1, 1, H, D), gen)
    pos = torch.tensor([p], dtype=torch.int32, device="cuda")
    bk = decode_block_k(T, KV, D, True)
    what = f"K4 int8 dots, tile {bk}, B=1 T={T} KV={KV} pos={p} ({label})"
    got = torch.stack([k4_call(qd, k, v, ks, vs, pos, li) for li in range(4)])
    ref = torch.stack([flash_decode_attention_int8_mxu_plain(qd, k, v, ks, vs, pos, li, bk)
                       for li in range(4)])
    errs["K4"] = max(errs["K4"], kernel_err(got, ref, what))
    kernel_err(k4_last_rank_dropped(qd, k, v, ks, vs, pos, 0), ref[0],
               what + ", the last active rank's keys dropped", planted=True)
    state = {"li": 0}

    def call():
        state["li"] = (state["li"] + 1) % L
        return k4_call(qd, k, v, ks, vs, pos, state["li"])
    ms, _ = cuda_ms(call, iters=64)
    plain, _ = cuda_ms(lambda: flash_decode_attention_int8_mxu_plain(
        qd, k, v, ks, vs, pos, 1, bk), iters=2, warmup=1)
    b_ms, b_by = bound_ms(*k34_work([p], T, int8_ops=True))
    geo = k4_geometry(1, KV, T, bk)
    log(f"{what}: {ms:.4f} ms (plain {plain:.2f}, bound {b_ms:.4f} by {b_by}; "
        f"{L} layers cycled); " + k4_geometry_note(geo, p + 1))
    del k, v, ks, vs
    torch.cuda.empty_cache()
    return dict(shape=f"B=1 L={L} T={T} pos={p} H={H} KV={KV} D={D} int8, tile {bk}",
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=float((got - ref).abs().max()), cluster=geo.cluster)


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
    chunked = InferenceEngine(model, InferenceArgs(sequence_length=8192, decode_chunk=8,
                                                   kv_cache_dtype="int8"), device="cuda")
    # C's cache bucket is A's (256): its graphs are captured already
    for key, tokens, max_new, what, captures in (
            ("A", chat, 64, "int4/int8-KV request A (chat, 64 new tokens)", 1),
            ("B", long_prompt, 32, "int4/int8-KV request B (3000-token prompt, 32 new)", 1),
            ("C", short, 32, "int4/int8-KV request C (24-token prompt, 32 new)", 0)):
        results[key] = run_request(engine, tokens, max_new, expect, what,
                                   captures=(1,) * captures)
        results[key + "_chunk8"] = run_request(chunked, tokens, max_new, expect,
                                               what + " at decode_chunk 8",
                                               captures=(8,) * captures)
    results["graphs"] = graph_costs(chunked, "int4/int8-KV, decode_chunk 8")
    del chunked
    if results["C"]["prefill_len"] != 32:
        fail(f"request C's prefill bucket is {results['C']['prefill_len']}, not 32")
    peak = torch.cuda.max_memory_allocated()
    log(f"int4/int8-KV peak device memory: {peak / 2**30:.2f} GiB")
    results["peak_memory_gib"] = peak / 2**30
    results["decode_profile"] = profile_decode(engine, long_prompt)
    results["graphs"] += graph_costs(engine, "int4/int8-KV, auto")
    # K4 at A's shapes: the middle of its 64 decode steps
    rows, extra = time_quant_kernels(params, errs, results["B"]["prompt"],
                                     results["B"]["cache_len"], results["A"]["prompt"] + 32,
                                     results["A"]["cache_len"])
    results["kernels"] = extra
    del engine, model, params
    torch.cuda.empty_cache()

    params = init_random_params_q8(cfg, seed=0, device="cuda")
    model = LoadedModel(params=params, cfg=cfg, vocab=vocab,
                        mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    engine = InferenceEngine(model, InferenceArgs(sequence_length=8192), device="cuda")
    results["int8_weights_A"] = run_request(
        engine, chat, 64, lambda steps, _: {"K1": L, "K2": L * steps},
        "int8-weight request A (chat, 64 new tokens, bf16 cache)", captures=(1,))
    del engine, model, params
    torch.cuda.empty_cache()
    return results, rows


def step_profile(run, steps: int, what: str) -> dict:
    """``run()`` runs ``steps`` decode steps and synchronises. The host clock
    per step without the profiler, then the device time of the kernels
    under torch.profiler: the device's idle share and the kernels that take
    its time, the port's by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()                                                   # warm
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"{what}: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
        f"({1 - device_ms / wall_ms:.1%} idle), "
        f"{sum(e.count for e in kernels) // steps} kernels/step")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{e.count // steps:5d} calls/step  {e.key[:90]}")
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


def profile_decode(engine, prompt, steps: int = 8):
    """Decode steps at request B's shapes, eager beside captured, in the same
    run: the eager step (``engine._forward``, its launches queued back to
    back, one synchronisation per 8 steps), then the captured ones as the
    engine runs them, a one-step graph replayed and its token read each
    step (auto) and an 8-step graph replayed once per 8 steps. For each
    graph also its device time per step by CUDA events, replays queued
    behind a spin."""
    cache_len = engine.cache_bucket(len(prompt), 32)
    logits, cache = engine._prefill(prompt, cache_len)
    tok = int(torch.argmax(logits[0, -1]))
    at = [len(prompt)]

    def eager():
        for i in range(steps):
            engine._forward([[tok]], at[0] + i, cache)
        torch.cuda.synchronize()
        at[0] += steps

    out = {"eager": step_profile(eager, steps, "eager decode step at request B's shapes")}
    del cache
    with engine._lease(1, cache_len) as slot:
        engine._prefill(prompt, cache_len, cache=slot.cache)
        slot.set([tok], [len(prompt)])
        for k in (1, 8):
            graph = engine._decode_chunk(k, cache_len=cache_len, slot=slot)

            def captured():
                for _ in range(steps // k):
                    graph.replay()
                    graph.tokens(graph.fetch())

            out[f"captured_k{k}"] = step_profile(
                captured, steps, f"captured decode step (k = {k}) at request B's shapes")
            ms, _ = cuda_ms(graph.replay, steps // k)
            out[f"captured_k{k}"]["graph_device_ms"] = ms / k
            log(f"  graph of {k} step(s): {ms / k:.3f} ms a step on the device (events)")
    return out


def graph_costs(engine, what: str) -> list:
    """Each decode (or verify) graph ``engine`` captured: its chunk size (or
    drafts) and cache bucket, the host seconds of its warm-up and capture,
    the device memory they reserved, and its slot's cache."""
    rows = []
    for key, graph in engine._chunk_fns.items():
        if graph.graph is None:
            continue
        cache = graph.slot.cache
        cache_mib = sum(t.numel() * t.element_size() for t in (
            cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None) / 2**20
        kind = "verify graph" if key[0] == "verify" else "decode graph"
        bucket = graph.slot.cache_len
        rows.append(dict(path=what, kind=kind, k=graph.k, bucket=bucket,
                         capture_s=graph.capture_s,
                         capture_mib=graph.capture_bytes / 2**20, cache_mib=cache_mib))
        log(f"{kind}, {what}, k = {graph.k}, bucket {bucket}: warm-up and capture "
            f"{graph.capture_s * 1e3:.1f} ms, {graph.capture_bytes / 2**20:.1f} MiB "
            f"reserved; its slot's cache {cache_mib:.1f} MiB")
    return rows


def eager_greedy(engine, prompt, n: int, cache_len: int) -> list:
    """``n`` greedy tokens by the eager per-token path: a prefill, then
    ``engine._forward`` steps (the uncaptured yardstick)."""
    logits, cache = engine._prefill(prompt, cache_len)
    ids = [int(torch.argmax(logits[0, -1]))]
    while len(ids) < n:
        logits, cache = engine._forward([[ids[-1]]], len(prompt) + len(ids) - 1, cache)
        ids.append(int(torch.argmax(logits[0, -1])))
    return ids


def check_captured_deep(engine, prompt, chat, steps: int = 8) -> dict:
    """The 32-layer bf16 model, where attention moves the logits (the
    cyclic model zeroes wo and w_down): at request B's shapes, 8 captured
    steps (a one-step graph replayed 8 times, an 8-step graph replayed
    once) against 8 eager ones (``engine._forward``): the tokens, the cache
    rows written and the last logits, held to the kernel limits (the same
    kernels in the same order: bit-equality expected). A planted fault, the
    positions not advanced between steps, must fail them. Then a seeded
    sampled request through ``generate_tokens``, captured at k = 1 and 8,
    against the eager steps' stream, and the generator state after each."""
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.runtime.decode_graph import DecodeGraph

    class PositionsStuck(DecodeGraph):
        def _advance(self, nxt):                     # the planted fault
            self.slot.feed.copy_(nxt[:, None])

    P = len(prompt)
    cache_len = engine.cache_bucket(P, 32)
    logits, ref_cache = engine._prefill(prompt, cache_len)
    ref = [int(torch.argmax(logits[0, -1]))]
    for i in range(steps):
        logits, _ = engine._forward([[ref[-1]]], P + i, ref_cache)
        ref.append(int(torch.argmax(logits[0, -1])))
    ref_logits = logits[:, -1]
    rows = slice(P, P + steps)
    errs = {}
    for what, k, planted in (("one-step graph x 8", 1, False), ("8-step graph", 8, False),
                             ("8-step graph, positions not advanced", 8, True)):
        with engine._lease(1, cache_len) as slot:
            engine._prefill(prompt, cache_len, cache=slot.cache)
            slot.set([ref[0]], [P])
            graph = (PositionsStuck(engine, slot, k) if planted
                     else engine._decode_chunk(k, cache_len=cache_len, slot=slot))
            got = []
            for _ in range(steps // k):
                graph.replay()
                got += [row[0] for row in graph.tokens(graph.fetch())]
            torch.cuda.synchronize()
            what = f"32-layer bf16, {steps} captured steps ({what}) vs eager"
            if got != ref[1:] and not planted:
                check_failed(f"{what}: tokens {got}, eager {ref[1:]}")
            worst = max(kernel_err(getattr(slot.cache, name)[:, :, :, rows],
                                   getattr(ref_cache, name)[:, :, :, rows],
                                   f"{what}, cache {name} rows", planted=planted)
                        for name in ("k", "v"))
            worst = max(worst, kernel_err(slot.logits, ref_logits, f"{what}, last logits",
                                          planted=planted))
            errs[what] = worst
    del ref_cache

    sampling = dict(sequence_length=8192, temperature=0.8, top_k=50, top_p=0.95, seed=3)
    eager = InferenceEngine(engine.model, InferenceArgs(**sampling), device="cuda")
    logits, cache = eager._prefill(chat, eager.cache_bucket(len(chat), 16))
    want = [eager._select_token(logits[0, 0])]
    while len(want) < 16:
        logits, cache = eager._forward([[want[-1]]], len(chat) + len(want) - 1, cache)
        want.append(eager._select_token(logits[0, -1]))
    del cache
    for k in (1, 8):
        captured = InferenceEngine(engine.model, InferenceArgs(decode_chunk=k, **sampling),
                                   device="cuda")
        got = [t for _, t in captured.generate_tokens(chat, max_new_tokens=16)]
        same_rng = torch.equal(captured._generator.get_state(), eager._generator.get_state())
        log(f"seeded sampled request (T=0.8, top-k 50, top-p 0.95), captured at k = {k}: "
            f"{'equals' if got == want else 'differs from'} the eager stream; generator "
            f"state after it {'equal' if same_rng else 'differs'}")
        if got != want or not same_rng:
            check_failed(f"sampled request at k = {k}: {got} vs eager {want}")
        del captured
    errs["sampled_tokens"] = want
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------- phase 6

BS = 32                          # the paged pool's block size (DEFAULT_BLOCK_SIZE)
# K6/K7/K5 against their plain versions: the kernel limits above. K6 (bf16)
# and K7 follow the Pallas kernels' softmax spans, K5 K2's 64-key tiles, and
# K6's int8 mode the per-block quantization of p, in both versions.
# Flash (K6) against the gather path's logits on 2 full-width layers,
# relative L2 per logits row: the two paths round p at different places, as
# K2 and the dense plain path do (LOGITS_REL_L2's reasoning); K6's int8 mode
# also quantizes q and p. Both limits sit between the sound reading and the
# nearest planted fault's (PERF.md), and every run reads both again.
PAGED_LOGITS_REL_L2 = 3e-2
PAGED_INT8_LOGITS_REL_L2 = 3e-2
# paged_prefill_shared (a prefix-cache hit: only the suffix is projected, the
# prefix's rows are read back from the pool) against paged_prefill of the
# whole prompt, relative L2 of the logits row on 2 layers. The same values
# in both (an int8 pool attends the dequantized rows either way); only the
# matmuls' row counts and the attention's key axis differ, so only the
# summation order. The limit sits between the sound reading and the planted
# fault's (shared_len one block short; PERF.md), and every run reads both.
SHARED_PREFILL_REL_L2 = 1e-2
SERVE_SLOTS, SERVE_BLOCKS, SERVE_CONTEXT = 4, 257, 2048   # 1 + 4 x 64 blocks


def scattered_tables(B: int, M: int, n_blocks: int, seed: int) -> torch.Tensor:
    """Row b's block table: a slice of one seeded permutation of the pool's
    blocks 1..n_blocks-1 (block 0 is trash)."""
    perm = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(seed)) + 1
    return perm[:B * M].reshape(B, M).to(torch.int32).cuda()


def neighbour_tables(tables: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Planted fault: each row's last used table entry read from the next
    row's table."""
    out = tables.clone()
    for b, p in enumerate(positions.tolist()):
        out[b, p // BS] = tables[(b + 1) % tables.shape[0], p // BS]
    return out


def paged_work(positions, int8: bool):
    """Bytes and operations of K6/K7: every visible row of k and v read once
    (int8 rows with their bf16 scales; the rows of the last used block past
    the position are not part of the function), q in and out in bf16; 4 H D
    operations per visible key."""
    rows = sum(p + 1 for p in positions)
    per_row = KV * (D + 2) if int8 else KV * D * 2
    nbytes = 2 * len(positions) * H * D * 2 + 2 * rows * per_row
    ops = 4.0 * H * D * rows
    return nbytes, ops * (BF16_FLOPS_PER_S / INT8_OPS_PER_S if int8 else 1.0)


def last_split_dropped(pos: torch.Tensor, M: int, split: int) -> torch.Tensor:
    """Planted fault: K6/K7 combining every active split but the last (of
    the row at the largest position, by the partition at ``split``
    entries): the sound kernel run with that row's position at its last
    active split's first key - 1."""
    from llama_nuts_and_bolts_tpu_torch.kernels.paged_attention import paged_geometry

    geo = paged_geometry(len(pos), KV, M, BS, pos.tolist(), 1, split)
    b = int(torch.argmax(pos))
    if geo.active_splits[b] < 2:
        fail(f"last_split_dropped: row {b} at {int(pos[b])} has one split of {split}")
    cut = pos.clone()
    cut[b] = (geo.active_splits[b] - 1) * split * BS - 1
    return cut


def split_edge_tables(tables: torch.Tensor, split: int) -> torch.Tensor:
    """Planted fault: each split's first table entry read from the split
    before it (entry s * split from s * split - 1)."""
    out = tables.clone()
    for e in range(split, tables.shape[1], split):
        out[:, e] = tables[:, e - 1]
    return out


def check_paged_kernels():
    """K6 (bf16 and int8 pools), K7 and K5 against their plain versions at
    8B widths and bs 32: B = 1, 4, 8, positions at 0, 31, 32, 2047 and 8191,
    scattered tables up to M = 256 over a 32-layer stacked pool read at
    varying layers; K6 and K7 at paged_split's partition of the table walk
    and at forced splits of 1 and 2 entries. Planted faults, read in every
    run at the rule's split: the mask off by one, the last used block (K5:
    key tile) skipped, a table entry read from the neighbouring row, the
    last active split dropped from the combine, and each split's first
    table entry read from the split before it."""
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        K2_BLOCK_K, flash_decode_attention, flash_decode_attention_plain)
    from llama_nuts_and_bolts_tpu_torch.kernels.paged_attention import (
        paged_chunk, paged_flash_decode, paged_flash_decode_int8_plain,
        paged_flash_decode_plain, paged_split)

    gen = torch.Generator(device="cuda").manual_seed(6)
    errs = {"K5": 0.0, "K6": 0.0, "K6i8": 0.0, "K7": 0.0}
    cases = [(1, 256, 17, [8191]), (4, 64, 0, [0, 31, 32, 2047]),
             (8, 16, 31, [5, 511, 100, 64, 33, 0, 300, 480])]
    for B, M, layer, positions in cases:
        n_blocks, L = B * M + 1, 32
        tables = scattered_tables(B, M, n_blocks, seed=B)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        q = randn((B, 1, H, D), gen)
        rule = paged_split(B, KV, M, BS)
        what = f"B={B} M={M} layer={layer}/{L} pos={positions}"
        faults = {"mask off by one": (tables, pos - 1),
                  "last used block skipped": (tables, pos // BS * BS - 1),
                  f"last active split of {rule} entries dropped":
                      (tables, last_split_dropped(pos, M, rule)),
                  f"each split's first entry from the split before ({rule} entries)":
                      (split_edge_tables(tables, rule), pos)}
        if B > 1:
            faults["neighbour row's table entry"] = (neighbour_tables(tables, pos), pos)
        k, v = randn((L, n_blocks, KV, BS, D), gen), randn((L, n_blocks, KV, BS, D), gen)
        chunk = paged_chunk(M, BS)
        for split in (rule, 1, 2):
            got = paged_flash_decode(q, k, v, tables, pos, layer=layer, split=split)
            torch.cuda.synchronize()
            ref = paged_flash_decode_plain(q, k, v, tables, pos, layer, chunk, split=split)
            errs["K6"] = max(errs["K6"], kernel_err(
                got, ref, f"K6 bf16 (span {chunk}, split {split}) " + what))
            if split == rule:
                for name, (tbl, p) in faults.items():
                    kernel_err(paged_flash_decode(q, k, v, tbl, p, layer=layer), ref,
                               f"K6 bf16 {what}, {name}", planted=True)
        # K7: the same layer as a single-layer pool, one update per block
        for split in (rule, 1, 2):
            got = paged_flash_decode(q, k[layer], v[layer], tables, pos, fold_heads=False,
                                     split=split)
            torch.cuda.synchronize()
            ref = paged_flash_decode_plain(q, k[layer:layer + 1], v[layer:layer + 1], tables,
                                           pos, 0, 1, split=split)
            errs["K7"] = max(errs["K7"], kernel_err(got, ref, f"K7 (split {split}) " + what))
            if split == rule:
                for name, (tbl, p) in faults.items():
                    kernel_err(paged_flash_decode(q, k[layer], v[layer], tbl, p,
                                                  fold_heads=False),
                               ref, f"K7 {what}, {name}", planted=True)
        del k, v
        (k, ks), (v, vs) = (int8_cache((L, n_blocks, KV, BS, D), gen) for _ in range(2))
        for split in (rule, 1, 2):
            got = paged_flash_decode(q, k, v, tables, pos, layer=layer, pool_ks=ks,
                                     pool_vs=vs, split=split)
            torch.cuda.synchronize()
            ref = paged_flash_decode_int8_plain(q, k, v, ks, vs, tables, pos, layer,
                                                split=split)
            errs["K6i8"] = max(errs["K6i8"], kernel_err(
                got, ref, f"K6 int8 (split {split}) " + what))
            if split == rule:
                for name, (tbl, p) in faults.items():
                    kernel_err(paged_flash_decode(q, k, v, tbl, p, layer=layer, pool_ks=ks,
                                                  pool_vs=vs), ref,
                               f"K6 int8 {what}, {name}", planted=True)
        del k, v, ks, vs

        # K5: blocked=False over a single-layer [B, KV, T, D] cache
        T = {1: 8192, 4: 2048, 8: 1024}[B]
        for int8 in (False, True):
            if int8:
                (kc, kcs), (vc, vcs) = (int8_cache((B, KV, T, D), gen) for _ in range(2))
                kw = dict(k_scale=kcs, v_scale=vcs)
                ref = flash_decode_attention_plain(q, kc[None], vc[None], pos, 0,
                                                   kcs[None], vcs[None])
            else:
                kc, vc = randn((B, KV, T, D), gen), randn((B, KV, T, D), gen)
                kw = {}
                ref = flash_decode_attention_plain(q, kc[None], vc[None], pos, 0)
            got = flash_decode_attention(q, kc, vc, pos, blocked=False, **kw)
            torch.cuda.synchronize()
            w5 = f"K5 {'int8' if int8 else 'bf16'} B={B} T={T} pos={positions}"
            errs["K5"] = max(errs["K5"], kernel_err(got, ref, w5))
            for name, p in (("mask off by one", pos - 1),
                            ("last key tile skipped", pos // K2_BLOCK_K * K2_BLOCK_K - 1)):
                kernel_err(flash_decode_attention(q, kc, vc, p, blocked=False, **kw), ref,
                           f"{w5}, {name}", planted=True)
            del kc, vc
    torch.cuda.empty_cache()
    return errs


@contextlib.contextmanager
def planted_paged_fault(fault):
    """``paged_decode_step``'s K6 call (``tp_paged_flash_decode``, no mesh
    here) swapped for a planted fault with ``paged_flash_decode``'s
    arguments."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import paged as mod

    saved = mod.tp_paged_flash_decode
    mod.tp_paged_flash_decode = lambda mesh, *args, **kw: fault(*args, **kw)
    try:
        yield
    finally:
        mod.tp_paged_flash_decode = saved


def shared_prefill_err(params, cfg, pool, prompt, table, spare, ref, kind: str) -> float:
    """A prefix-cache hit at full width: ``paged_prefill_shared`` of
    ``prompt`` over the first two blocks that ``paged_prefill`` wrote into
    ``table``, its suffix written into ``spare``'s blocks of a copy of the
    pool, against the full prefill's logits ``ref``; planted fault:
    ``shared_len`` one block short."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import paged

    n, shared = prompt.shape[1], 2 * BS
    row = torch.cat([table[:2], spare[2:]])
    suffix = torch.zeros((1, -(-(n - shared) // BS) * BS), dtype=torch.int32, device="cuda")
    suffix[0, :n - shared] = prompt[0, shared:]

    def run(shared_len):
        work = paged.PagedKVPool(*(t.clone() for t in pool.buffers()))
        return paged.paged_prefill_shared(params, cfg, suffix, shared_len, n - shared - 1,
                                          work, row)[0]

    what = f"2-layer paged {kind} prefill of {n} tokens, {shared} shared, vs the full prefill"
    rel = logits_err(run(shared), ref, SHARED_PREFILL_REL_L2, what)
    logits_err(run(shared - BS), ref, SHARED_PREFILL_REL_L2,
               f"{what}, shared_len one block short", planted=True)
    return rel


def check_paged_model_path(tk, vocab):
    """Two full-width layers over a paged pool: two requests (100 and 37
    tokens) prefilled into scattered blocks, the first again as a
    prefix-cache hit (suffix only, over its first two blocks) against its
    full prefill's logits, then 4 batched decode steps with
    K6 against the gather path on the same weights and the plain path's
    greedy tokens, for a bf16 and an int8 pool; planted K6 faults read
    against the same limits. Then exact greedy tokens on the cyclic model:
    the paged batcher (K6) and the dense batcher (K2, per-row positions)
    against the sequential engine."""
    from llama_nuts_and_bolts_tpu_torch.kernels.paged_attention import paged_flash_decode
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel, init_random_params
    from llama_nuts_and_bolts_tpu_torch.models.llama import paged
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.runtime.continuous import ContinuousBatcher
    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher

    cfg = cfg_8b(2)
    params = init_random_params(cfg, seed=2, device="cuda")       # split layout
    gen = torch.Generator(device="cuda").manual_seed(3)
    lens = (100, 37)
    M = 256 // BS
    n_blocks = 3 * M + 1
    tables = scattered_tables(3, M, n_blocks, seed=5)
    tables, spare = tables[:2], tables[2]          # spare: the cache hit's own blocks
    prompts = [torch.randint(0, 128000, (1, n), device="cuda", generator=gen) for n in lens]
    faults = {
        "K6 mask off by one": lambda q, k, v, t, p, **kw: paged_flash_decode(q, k, v, t, p - 1,
                                                                             **kw),
        "K6 last used block skipped": lambda q, k, v, t, p, **kw: paged_flash_decode(
            q, k, v, t, p // BS * BS - 1, **kw),
        # the rows' 4 and 2 used entries cut into splits of 2
        "K6 last active split dropped (splits of 2 entries)":
            lambda q, k, v, t, p, **kw: paged_flash_decode(
                q, k, v, t, last_split_dropped(p, t.shape[1], 2), split=2, **kw),
        "K6 each split's first entry from the split before (splits of 2 entries)":
            lambda q, k, v, t, p, **kw: paged_flash_decode(
                q, k, v, split_edge_tables(t, 2), p, split=2, **kw)}
    readings = {}
    for int8, limit in ((False, PAGED_LOGITS_REL_L2), (True, PAGED_INT8_LOGITS_REL_L2)):
        pool = paged.PagedKVPool.create(cfg, n_blocks, BS, torch.int8 if int8 else
                                        torch.bfloat16, device="cuda")
        full = []
        for b, (tok, n) in enumerate(zip(prompts, lens)):
            padded = torch.zeros((1, -(-n // BS) * BS), dtype=torch.int32, device="cuda")
            padded[0, :n] = tok[0]
            full.append(paged.paged_prefill(params, cfg, padded, n - 1, pool, tables[b])[0])
        kind = "int8" if int8 else "bf16"
        readings[f"{kind} shared prefill"] = shared_prefill_err(
            params, cfg, pool, prompts[0], tables[0], spare, full[0], kind)

        def run(impl, feed, fault=None):
            work = paged.PagedKVPool(*(t.clone() for t in pool.buffers()))
            out, toks = [], torch.tensor([[7], [9]], dtype=torch.int32, device="cuda")
            with (planted_paged_fault(fault) if fault else contextlib.nullcontext()):
                for step in range(4):
                    if feed is not None:
                        toks = feed[step]
                    positions = torch.tensor([n + step for n in lens], dtype=torch.int32,
                                             device="cuda")
                    logits, _ = paged.paged_decode_step(params, cfg, toks, positions, work,
                                                        tables, impl)
                    out.append(logits)
                    toks = torch.argmax(logits, -1).to(torch.int32)[:, None]
            return out

        plain = run("plain", None)
        feed = [torch.tensor([[7], [9]], dtype=torch.int32, device="cuda")] + [
            torch.argmax(lg, -1).to(torch.int32)[:, None] for lg in plain[:-1]]
        reset_counts()
        flash = run("flash", feed)
        counts = read_counts()
        want = {"K6i8" if int8 else "K6": 4 * cfg.n_layers}
        if {k: n for k, n in counts.items() if n} != want:
            check_failed(f"2-layer paged {kind} decode launched {counts}, expected {want}")
        readings[kind] = [logits_err(got, ref, limit, f"2-layer paged {kind} decode step "
                                     f"{step} logits, K6 vs gather")
                          for step, (got, ref) in enumerate(zip(flash, plain))]
        for name, fault in faults.items():
            for step, (got, ref) in enumerate(zip(run("flash", feed, fault), plain)):
                logits_err(got, ref, limit, f"2-layer paged {kind} decode step {step} "
                           f"logits, {name}", planted=True)
        del pool

    cycle = 8
    model = LoadedModel(params=cyclic_params(params, cycle), cfg=cfg, vocab=vocab,
                        mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    engine = InferenceEngine(model, InferenceArgs(sequence_length=512), device="cuda")
    requests = [(list(range(cycle)) * 3, 40), ([3, 4, 5], 24), (list(range(cycle)) * 9, 33),
                ([6, 7], 12)]
    expect = [[(p[-1] + 1 + i) % cycle for i in range(n)] for p, n in requests]
    seq = [[t for _, t in engine.generate_tokens(p, max_new_tokens=n)] for p, n in requests]
    if seq != expect:
        fail(f"cyclic model, sequential engine: {seq}, expected {expect}")
    for name, batcher, tag in (
            ("paged batcher", PagedBatcher(engine, n_slots=2, n_blocks=33), "K6"),
            ("dense batcher", ContinuousBatcher(engine, n_slots=2), "K2")):
        reset_counts()
        reqs = [batcher.submit(p, max_new_tokens=n) for p, n in requests]
        batcher.run_until_idle()
        torch.cuda.synchronize()
        got = [[t for _, t in r.tokens(timeout=60)] for r in reqs]
        counts = read_counts()
        if got != seq:
            fail(f"cyclic model, {name}: {got}, sequential engine {seq}")
        if counts[tag] != cfg.n_layers * batcher.decode_steps:
            check_failed(f"cyclic model, {name}: {counts}, expected {tag} = "
                         f"{cfg.n_layers} x {batcher.decode_steps} steps")
        log(f"cyclic 2-layer model, {name}: {len(reqs)} requests on 2 slots, tokens equal "
            f"the sequential engine's; {batcher.decode_steps} steps, launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        del batcher
    del params, model, engine
    torch.cuda.empty_cache()
    return readings


def sse_request(url, body, stream):
    """One POST; returns (status, text, seconds to the first non-empty chunk
    or to the whole response, seconds to the end, and the completion tokens,
    or for a stream its chunks)."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not stream:
            out = json.loads(resp.read())
            t = time.perf_counter() - t0
            choice = out["choices"][0]
            text = choice["message"]["content"] if "message" in choice else choice["text"]
            return resp.status, text, t, t, out["usage"]["completion_tokens"]
        text, t_first, n_chunks = "", None, 0
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            choice = json.loads(line[6:])["choices"][0]
            piece = choice["delta"]["content"] if "delta" in choice else choice["text"]
            if t_first is None and piece:
                t_first = time.perf_counter() - t0
            text += piece
            n_chunks += 1
        return resp.status, text, t_first, time.perf_counter() - t0, n_chunks


LONG_LOG = " ".join(
    f"At {h // 2:02d}:{h % 2 * 30:02d} the ship held course two-seven-zero at twelve knots, "
    f"wind north-west force {h % 9 + 1}, swell {h % 4 + 2} metres; deck cargo lashed and dry."
    for h in range(24))
LONG_PROMPT_TOKENS = (1536, SERVE_CONTEXT - 64)   # > 3 of K6's 512-key spans; + 64 new


def serving_requests(int8: bool):
    """The served traffic: greedy chat streamed and blocking on one prompt,
    two chats that share a system prompt of more than two blocks, one seeded
    sampled completion sent twice, a long chat (a watch log of ~1,850 tokens,
    64 new: K6 walks four 512-key spans and the request grows blocks near
    the context's end), and more requests than slots. Chat A's
    prompt fits in one block, so neither copy can revive the other's blocks:
    both prefill alike whichever is admitted first, and a random model's
    near-tied greedy tokens cannot part on a prefix-cache hit's suffix-only
    prefill (another summation order)."""
    ship = ("You are the navigator of a cargo ship crossing the North Atlantic in "
            "winter. Answer every question with the ship's position, the weather, the "
            "state of the sea and the cargo, in plain sentences, and end with the watch. ")

    def chat(system, user, **kw):
        messages = [{"role": "system", "content": system}] if system else []
        return "/v1/chat/completions", {
            "messages": messages + [{"role": "user", "content": user}], "max_tokens": 48,
            **kw}

    done = {"prompt": "The quick brown fox", "max_tokens": 48, "temperature": 0.8,
            "top_p": 0.95, "seed": 1234}
    reqs = [("chat A, stream", *chat(None, "Where are we?", stream=True), True),
            ("chat A, blocking", *chat(None, "Where are we?"), False),
            ("chat B, shared system prompt", *chat(ship, "How is the cargo?",
                                                    stream=True), True),
            ("chat B2, shared system prompt", *chat(ship, "What is the weather?",
                                                     stream=True), True),
            ("sampled, seed 1234 (1)", "/v1/completions", dict(done, stream=True), True),
            ("sampled, seed 1234 (2)", "/v1/completions", dict(done, stream=True), True),
            ("long chat, watch log", *chat(None, LONG_LOG + " Summarise the watch.",
                                           max_tokens=64, stream=True), True)]
    if not int8:
        reqs += [("chat C", *chat("You are a terse assistant.", "Name three rivers.",
                                  stream=True), True),
                 ("completion D", "/v1/completions", {"prompt": "Once upon a time",
                                                      "max_tokens": 64, "stream": True},
                  True),
                 ("completion E, logprobs", "/v1/completions",
                  {"prompt": "The capital of France is", "max_tokens": 32,
                   "logprobs": 2}, False)]
    return reqs


class AllocatorClock:
    """The paged batcher's host allocator under a clock: the host time of
    every call into it (and of the prefix hashing) from ``start()`` on, and
    the op stream from the batcher's start, which ``replay_ms`` runs again
    on a fresh allocator of either backend."""

    OPS = ("alloc", "release", "free", "lookup", "register")

    def __init__(self, batcher):
        from llama_nuts_and_bolts_tpu_torch.runtime import paged as mod

        self.mod, self.alloc = mod, batcher.allocator
        self.n_blocks, self.bs = batcher.allocator.n_blocks, batcher.block_size
        self.ops, self.seconds, self.calls, self.hash_seconds = [], 0.0, 0, 0.0
        for name in self.OPS:
            setattr(self.alloc, name, self._timed(name, getattr(self.alloc, name)))
        self.hashes = mod.chain_block_hashes
        mod.chain_block_hashes = self._hash

    def _timed(self, name, fn):
        def call(*args):
            args = tuple(list(a) if isinstance(a, list) else a for a in args)
            t0 = time.perf_counter()
            out = fn(*args)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.ops.append((name, args, out))
            return out
        return call

    def _hash(self, *args):
        t0 = time.perf_counter()
        out = self.hashes(*args)
        self.hash_seconds += time.perf_counter() - t0
        return out

    def start(self):
        self.seconds, self.calls, self.hash_seconds = 0.0, 0, 0.0

    def stop(self):
        for name in self.OPS:
            delattr(self.alloc, name)
        self.mod.chain_block_hashes = self.hashes

    def replay_ms(self, backend: str) -> float:
        """The recorded op stream on a fresh allocator; fails if any call
        returns another result than it did in the served run."""
        from llama_nuts_and_bolts_tpu_torch.runtime.block_pool import PrefixBlockAllocator

        fresh = PrefixBlockAllocator(self.n_blocks, self.bs, backend=backend)
        ops = list(self.ops)
        calls = [(getattr(fresh, name), args) for name, args, _ in ops]
        t0 = time.perf_counter()
        outs = [fn(*args) for fn, args in calls]
        ms = (time.perf_counter() - t0) * 1e3
        if outs != [out for *_, out in ops]:
            fail(f"the served run's allocator op stream replays differently on {backend}")
        return ms


def profile_batched_step(batcher, steps: int = 8):
    """Batched decode steps of the paged batcher with every slot busy: the
    host clock per step without the profiler, then the device time under
    torch.profiler -- the device's idle share and the kernels taking its
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompt = list(range(100, 100 + 3 * BS))
    reqs = [batcher.submit(prompt, max_new_tokens=4 * steps + 4) for _ in range(batcher.n_slots)]
    batcher.step()                                         # admit every slot
    batcher.step()

    def run():
        for _ in range(steps):
            batcher.step()
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    positions = batcher._pos.copy()
    tables = batcher.tables.copy()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    for r in reqs:
        r.cancel()
    batcher.run_until_idle()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    ours = {name: sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3 / steps
            for name in ("paged_split_kernel",)}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    log(f"batched decode step ({batcher.n_slots} slots, positions {positions.tolist()}): "
        f"wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
        f"({1 - device_ms / wall_ms:.1%} idle), "
        f"{sum(e.count for e in kernels) // steps} kernels/step, K6 "
        f"{max(ours.values()):.3f} ms/step")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{e.count // steps:5d} calls/step  {e.key[:90]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, k6_ms=max(ours.values()),
                kernels_per_step=sum(e.count for e in kernels) // steps,
                top=[(e.key[:90], e.self_device_time_total / 1e3 / steps) for e in top]), \
        torch.from_numpy(positions[:batcher.n_slots].copy()).cuda(), \
        torch.from_numpy(tables).cuda()


def serving_path(tk, vocab, int8: bool):
    """The serving path at full width: Llama-3.1-8B, 32 layers, bf16 split
    weights from seed 0, context 2048, 4 slots over a paged pool of 257
    blocks (bf16, or int8 with attn_impl "flash": K6's int8 mode), through
    LlamaHTTPServer.start_background on an ephemeral port, with the requests
    of ``serving_requests`` sent from threads at once. Every launch count is
    set to 0 after the warm-up request and read after the traffic."""
    from concurrent.futures import ThreadPoolExecutor

    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel, init_random_params
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.serving.server import LlamaHTTPServer

    kind = "int8 pool" if int8 else "bf16 pool"
    cfg = cfg_8b(32)
    t0 = time.perf_counter()
    params = init_random_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"8B random init (split layout): {time.perf_counter() - t0:.1f}s")
    model = LoadedModel(params=params, cfg=cfg, vocab=vocab,
                        mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    engine = InferenceEngine(model, InferenceArgs(
        sequence_length=SERVE_CONTEXT, kv_cache_dtype="int8" if int8 else "bf16",
        attn_impl="flash" if int8 else "auto"), device="cuda")
    srv = LlamaHTTPServer(engine, continuous_slots=SERVE_SLOTS, paged_blocks=SERVE_BLOCKS)
    batcher = srv.batcher
    clock = AllocatorClock(batcher)
    if batcher.attn_impl != "flash":
        fail(f"serving, {kind}: the paged batcher chose {batcher.attn_impl!r}, not K6")
    log(f"serving, {kind}: pool {SERVE_BLOCKS} blocks of {BS}, "
        f"{sum(t.numel() * t.element_size() for t in batcher.pool.buffers()) / 2**30:.2f} "
        f"GiB; prewarm {srv.prewarm():.1f}s")
    url = f"http://127.0.0.1:{srv.start_background()}"
    reqs = serving_requests(int8)
    chat_a = len(srv._tokens_for_chat(reqs[0][2]["messages"]))
    if chat_a > BS:
        fail(f"serving, {kind}: chat A's prompt is {chat_a} tokens, more than one block")
    long_len = len(srv._tokens_for_chat(
        next(body for name, _, body, _ in reqs if name.startswith("long"))["messages"]))
    if not LONG_PROMPT_TOKENS[0] <= long_len <= LONG_PROMPT_TOKENS[1]:
        fail(f"serving, {kind}: the long chat's prompt is {long_len} tokens, outside "
             f"{LONG_PROMPT_TOKENS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock.start()
    reset_counts()
    steps0 = batcher.decode_steps
    tokens0 = srv.metrics["tokens_generated_total"]
    t_start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(reqs)) as pool:
        futures = [pool.submit(sse_request, url + path, body, stream)
                   for _, path, body, stream in reqs]
        results = [f.result() for f in futures]
    wall = time.perf_counter() - t_start
    torch.cuda.synchronize()
    counts = read_counts()
    clock.stop()
    steps = batcher.decode_steps - steps0
    peak = torch.cuda.max_memory_allocated()
    metrics = srv.render_metrics()
    hits = float(next(line.split()[1] for line in metrics.splitlines()
                      if line.startswith("llama_prefix_cache_hits_total ")))
    out = {"requests": {}, "decode_steps": steps, "wall_s": wall,
           "peak_memory_gib": peak / 2**30, "prefix_hits": hits, "launches": counts}
    tokens = srv.metrics["tokens_generated_total"] - tokens0
    for (name, _, _, stream), (status, text, t_first, t_end, n) in zip(reqs, results):
        out["requests"][name] = dict(status=status, ttft_ms=t_first * 1e3,
                                     end_ms=t_end * 1e3, tokens_or_chunks=n)
        log(f"serving, {kind}, {name}: status {status}, {n} {'chunks' if stream else 'tokens'}, "
            f"{'TTFT' if stream else 'response'} {t_first * 1e3:.1f} ms, end "
            f"{t_end * 1e3:.1f} ms; text[:50]={text[:50]!r}")
        if status != 200 or not text:
            fail(f"serving, {kind}, {name}: status {status}, text {text!r}")
    out["aggregate_tok_s"] = tokens / wall
    texts = {name: res[1] for (name, *_), res in zip(reqs, results)}
    if texts["chat A, stream"] != texts["chat A, blocking"]:
        fail(f"serving, {kind}: streamed {texts['chat A, stream']!r} != blocking "
             f"{texts['chat A, blocking']!r}")
    if texts["sampled, seed 1234 (1)"] != texts["sampled, seed 1234 (2)"]:
        fail(f"serving, {kind}: the seeded sampled request changed its text")
    if hits < 1:
        fail(f"serving, {kind}: /metrics shows {hits} prefix-cache hits")
    tag = "K6i8" if int8 else "K6"
    want = {tag: cfg.n_layers * steps}
    if {k: n for k, n in counts.items() if n} != want:
        check_failed(f"serving, {kind}: launches {counts} over {steps} batched decode "
                     f"steps, expected {want}")
    log(f"serving, {kind}: {len(reqs)} requests on {SERVE_SLOTS} slots in {wall:.2f}s, "
        f"{tokens} tokens, aggregate {tokens / wall:.2f} tok/s, {steps} batched decode "
        f"steps, launches { {k: n for k, n in counts.items() if n} } "
        f"({cfg.n_layers} x {steps}), prefix-cache hits {hits:.0f}, peak device memory "
        f"{peak / 2**30:.2f} GiB; the long chat's prompt {long_len} tokens")
    from llama_nuts_and_bolts_tpu_torch.runtime.block_pool import native_available

    replay = {b: clock.replay_ms(b) for b in ("python", "native")
              if b == "python" or native_available()}
    out["allocator"] = dict(backend=batcher.allocator.backend, calls=clock.calls,
                            ms=clock.seconds * 1e3, hash_ms=clock.hash_seconds * 1e3,
                            share_of_wall=(clock.seconds + clock.hash_seconds) / wall,
                            ops_recorded=len(clock.ops), replay_ms=replay)
    log(f"serving, {kind}: allocator ({batcher.allocator.backend}) {clock.calls} calls, "
        f"{clock.seconds * 1e3:.3f} ms, prefix hashing {clock.hash_seconds * 1e3:.3f} ms: "
        f"{out['allocator']['share_of_wall']:.3%} of the traffic's wall; the "
        f"{len(clock.ops)} calls since the batcher's start replayed on a fresh allocator: "
        + ", ".join(f"{b} {ms:.3f} ms" for b, ms in replay.items()))
    srv.shutdown()
    out["profile"], positions, tables = profile_batched_step(batcher)
    rows = time_paged_kernels(batcher.pool, tables, positions, int8)
    del srv, batcher, engine, model, params
    torch.cuda.empty_cache()
    return out, rows


def time_paged_kernels(pool, tables, positions, int8: bool):
    """K6 (or its int8 mode) on the serving run's own pool, tables and
    positions, cycling the 32 layers so that each launch reads from outside
    L2; for a bf16 pool also K7 on the single-layer views and K5 on dense
    single-layer caches of the context's length at the same positions. Each
    beside its plain version, its bound and, for K6/K7, the gather path's
    time (the plain decode attention, not one library call)."""
    import torch.nn.functional as F

    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        flash_decode_attention, flash_decode_attention_plain)
    from llama_nuts_and_bolts_tpu_torch.kernels.paged_attention import (
        paged_chunk, paged_flash_decode, paged_flash_decode_int8_plain,
        paged_flash_decode_plain)
    from llama_nuts_and_bolts_tpu_torch.models.llama.paged import _gathered_attention

    gen = torch.Generator(device="cuda").manual_seed(9)
    B, M = tables.shape
    L = pool.k.shape[0]
    q = randn((B, 1, H, D), gen)
    state = {"li": 0}

    def cycled(fn):
        def call():
            state["li"] = (state["li"] + 1) % L
            return fn(state["li"])
        return call

    shape = (f"B={B} L={L} n_blocks={pool.k.shape[1]} M={M} bs={BS} "
             f"pos={positions.tolist()} H={H} KV={KV} D={D}")
    pos_list = positions.tolist()
    rows = []
    scales = dict(pool_ks=pool.k_scale, pool_vs=pool.v_scale) if int8 else {}
    # K6 with every row at the context's last position, over a scattered
    # permutation of all B x M blocks: the pool full, as under long traffic
    full_tables = scattered_tables(B, M, pool.k.shape[1], seed=11)
    full_pos = torch.full((B,), M * BS - 1, dtype=torch.int32, device="cuda")
    full_ms, _ = cuda_ms(cycled(lambda li: paged_flash_decode(
        q, pool.k, pool.v, full_tables, full_pos, layer=li, **scales)), iters=64)
    full_bound = bound_ms(*paged_work(full_pos.tolist(), int8))[0]
    log(f"K6 {'int8' if int8 else 'bf16'}, every row at position {M * BS - 1}: "
        f"{full_ms:.4f} ms (bound {full_bound:.4f} by bytes)")
    full = dict(ms_full_context=full_ms, bound_ms_full_context=full_bound)
    # K6 at B = 1 with the row at position 1850 (the long chat's), over a
    # scattered table: the split walk's case (one row, 8 KV heads)
    long_tables = scattered_tables(1, M, pool.k.shape[1], seed=12)
    long_pos = torch.tensor([1850], dtype=torch.int32, device="cuda")
    q1 = randn((1, 1, H, D), gen)
    kv_scales = (pool.k_scale, pool.v_scale) if int8 else ()
    long_ms, got = cuda_ms(cycled(lambda li: paged_flash_decode(
        q1, pool.k, pool.v, long_tables, long_pos, layer=li, **scales)), iters=64)
    li = state["li"]
    ref = (paged_flash_decode_int8_plain(q1, pool.k, pool.v, *kv_scales, long_tables,
                                         long_pos, li) if int8 else
           paged_flash_decode_plain(q1, pool.k, pool.v, long_tables, long_pos, li,
                                    paged_chunk(M, BS)))
    kernel_err(got, ref, f"K6 {'int8' if int8 else 'bf16'} B=1 pos=[1850] layer {li}")
    long_gather, _ = cuda_ms(cycled(lambda li: _gathered_attention(
        q1, pool.k[li], pool.v[li], long_tables, long_pos,
        *(t[li] for t in kv_scales))), iters=16)
    long_bound = bound_ms(*paged_work([1850], int8))[0]
    log(f"K6 {'int8' if int8 else 'bf16'}, B=1 at position 1850: {long_ms:.4f} ms "
        f"(gather path {long_gather:.4f}, bound {long_bound:.4f} by bytes)")
    full.update(ms_b1_pos1850=long_ms, bound_ms_b1_pos1850=long_bound,
                gather_path_ms_b1_pos1850=long_gather)
    if int8:
        ms, got = cuda_ms(cycled(lambda li: paged_flash_decode(
            q, pool.k, pool.v, tables, positions, layer=li, **scales)), iters=64)
        plain, _ = cuda_ms(lambda: paged_flash_decode_int8_plain(
            q, pool.k, pool.v, pool.k_scale, pool.v_scale, tables, positions, 0),
            iters=1, warmup=1)
        gather, _ = cuda_ms(cycled(lambda li: _gathered_attention(
            q, pool.k[li], pool.v[li], tables, positions, pool.k_scale[li],
            pool.v_scale[li])), iters=16)
        b_ms, b_by = bound_ms(*paged_work(pos_list, int8=True))
        log(f"K6 int8 {shape}: {ms:.4f} ms (plain {plain:.2f}, gather path {gather:.4f}, "
            f"bound {b_ms:.4f} by {b_by})")
        rows.append(dict(tag="K6i8", name="paged_flash_decode, int8 pool (K6)", route="cuda",
                         source="llama_nuts_and_bolts_tpu_torch/csrc/paged_attention.cu",
                         replaces="llama_nuts_and_bolts_tpu/kernels/paged_attention.py:89",
                         ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, gather_path_ms=gather, shape=shape + " int8",
                         **full))
        return rows

    chunk = paged_chunk(M, BS)
    ms, _ = cuda_ms(cycled(lambda li: paged_flash_decode(q, pool.k, pool.v, tables,
                                                         positions, layer=li)), iters=64)
    plain, _ = cuda_ms(lambda: paged_flash_decode_plain(q, pool.k, pool.v, tables, positions,
                                                        0, chunk), iters=1, warmup=1)
    gather, _ = cuda_ms(cycled(lambda li: _gathered_attention(
        q, pool.k[li], pool.v[li], tables, positions)), iters=16)
    b_ms, b_by = bound_ms(*paged_work(pos_list, int8=False))
    log(f"K6 bf16 {shape}: {ms:.4f} ms (plain {plain:.2f}, gather path {gather:.4f}, "
        f"bound {b_ms:.4f} by {b_by})")
    rows.append(dict(tag="K6", name="paged_flash_decode (K6)", route="cuda",
                     source="llama_nuts_and_bolts_tpu_torch/csrc/paged_attention.cu",
                     replaces="llama_nuts_and_bolts_tpu/kernels/paged_attention.py:89",
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     gather_path_ms=gather, shape=shape, **full))
    ms, _ = cuda_ms(cycled(lambda li: paged_flash_decode(q, pool.k[li], pool.v[li], tables,
                                                         positions, fold_heads=False)),
                    iters=64)
    plain, _ = cuda_ms(lambda: paged_flash_decode_plain(q, pool.k[:1], pool.v[:1], tables,
                                                        positions, 0, 1), iters=1, warmup=1)
    log(f"K7 {shape}, single-layer views: {ms:.4f} ms (plain {plain:.2f}, gather path "
        f"{gather:.4f}, bound {b_ms:.4f} by {b_by})")
    rows.append(dict(tag="K7", name="paged_flash_decode, fold_heads=False (K7)",
                     route="cuda",
                     source="llama_nuts_and_bolts_tpu_torch/csrc/paged_attention.cu",
                     replaces="llama_nuts_and_bolts_tpu/kernels/paged_attention.py:44",
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     gather_path_ms=gather, shape=shape + " single-layer"))

    # K5 on dense single-layer caches of the context's length, 32 of them
    T = SERVE_CONTEXT
    kc, vc = randn((L, B, KV, T, D), gen), randn((L, B, KV, T, D), gen)
    ms, _ = cuda_ms(cycled(lambda li: flash_decode_attention(q, kc[li], vc[li], positions,
                                                             blocked=False)), iters=64)
    plain, _ = cuda_ms(lambda: flash_decode_attention_plain(q, kc[:1], vc[:1], positions, 0),
                       iters=1, warmup=1)
    visible = torch.arange(T, device="cuda")[None, None, None, :] <= \
        positions.long()[:, None, None, None]
    qt = q.transpose(1, 2)
    lib, lib_out = cuda_ms(cycled(lambda li: F.scaled_dot_product_attention(
        qt, kc[li], vc[li], attn_mask=visible, enable_gqa=True)), iters=64)
    library_err(lib_out.transpose(1, 2), flash_decode_attention_plain(
        q, kc[state["li"]:state["li"] + 1], vc[state["li"]:state["li"] + 1], positions, 0),
        f"K5 B={B} T={T} pos={pos_list}, SDPA")
    b_ms, b_by = bound_ms(*k2_work(pos_list, T))
    log(f"K5 B={B} T={T} pos={pos_list}: {ms:.4f} ms (plain {plain:.2f}, sdpa {lib:.4f}, "
        f"bound {b_ms:.4f} by {b_by})")
    rows.append(dict(tag="K5", name="flash_decode_attention, blocked=False (K5)",
                     route="cuda", source="llama_nuts_and_bolts_tpu_torch/csrc/decode_attention.cu",
                     replaces="llama_nuts_and_bolts_tpu/kernels/decode_attention.py:205",
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                     shape=f"B={B} single-layer T={T} pos={pos_list} H={H} KV={KV} D={D}"))
    del kc, vc
    return rows


# ---------------------------------------------------------------- phase 10-13

SPEC_K = 4                       # drafts a verify step checks
SPEC_CYCLE = 8                   # the cyclic models walk 0 -> 1 -> ... -> 7 -> 0
SPEC_CONTEXT = 8192              # the speculative path keeps the full-context cache


def cfg_1b(n_layers: int):
    """Meta Llama-3.2-1B params.json (the usual draft of Llama-3.1-8B), depth
    cut to n_layers: head_dim 64, which no port kernel takes."""
    from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs

    return ModelArgs(dim=2048, n_layers=n_layers, n_heads=32, n_kv_heads=8,
                     vocab_size=128256, multiple_of=256, ffn_dim_multiplier=1.5,
                     norm_eps=1e-5, rope_theta=500000.0, use_scaled_rope=True,
                     rope_scale_factor=32.0, max_sequence_length=SPEC_CONTEXT)


@contextlib.contextmanager
def timed_proposes():
    """``DraftModelProposer.propose`` under the host clock: the yielded list
    gets each call's seconds (its catch-up and drafts, synchronised)."""
    from llama_nuts_and_bolts_tpu_torch.runtime import speculative

    real = speculative.DraftModelProposer.propose
    seconds = []

    def propose(self, k):
        t0 = time.perf_counter()
        out = real(self, k)
        seconds.append(time.perf_counter() - t0)
        return out

    speculative.DraftModelProposer.propose = propose
    try:
        yield seconds
    finally:
        speculative.DraftModelProposer.propose = real


@contextlib.contextmanager
def scripted_ngram(truth, prompt_len: int):
    """The n-gram proposer replaced by a script over the expected stream
    ``truth``: in turn every draft wrong, all right, none (the one-step
    graph runs), the first right and the rest wrong."""
    from llama_nuts_and_bolts_tpu_torch.runtime import speculative

    real = speculative.NgramProposer.propose
    calls = []

    def propose(self, k):
        e = len(self.context) - prompt_len          # tokens emitted so far
        good = truth[e:e + k]
        kind = len(calls) % 4
        calls.append(kind)
        wrong = [(t + 3) % SPEC_CYCLE for t in good]
        return [wrong, good, [], good[:1] + wrong[1:]][kind]

    speculative.NgramProposer.propose = propose
    try:
        yield calls
    finally:
        speculative.NgramProposer.propose = real


def plain_greedy(model, prompt, n: int, **args) -> list:
    """The first ``n`` tokens of the plain greedy stream at the full context
    (the speculative path's cache length), on an engine of its own."""
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    engine = InferenceEngine(model, InferenceArgs(sequence_length=SPEC_CONTEXT, **args),
                             device="cuda")
    out, stream = [], engine.generate_tokens(prompt)
    try:
        for _, tok in stream:
            out.append(tok)
            if len(out) == n:
                break
    finally:
        stream.close()
    return out


def decisive_divergence(model, prompt, got, want, what, **args) -> dict:
    """Speculative tokens ``got`` against plain greedy ones ``want``,
    compared where the argmax is decisive (ROADMAP.md): they must be equal
    up to the first token that differs, and there the plain stream's next
    token must be a near-tie -- its top-two margin (kernels' logits over the
    plain stream's context) within twice the largest difference between the
    kernels' logits and the plain attention path's (which the verify step
    takes) at that position. Else the check fails. ``args`` go to both
    engines (an int8 cache)."""
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    same = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if same is None and len(got) == len(want):
        return dict(equal=True, equal_prefix=len(got))
    ctx = list(prompt) + want[:same]
    logits = {}
    for impl in ("auto", "plain"):
        engine = InferenceEngine(model, InferenceArgs(sequence_length=SPEC_CONTEXT,
                                                      attn_impl=impl, **args),
                                 device="cuda")
        _, cache = engine._prefill(ctx[:-1], SPEC_CONTEXT)
        logits[impl], _ = engine._forward([[ctx[-1]]], len(ctx) - 1, cache)
        del engine, cache
    top2 = torch.topk(logits["auto"][0, -1], 2).values
    margin = float(top2[0] - top2[1])
    diff = float((logits["auto"] - logits["plain"]).abs().max())
    out = dict(equal=False, equal_prefix=same, margin=margin, path_diff=diff,
               decisive=margin > 2 * diff)
    log(f"{what}: tokens equal the plain greedy stream's for {same} of {len(want)}; at the "
        f"next one the plain top-two margin is {margin:.4e} against a kernels-vs-plain "
        f"difference of {diff:.4e}: {'decisive' if out['decisive'] else 'a near-tie'}")
    if out["decisive"]:
        check_failed(f"{what}: tokens differ from plain greedy at {same} where the argmax "
                     f"is decisive: {got[same:same + 4]} vs {want[same:same + 4]}")
    return out


def run_spec_request(engine, tokens, max_new, expect, what):
    """One speculative request through ``generate_string``, every kernel count
    set to 0 just before and read just after. ``expect(one_step, verify,
    prefill_len)`` gives the launches each kernel must show (absent: 0):
    ``one_step`` counts the steps the one-step graph ran on the card (its
    replays and, when this request captured it, its warm-up step) and
    ``verify`` the verify graph's likewise. The graphs' replays must agree
    with ``spec_stats``."""
    from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

    prefill_len = prefill_bucket(len(tokens), engine.seq_len)
    before = {key: (g.replays, g.warmup_steps) for key, g in engine._chunk_fns.items()}
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
    stats = dict(engine.spec_stats)
    ran, replayed = {"verify": 0, "step": 0}, {"verify": 0, "step": 0}
    for key, g in engine._chunk_fns.items():
        r0, w0 = before.get(key, (0, 0))
        kind = "verify" if key[0] == "verify" else "step"
        replayed[kind] += g.replays - r0
        ran[kind] += g.replays - r0 + g.warmup_steps - w0
    if (replayed["verify"], replayed["step"]) != (stats["spec_steps"],
                                                  stats["steps"] - stats["spec_steps"]):
        fail(f"{what}: graphs replayed {replayed}, spec_stats {stats}")
    want = {name: 0 for name in launches}
    want.update(expect(ran["step"], ran["verify"], prefill_len))
    if launches != want:
        check_failed(f"{what}: launches {launches}, expected {want} ({ran['step']} one-step "
                     f"and {ran['verify']} verify steps on the card, prefill bucket "
                     f"{prefill_len})")
    tok_s = (len(ids) - 1) / (t_end - t_first) if len(ids) > 1 else float("nan")
    verifies = stats["spec_steps"]
    per_verify = (stats["accepted"] + verifies) / verifies if verifies else float("nan")
    acceptance = stats["accepted"] / stats["drafted"] if stats["drafted"] else float("nan")
    log(f"{what}: prompt {len(tokens)} tokens, {len(ids)} generated, TTFT "
        f"{(t_first - t0) * 1e3:.1f} ms, decode {tok_s:.2f} tok/s; {stats['steps']} steps, "
        f"{verifies} verify steps, drafted {stats['drafted']}, accepted {stats['accepted']} "
        f"(acceptance {acceptance:.3f}), {per_verify:.2f} tokens a verify step; one-step "
        f"graph {ran['step']} steps, verify graph {ran['verify']} (warm-ups included); "
        f"launches { {k: n for k, n in launches.items() if n} }")
    return dict(ids=ids, prompt=len(tokens), generated=len(ids),
                ttft_ms=(t_first - t0) * 1e3, decode_tok_s=tok_s, steps=stats["steps"],
                verify_steps=verifies, drafted=stats["drafted"], accepted=stats["accepted"],
                acceptance=acceptance, tokens_per_verify=per_verify,
                one_step_ran=ran["step"], verify_ran=ran["verify"], launches=launches)


def time_spec_graphs(engine, prompt, what: str, steps: int = 8) -> dict:
    """The verify graph and the one-step graph of one slot at the full
    context, after ``prompt``'s prefill: each step's host wall with its
    tokens read back every step (as the engine runs it), the verify step's
    device busy time and idle share under torch.profiler, and each graph's
    device time a step by CUDA events (replays queued behind a spin)."""
    cache_len = engine.seq_len
    P = len(prompt)
    feed = [prompt[-1]] + [(prompt[-1] + 1 + j) % SPEC_CYCLE for j in range(SPEC_K)]
    out = {}
    with engine._lease(1, cache_len) as slot:
        engine._prefill(prompt, cache_len, cache=slot.cache)
        verify = engine._verify_graph(SPEC_K, slot)
        step = engine._decode_chunk(1, False, cache_len, slot)

        def run_verify():
            for _ in range(steps):
                verify.set(feed, P)
                verify.replay()
                verify.tokens(verify.fetch())
            torch.cuda.synchronize()

        def run_step():
            for _ in range(steps):
                slot.set([feed[0]], [P])
                step.replay()
                step.tokens(step.fetch())
            torch.cuda.synchronize()

        out["verify"] = step_profile(run_verify, steps,
                                     f"{what}: captured verify step (S={SPEC_K + 1})")
        out["one_step"] = step_profile(run_step, steps, f"{what}: captured one-step graph")
        for name, graph in (("verify", verify), ("one_step", step)):
            if name == "one_step":
                slot.set([feed[0]], [P])
            else:
                verify.set(feed, P)
            ms, _ = cuda_ms(graph.replay, steps)
            out[name]["graph_device_ms"] = ms
            out[name]["capture_ms"] = graph.capture_s * 1e3
            out[name]["capture_mib"] = graph.capture_bytes / 2**20
        log(f"{what}: verify step {out['verify']['graph_device_ms']:.3f} ms on the device "
            f"(events), host wall {out['verify']['wall_ms']:.2f} ms; one-step graph "
            f"{out['one_step']['graph_device_ms']:.3f} ms, wall {out['one_step']['wall_ms']:.2f} "
            f"ms; verify graph warm-up and capture {verify.capture_s * 1e3:.1f} ms, "
            f"{verify.capture_bytes / 2**20:.1f} MiB reserved")
    return out


def check_spec_positions(cyc_model, prompt, n: int) -> dict:
    """The slot's position after a rejection, on the cyclic 32-layer model:
    a scripted proposer (every draft wrong, all right, none, the first right)
    runs a speculative request; its tokens must be the expected cycle, and
    the cache rows its slot holds those of the plain greedy run's slot
    (kernel limits: only the products' row counts differ). The planted
    fault, a verify graph that leaves the position where its last replay
    put it, moved on by k+1 (not rewound after a rejection), must fail the
    rows."""
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.runtime import engine as engine_mod
    from llama_nuts_and_bolts_tpu_torch.runtime.decode_graph import VerifyGraph

    class PositionNotRewound(VerifyGraph):
        def set(self, tokens, position):             # the planted fault
            if self.replays == 0:
                super().set(tokens, position)
            else:
                self.feed.copy_(torch.tensor([tokens], dtype=torch.int32, device="cuda"))

        def _body(self):
            super()._body()
            self.slot.pos.add_(self.k + 1)

    P = len(prompt)
    truth = [(prompt[-1] + 1 + i) % SPEC_CYCLE for i in range(n + SPEC_K)]
    plain = InferenceEngine(cyc_model, InferenceArgs(sequence_length=SPEC_CONTEXT),
                            device="cuda")
    stream = plain.generate_tokens(prompt)
    ref = [tok for _, (_, tok) in zip(range(n), stream)]
    stream.close()
    if ref != truth[:n]:
        fail(f"cyclic 32-layer plain greedy: {ref}, expected {truth[:n]}")
    rows = slice(0, P + n - 1)
    (ref_slot,) = plain._slots[(1, SPEC_CONTEXT)]
    errs = {}
    for name, graph_cls in (("sound", VerifyGraph), ("position not rewound", PositionNotRewound)):
        planted = graph_cls is not VerifyGraph
        engine_mod.VerifyGraph = graph_cls
        try:
            engine = InferenceEngine(cyc_model, InferenceArgs(
                sequence_length=SPEC_CONTEXT, speculate_k=SPEC_K), device="cuda")
            with scripted_ngram(truth, P) as calls:
                got = [t for _, t in engine.generate_tokens(prompt, max_new_tokens=n)]
        finally:
            engine_mod.VerifyGraph = VerifyGraph
        torch.cuda.synchronize()
        (slot,) = engine._slots[(1, SPEC_CONTEXT)]
        what = (f"cyclic 32-layer speculative request, scripted drafts "
                f"({sorted(set(calls))} kinds, {engine.spec_stats}), {name}")
        if not planted and got != truth[:n]:
            check_failed(f"{what}: tokens {got}, expected {truth[:n]}")
        errs[name] = max(kernel_err(getattr(slot.cache, c)[:, :, :, rows],
                                    getattr(ref_slot.cache, c)[:, :, :, rows],
                                    f"{what}, cache {c} rows vs plain greedy's",
                                    planted=planted) for c in ("k", "v"))
        del engine, slot
    del plain, ref_slot
    torch.cuda.empty_cache()
    return errs


def spec_main_path(tk, vocab):
    """Speculation on the sequential engine, 32-layer 8B, bf16 weights and
    cache, context 8192, k = 4: (a) the cyclic model with n-gram drafts, (b)
    the random-weight model with n-gram drafts on request A's prompt (the
    acceptance floor), (c) draft models at Llama-3.2-1B's widths on the
    cyclic target, a 2-layer cyclic draft of its cycle and a 16-layer random
    one; each against plain greedy, with launch counts, acceptance, the
    verify graph's device time, host wall and capture; then the position
    check with its planted fault."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel, init_random_params
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    cfg = cfg_8b(32)
    L = cfg.n_layers
    params = init_random_params(cfg, seed=0, device="cuda", fused=True)
    rand = LoadedModel(params=params, cfg=cfg, vocab=vocab,
                       mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    cyc = LoadedModel(params=cyclic_params(params, SPEC_CYCLE), cfg=cfg, vocab=vocab,
                      mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    prompt_c = list(range(SPEC_CYCLE)) * 3
    n = 64
    expect_c = [i % SPEC_CYCLE for i in range(n)]

    def expect(one_step, verify, prefill_len):
        return {"K1": L, "K2": L * one_step}

    def spec_engine(model, draft=None):
        return InferenceEngine(model, InferenceArgs(sequence_length=SPEC_CONTEXT,
                                                    speculate_k=SPEC_K),
                               draft_model=draft, device="cuda")

    results = {}
    torch.cuda.reset_peak_memory_stats()
    engine = spec_engine(cyc)
    r = results["a_cyclic_ngram"] = run_spec_request(
        engine, prompt_c, n, expect, "speculative (a): cyclic 32-layer, n-gram, k = 4")
    if r["ids"] != expect_c or plain_greedy(cyc, prompt_c, n) != expect_c:
        check_failed(f"speculative (a): tokens {r['ids']}, expected {expect_c}")
    r["graphs"] = time_spec_graphs(engine, prompt_c, "speculative (a), bf16")
    del engine

    chat, _, _ = prompts(InferenceEngine(rand, InferenceArgs(sequence_length=SPEC_CONTEXT),
                                         device="cuda"), vocab)
    engine = spec_engine(rand)
    r = results["b_random_ngram"] = run_spec_request(
        engine, chat, n, expect, "speculative (b): random 32-layer, n-gram, k = 4, request A")
    r["vs_plain"] = decisive_divergence(rand, chat, r["ids"], plain_greedy(rand, chat, n),
                                        "speculative (b)")
    r["graphs"] = time_spec_graphs(engine, chat, "speculative (b), bf16")
    del engine

    draft_cfg = cfg_1b(2)
    draft_params = init_random_params(draft_cfg, seed=5, device="cuda")
    for key, draft, what in (
            ("c_cyclic_draft", LoadedModel(
                params=cyclic_params(draft_params, SPEC_CYCLE), cfg=draft_cfg, vocab=vocab,
                mergeable_ranks=tk.mergeable_ranks, tensor_meta={}),
             "2-layer cyclic draft of the target's cycle"),
            ("c_random_draft", LoadedModel(
                params=init_random_params(cfg_1b(16), seed=6, device="cuda"),
                cfg=cfg_1b(16), vocab=vocab, mergeable_ranks=tk.mergeable_ranks,
                tensor_meta={}), "16-layer random draft")):
        engine = spec_engine(cyc, draft)
        with timed_proposes() as seconds:
            r = results[key] = run_spec_request(
                engine, prompt_c, n, expect,
                f"speculative (c): cyclic 32-layer target, {what} at Llama-3.2-1B widths")
        r["propose_ms"] = 1e3 * sum(seconds) / max(len(seconds), 1)
        r["proposes"] = len(seconds)
        log(f"speculative (c), {what}: {len(seconds)} proposes, {r['propose_ms']:.2f} ms of "
            f"host wall each (catch-up and {SPEC_K} drafts, eager)")
        if r["ids"] != expect_c:
            check_failed(f"speculative (c), {what}: tokens {r['ids']}, expected {expect_c}")
        if key == "c_cyclic_draft" and r["accepted"] != r["drafted"]:
            check_failed(f"speculative (c), {what}: accepted {r['accepted']} of "
                         f"{r['drafted']} drafts, expected all")
        r["graphs"] = time_spec_graphs(engine, prompt_c, f"speculative (c), {what}")
        del engine, draft
    del draft_params
    results["positions"] = check_spec_positions(cyc, prompt_c, 40)
    results["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for r in results.values():
        if isinstance(r, dict):
            r.pop("ids", None)
    del rand, cyc, params
    torch.cuda.empty_cache()
    return results


def spec_quant_path(tk, vocab):
    """(a) again with int4 weights and an int8 cache: the cyclic 32-layer
    model quantized (groups of 256), context 8192. The one-step graph runs
    K4 and K8, the verify step K8 on every projection and the head (R = 5)."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel, init_random_params
    from llama_nuts_and_bolts_tpu_torch.quant import quantize_params_q4
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    cfg = cfg_8b(32)
    L = cfg.n_layers
    bf16 = init_random_params(cfg, seed=0, device="cuda")
    cyc = LoadedModel(params=quantize_params_q4(cyclic_params(bf16, SPEC_CYCLE)), cfg=cfg,
                      vocab=vocab, mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    del bf16
    torch.cuda.empty_cache()
    prompt, n = list(range(SPEC_CYCLE)) * 3, 64
    per_pass = 7 * L + 1

    def expect(one_step, verify, prefill_len):
        k8_prefill = per_pass if prefill_len <= 32 else 1
        return {"K8": k8_prefill + per_pass * (one_step + verify), "K4": L * one_step}

    engine = InferenceEngine(cyc, InferenceArgs(sequence_length=SPEC_CONTEXT,
                                                speculate_k=SPEC_K, kv_cache_dtype="int8"),
                             device="cuda")
    r = run_spec_request(engine, prompt, n, expect,
                         "speculative (a), int4 + int8 KV: cyclic 32-layer, n-gram, k = 4")
    want = [i % SPEC_CYCLE for i in range(n)]
    if r.pop("ids") != want or plain_greedy(cyc, prompt, n, kv_cache_dtype="int8") != want:
        check_failed(f"speculative (a), int4 + int8 KV: tokens differ from {want}")
    if r["verify_ran"] == 0 or r["launches"]["K8"] == 0:
        check_failed("speculative (a), int4 + int8 KV: no verify step launched K8")
    r["graphs"] = time_spec_graphs(engine, prompt, "speculative (a), int4 + int8 KV")
    del engine, cyc
    torch.cuda.empty_cache()
    return r


def spec_batchers(tk, vocab):
    """The dense and paged speculative batchers (k = 4) on the cyclic model at
    2 full-width layers, context 512: greedy requests against the
    sequential engine's tokens; on a pool of 4 blocks, where the drafts are
    clamped to what the pool backs (each request a prefix of its
    sequential stream); a greedy and a sampled request sharing steps. The
    verify steps run the gather path, the paged batcher's no-draft steps
    K6."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel, init_random_params
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.runtime import speculative
    from llama_nuts_and_bolts_tpu_torch.runtime.continuous import ContinuousBatcher
    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher

    cfg = cfg_8b(2)
    params = cyclic_params(init_random_params(cfg, seed=2, device="cuda"), SPEC_CYCLE)
    model = LoadedModel(params=params, cfg=cfg, vocab=vocab,
                        mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    engine = InferenceEngine(model, InferenceArgs(sequence_length=512), device="cuda")
    requests = [(list(range(SPEC_CYCLE)) * 3, 40), ([3, 4, 5], 24),
                (list(range(SPEC_CYCLE)) * 9, 33), ([6, 7], 12)]
    seq = [[t for _, t in engine.generate_tokens(p, max_new_tokens=m)] for p, m in requests]
    if seq != [[(p[-1] + 1 + i) % SPEC_CYCLE for i in range(m)] for p, m in requests]:
        fail(f"cyclic 2-layer sequential engine: {seq}")
    asked = []
    real = speculative.NgramProposer.propose

    def propose(self, k):
        asked.append(k)
        return real(self, k)

    out = {}
    speculative.NgramProposer.propose = propose
    try:
        for name, make, tight in (
                ("dense", lambda: ContinuousBatcher(engine, n_slots=2, speculate_k=SPEC_K),
                 False),
                ("paged", lambda: PagedBatcher(engine, n_slots=2, n_blocks=33,
                                               speculate_k=SPEC_K), False),
                ("paged, pool of 4 blocks", lambda: PagedBatcher(
                    engine, n_slots=2, n_blocks=5, speculate_k=SPEC_K), True)):
            batcher = make()
            asked.clear()
            reset_counts()
            reqs = [batcher.submit(p, max_new_tokens=m) for p, m in requests]
            batcher.run_until_idle()
            torch.cuda.synchronize()
            counts = read_counts()
            got = [[t for _, t in r.tokens(timeout=60)] for r in reqs]
            what = f"cyclic 2-layer speculative {name} batcher"
            if tight:
                if any(g != s[:len(g)] or not g for g, s in zip(got, seq)):
                    fail(f"{what}: {got} is not a prefix of {seq}")
                if batcher.allocator.available != 4 or min(asked, default=SPEC_K) >= SPEC_K:
                    check_failed(f"{what}: blocks free {batcher.allocator.available}, draft "
                                 f"sizes asked {sorted(set(asked))} (no clamping)")
            elif got != seq:
                fail(f"{what}: {got}, sequential engine {seq}")
            want = {"K6": cfg.n_layers * batcher.decode_steps} if name != "dense" else {}
            if {k: v for k, v in counts.items() if v} != {k: v for k, v in want.items() if v}:
                check_failed(f"{what}: launches {counts}, expected {want}")
            stats = batcher.spec_stats_snapshot()
            out[name] = dict(stats, verify_steps=batcher.verify_steps,
                             plain_steps=batcher.decode_steps, draft_sizes=sorted(set(asked)),
                             tokens=[len(g) for g in got])
            log(f"{what}: {len(reqs)} requests on 2 slots, tokens "
                f"{'a prefix of' if tight else 'equal to'} the sequential engine's; "
                f"{batcher.verify_steps} verify steps, {batcher.decode_steps} plain steps, "
                f"spec_stats {stats}, draft sizes asked {sorted(set(asked))}, launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            del batcher
        for name, make in (("dense", lambda k: ContinuousBatcher(engine, n_slots=2,
                                                                 speculate_k=k)),
                           ("paged", lambda k: PagedBatcher(engine, n_slots=2, n_blocks=33,
                                                            speculate_k=k))):
            streams = []
            for k in (SPEC_K, SPEC_K, 0):
                batcher = make(k)
                greedy = batcher.submit(requests[0][0], max_new_tokens=24)
                sampled = batcher.submit([3, 4, 5], max_new_tokens=24, temperature=0.8,
                                         top_k=50, seed=7)
                batcher.run_until_idle()
                streams.append([[t for _, t in r.tokens(timeout=60)]
                                for r in (greedy, sampled)])
                del batcher
            what = f"cyclic 2-layer speculative {name} batcher, greedy beside sampled"
            if streams[0][0] != seq[0][:24] or streams[0] != streams[1]:
                fail(f"{what}: {streams[:2]}, greedy expected {seq[0][:24]}")
            out[name + "_mixed"] = dict(sampled_equals_plain_batcher=streams[0][1] ==
                                        streams[2][1])
            log(f"{what}: greedy tokens equal the sequential engine's, the sampled stream "
                f"repeats with its seed and {'equals' if streams[0][1] == streams[2][1] else 'differs from'} "
                f"the plain batcher's for that seed")
    finally:
        speculative.NgramProposer.propose = real
    del engine, model, params
    torch.cuda.empty_cache()
    return out


def spec_serving_path(tk, vocab):
    """The server with speculation: the cyclic 32-layer 8B (split layout),
    context 2048, 4 slots over a bf16 paged pool of 257 blocks, k = 4,
    through LlamaHTTPServer on an ephemeral port; greedy and sampled
    requests sent at once. Every response 200; ``/metrics`` carries the
    ``llama_spec_*`` counters (accepted <= drafted, verify steps > 0) and
    ``/health`` ``continuous.speculation``; K6 runs once a layer for every
    plain (no-draft) batched step."""
    from concurrent.futures import ThreadPoolExecutor

    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel, init_random_params
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.serving.server import LlamaHTTPServer

    cfg = cfg_8b(32)
    params = cyclic_params(init_random_params(cfg, seed=0, device="cuda"), SPEC_CYCLE)
    model = LoadedModel(params=params, cfg=cfg, vocab=vocab,
                        mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    engine = InferenceEngine(model, InferenceArgs(sequence_length=SERVE_CONTEXT,
                                                  speculate_k=SPEC_K), device="cuda")
    srv = LlamaHTTPServer(engine, continuous_slots=SERVE_SLOTS, paged_blocks=SERVE_BLOCKS)
    batcher = srv.batcher
    if batcher.attn_impl != "flash" or batcher.speculate_k != SPEC_K:
        fail(f"speculative serving: batcher {batcher.attn_impl!r}, k {batcher.speculate_k}")
    log(f"speculative serving: prewarm {srv.prewarm():.1f}s")
    url = f"http://127.0.0.1:{srv.start_background()}"

    def chat(user, **kw):
        return "/v1/chat/completions", {"messages": [{"role": "user", "content": user}],
                                        "max_tokens": 48, **kw}

    sampled = {"prompt": "The quick brown fox", "max_tokens": 96, "temperature": 0.8,
               "top_p": 0.95, "seed": 1234, "stream": True}
    reqs = [("chat A, stream", *chat("Where are we?", stream=True), True),
            ("chat A, blocking", *chat("Where are we?"), False),
            ("chat B, stream", *chat("Name three rivers.", stream=True), True),
            ("sampled, seed 1234", "/v1/completions", sampled, True),
            ("sampled, seed 99", "/v1/completions", dict(sampled, seed=99), True),
            ("completion, logprobs", "/v1/completions",
             {"prompt": "Once upon a time", "max_tokens": 32, "logprobs": 2}, False)]
    reset_counts()
    steps0, tokens0 = batcher.decode_steps, srv.metrics["tokens_generated_total"]
    before = batcher.spec_stats_snapshot()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(reqs)) as pool:
        futures = [pool.submit(sse_request, url + path, body, stream)
                   for _, path, body, stream in reqs]
        results = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = read_counts()
    steps = batcher.decode_steps - steps0
    tokens = srv.metrics["tokens_generated_total"] - tokens0
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
        metrics = {line.split()[0]: float(line.split()[1]) for line in
                   resp.read().decode().splitlines() if line.startswith("llama_spec_")}
    with urllib.request.urlopen(url + "/health", timeout=60) as resp:
        health = json.loads(resp.read())["continuous"].get("speculation")
    out = {"requests": {}, "wall_s": wall, "tokens": tokens, "aggregate_tok_s": tokens / wall,
           "plain_steps": steps, "metrics": metrics, "health": health, "launches": counts}
    for (name, _, _, stream), (status, text, t_first, t_end, n) in zip(reqs, results):
        out["requests"][name] = dict(status=status, ttft_ms=t_first * 1e3, end_ms=t_end * 1e3,
                                     tokens_or_chunks=n)
        log(f"speculative serving, {name}: status {status}, {n} "
            f"{'chunks' if stream else 'tokens'}, end {t_end * 1e3:.1f} ms")
        if status != 200 or not text:
            fail(f"speculative serving, {name}: status {status}, text {text!r}")
    drafted = metrics.get("llama_spec_drafted_total", -1)
    accepted = metrics.get("llama_spec_accepted_total", -1)
    verifies = metrics.get("llama_spec_verify_steps_total", -1)
    if not (0 <= accepted <= drafted and verifies > 0 and drafted > before["drafted"]):
        check_failed(f"speculative serving: /metrics spec counters {metrics}")
    if not health or health.get("k") != SPEC_K or health.get("drafted") != drafted:
        check_failed(f"speculative serving: /health continuous.speculation {health}")
    if {k: n for k, n in counts.items() if n} != ({"K6": cfg.n_layers * steps} if steps else {}):
        check_failed(f"speculative serving: launches {counts} over {steps} plain batched "
                     f"steps, expected K6 {cfg.n_layers} x {steps}")
    log(f"speculative serving: {len(reqs)} requests in {wall:.2f}s, {tokens} tokens, "
        f"aggregate {tokens / wall:.2f} tok/s, {batcher.verify_steps} batched verify steps, "
        f"{steps} plain steps (K6 {counts['K6']}); /metrics {metrics}; /health {health}")
    srv.shutdown()
    del srv, batcher, engine, model, params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 14-17

# The probe times each candidate on a one-step graph of its own
# (InferenceEngine.autotune_attn_impl): the capture's warm-up step, then 2
# untimed replays (the first right after the capture) and 5 timed ones.
PROBE_STEPS = 1 + 2 + 5


def probe_path(model, tk, vocab) -> dict:
    """``attn_impl="probe"`` on the 32-layer 8B at context 8192, bf16 and
    int8 caches: requests A and B (buckets 256 and 4096) through a probing
    engine, each bucket probed at its first decode step, beside an ``auto``
    engine on the same requests. Launches exact, the probe's replays
    included; where the probe chose the kernels the tokens equal auto's,
    where it chose the plain path they are compared where the argmax is
    decisive."""
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    L = model.cfg.n_layers
    out = {}
    for kv, tag in (("bf16", "K2"), ("int8", "K4")):
        engines = {impl: InferenceEngine(model, InferenceArgs(
            sequence_length=8192, kv_cache_dtype=kv, attn_impl=impl), device="cuda")
            for impl in ("auto", "probe")}
        chat, long_prompt, _ = prompts(engines["auto"], vocab)
        for key, tokens, max_new in (("A", chat, 64), ("B", long_prompt, 32)):
            runs = {}
            for impl, engine in engines.items():
                bucket = engine.cache_bucket(len(tokens), max_new)

                def expect(steps, prefill_len, engine=engine, bucket=bucket):
                    # the prefill: K1 on a bf16 cache, the plain path on int8
                    want = {"K1": L} if kv == "bf16" else {}
                    chose = engine._attn_impl(1, bucket)
                    probed = PROBE_STEPS if engine.args.attn_impl == "probe" else 0
                    want[tag] = L * ((steps if chose == "flash" else 0) + probed)
                    return want

                runs[impl] = run_request(engine, tokens, max_new, expect,
                                         f"{kv} cache, {impl}, request {key}", captures=(1,))
            probe = engines["probe"]
            bucket = runs["probe"]["cache_len"]
            chose = probe._probed_decode_impl[bucket]
            timings = {k: v * 1e3 for k, v in probe._probe_timings.items()}
            log(f"probe, {kv} cache, bucket {bucket}: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in timings.items())
                + f" (best of 5 one-step graph replays, host clock to a synchronise)"
                f" -> {chose!r}")
            got, want = runs["probe"].pop("ids"), runs["auto"].pop("ids")
            if chose == "flash":
                same = dict(equal=got == want)
                if got != want:
                    check_failed(f"probe ({kv}, bucket {bucket}) chose the kernels but its "
                                 f"tokens differ from auto's: {got[:8]} vs {want[:8]}")
            else:
                same = decisive_divergence(model, tokens, got, want,
                                           f"probe ({kv}, bucket {bucket}) on the plain path "
                                           f"vs auto", kv_cache_dtype=kv)
            out[f"{kv}_{key}"] = dict(bucket=bucket, timings_ms=timings, chose=chose,
                                      tokens_vs_auto=same, probe=runs["probe"],
                                      auto=runs["auto"])
        del engines
        torch.cuda.empty_cache()
    return out


def kernel_times(prof, what: str, steps: int = 1) -> dict:
    """A trace's device time by kernel name: the top 10 and the port's
    kernels' shares."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"{what}: device busy {total:.3f} ms, {sum(e.count for e in kernels)} kernels")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.self_device_time_total / 1e3 / total:6.1%} {e.count:5d} calls  {e.key[:100]}")
    shares = {}
    for tag, name in (("K1", "flash_gqa_kernel"), ("K2", "flash_decode_kernel")):
        ms = sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
        if ms:
            shares[tag] = dict(ms=ms, share=ms / total)
            log(f"  {tag} ({name}): {ms:.3f} ms, {ms / total:.1%} of the device time")
    return dict(device_ms=total, top=[(e.key[:100], e.self_device_time_total / 1e3,
                                       e.count) for e in top], ours=shares)


def trace_names(log_dir: str) -> str:
    names = []
    for f in os.listdir(log_dir):
        with open(os.path.join(log_dir, f)) as fh:
            names += [str(e.get("name")) for e in json.load(fh)["traceEvents"]]
    return " ".join(names)


def narration_path(model, tk, vocab) -> dict:
    """Request B's prefill (3,000 tokens, bucket 4096) through
    ``narrated_forward`` on the engine's prefill path (K1): each layer's ms,
    and logits bit-equal to ``forward``'s on the same inputs; the planted
    fault (one layer skipped) must not be. Then ``device_trace`` around an
    eager prefill of request B and around one replayed decode step: each
    trace's device time by kernel name."""
    import tempfile

    from llama_nuts_and_bolts_tpu_torch.models.llama import forward
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.runtime import profiling
    from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

    cfg, L = model.cfg, model.cfg.n_layers
    engine = InferenceEngine(model, InferenceArgs(sequence_length=8192), device="cuda")
    _, prompt, _ = prompts(engine, vocab)
    bucket = engine.cache_bucket(len(prompt), 32)
    S = prefill_bucket(len(prompt), bucket)
    tokens = torch.zeros((1, S), dtype=torch.int32, device="cuda")
    tokens[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    impl = engine._attn_impl(S, bucket)
    if impl != "flash":
        check_failed(f"the engine's prefill at S={S} takes {impl!r}, not the kernels")
    out = {}
    skip = L // 2
    block = profiling.decoder_block

    def skipping(w, li, x, inp):                   # the planted fault
        return x if li == skip else block(w, li, x, inp)

    for what, planted in (("narrated", False), ("narrated, layer skipped", True)):
        lines = []
        profiling.decoder_block = skipping if planted else block
        try:
            reset_counts()
            t0 = time.perf_counter()
            got, _ = profiling.narrated_forward(model.params, cfg, tokens, 0,
                                                engine.new_cache(1, bucket), lines.append,
                                                attn_impl=impl, logits_at=len(prompt) - 1)
            wall = time.perf_counter() - t0
            launches = read_counts()
        finally:
            profiling.decoder_block = block
        if planted:
            equal = torch.equal(got, out["logits"])
            log(f"planted fault, narrated prefill with layer {skip + 1} skipped: logits "
                f"{'bit-equal to' if equal else 'differ from'} forward's (relative L2 "
                f"{rel_l2(got, out['logits']):.3e}): {'passes' if equal else 'fails'}")
            if equal:
                check_failed("the narrated prefill's planted fault passes bit-equality")
            continue
        ref, _ = forward(model.params, cfg, tokens, 0, engine.new_cache(1, bucket),
                         attn_impl=impl, logits_at=len(prompt) - 1)
        layer_s = [float(re.search(r"took (\d+\.\d+)", ln).group(1)) for ln in lines[1:-1]]
        equal = torch.equal(got, ref)
        log(f"narrated prefill of request B (S={S}, bucket {bucket}, {impl}): {len(lines)} "
            f"lines, {wall * 1e3:.1f} ms; a layer {min(layer_s) * 1e3:.3f}-"
            f"{max(layer_s) * 1e3:.3f} ms (median {sorted(layer_s)[L // 2] * 1e3:.3f}); "
            f"embeddings {lines[0].split('took ')[1]}, head {lines[-1].split('took ')[1]}; "
            f"logits {'bit-equal to' if equal else 'DIFFER from'} forward's; launches "
            f"{ {k: n for k, n in launches.items() if n} }")
        for ln in lines[:3] + lines[-2:]:
            log(f"  {ln}")
        if len(lines) != L + 2 or not equal or launches["K1"] != L:
            check_failed(f"narrated prefill: {len(lines)} lines, bit-equal {equal}, "
                         f"K1 {launches['K1']} (want {L + 2}, True, {L})")
        out.update(logits=ref, layer_ms=[t * 1e3 for t in layer_s], wall_ms=wall * 1e3,
                   bit_equal=equal, launches=launches)
    out.pop("logits")

    with engine._lease(1, bucket) as slot, tempfile.TemporaryDirectory() as d:
        logits, _ = engine._prefill(prompt, bucket, cache=slot.cache)
        tok = int(torch.argmax(logits[0, -1]))
        graph = engine._decode_chunk(1, cache_len=bucket, slot=slot)
        slot.set([tok], [len(prompt)])
        graph.replay()                              # captured before the trace
        torch.cuda.synchronize()
        traced = {}
        for what, run in (
                ("prefill", lambda: engine._prefill(prompt, bucket, cache=slot.cache)),
                ("decode step", lambda: (slot.set([tok], [len(prompt)]), graph.replay()))):
            sub = os.path.join(d, what.replace(" ", "_"))
            reset_counts()
            with profiling.device_trace(sub) as prof:
                run()
            launches = read_counts()
            names = trace_names(sub)
            want = "flash_gqa_kernel" if what == "prefill" else "flash_decode_kernel"
            traced[what] = kernel_times(prof, f"trace of request B's {what} "
                                              f"(device_trace, torch.profiler)")
            traced[what]["launches"] = {k: n for k, n in launches.items() if n}
            if want not in names:
                check_failed(f"the trace of request B's {what} does not name {want}")
        out["trace"] = traced
    del engine
    torch.cuda.empty_cache()
    return out


def native_bpe_path(tk) -> dict:
    """Request B's text encoded by the native merge and by the Python merge:
    the same ids; each one's host time (the native context's construction
    apart)."""
    from llama_nuts_and_bolts_tpu_torch.tokenizer import bpe
    from llama_nuts_and_bolts_tpu_torch.tokenizer.native import native_available

    if not native_available():
        check_failed("the native BPE merge did not build")
        return {}
    text = long_text()
    ranks = dict(tk.mergeable_ranks)              # a table of its own: a fresh context
    t0 = time.perf_counter()
    bpe._native_for(ranks)
    ctx_ms = (time.perf_counter() - t0) * 1e3
    times, ids = {}, {}
    for how, native in (("native", True), ("python", False)):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            ids[how] = bpe.encode_ordinary(text, ranks, use_native=native)
            best = min(best, time.perf_counter() - t0)
        times[how] = best * 1e3
    equal = ids["native"] == ids["python"]
    log(f"native BPE: request B's text ({len(text)} chars, {len(ids['native'])} ids): native "
        f"{times['native']:.2f} ms, Python {times['python']:.2f} ms (best of 3, host "
        f"clock; the native context of {len(ranks)} ranks built in {ctx_ms:.1f} ms); ids "
        f"{'equal' if equal else 'DIFFER'}")
    if not equal:
        check_failed("the native BPE merge's ids differ from the Python merge's")
    bpe._NATIVE_CACHE.pop(id(ranks))
    return dict(chars=len(text), ids=len(ids["native"]), native_ms=times["native"],
                python_ms=times["python"], context_ms=ctx_ms, equal=equal)


def shards_path(tk, vocab) -> dict:
    """A 2-layer model at 8B widths (~3 GB of bf16) saved as Meta's 2-shard
    checkpoint with ``torch.save`` into a temporary directory, loaded with
    ``load_llama_model`` onto the card, against the same state dict given to
    ``build_params_from_checkpoint``: prefill logits (K1) bit-equal. The
    planted fault (the shards concatenated in reverse order) must not be."""
    import base64
    import tempfile

    from llama_nuts_and_bolts_tpu_torch.io import shards
    from llama_nuts_and_bolts_tpu_torch.models.llama import forward, init_random_params
    from llama_nuts_and_bolts_tpu_torch.models.llama.loader import (
        CKPT_LAYER_NAMES, build_params_from_checkpoint, load_llama_model)
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache

    cfg = cfg_8b(2)
    src = init_random_params(cfg, seed=7, device="cuda")
    sd = {"tok_embeddings.weight": src.tok_embeddings.cpu(), "norm.weight": src.norm.cpu(),
          "output.weight": src.output.cpu()}
    for key, tmpl in CKPT_LAYER_NAMES.items():
        for i in range(cfg.n_layers):
            sd[tmpl.format(i=i)] = src.layers[key][i].cpu()
    del src
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    tokens = torch.randint(0, 128000, (1, 512), generator=torch.Generator().manual_seed(9),
                           dtype=torch.int32).cuda()

    def logits_of(params):
        out, _ = forward(params, cfg, tokens, 0, KVCache.create(cfg, 1, 512, device="cuda"),
                         attn_impl="flash", logits_at=511)
        return out

    out = {}
    reset_counts()
    ref = logits_of(build_params_from_checkpoint(sd, cfg, device="cuda"))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        parts = [dict(), dict()]
        for name, t in sd.items():
            axis = shards.shard_concat_axis(name)
            for i, part in enumerate([t, t] if axis is None else torch.chunk(t, 2, dim=axis)):
                parts[i][name] = part.contiguous()
        for i, part in enumerate(parts):
            torch.save(part, os.path.join(d, f"consolidated.{i:02d}.pth"))
        del parts
        with open(os.path.join(d, "params.json"), "w") as f:
            json.dump(dict(dim=cfg.dim, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, vocab_size=cfg.vocab_size,
                           multiple_of=cfg.multiple_of,
                           ffn_dim_multiplier=cfg.ffn_dim_multiplier, norm_eps=cfg.norm_eps,
                           rope_theta=cfg.rope_theta, use_scaled_rope=cfg.use_scaled_rope), f)
        with open(os.path.join(d, "tokenizer.model"), "w") as f:
            f.writelines(f"{base64.b64encode(t).decode()} {r}\n"
                         for t, r in tk.mergeable_ranks.items())
        save_s = time.perf_counter() - t0
        found = shards.find_checkpoint_shards(d)
        t0 = time.perf_counter()
        loaded = load_llama_model(d, max_sequence_length=8192, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got = logits_of(loaded.params)
        del loaded
        equal = torch.equal(got, ref)
        log(f"sharded checkpoint: {len(found)} shards, {nbytes / 1e9:.2f} GB of bf16, saved "
            f"in {save_s:.1f} s, loaded onto the card in {load_s:.1f} s; prefill logits "
            f"(512 tokens, K1) {'bit-equal to' if equal else 'DIFFER from'} the state dict's")
        if len(found) != 2 or not equal:
            check_failed(f"sharded load: {len(found)} shards, logits bit-equal {equal}")
        # the planted fault: the shards in reverse order
        backwards = shards.load_sharded_checkpoint(found[::-1])
        bad = logits_of(build_params_from_checkpoint(backwards, cfg, device="cuda"))
        del backwards
        wrong = torch.equal(bad, ref)
        log(f"planted fault, shards concatenated in reverse order: logits "
            f"{'bit-equal' if wrong else 'differ'} (relative L2 {rel_l2(bad, ref):.3e}): "
            f"{'passes' if wrong else 'fails'}")
        if wrong:
            check_failed("the reversed-shard fault passes the sharded load's check")
    out.update(shards=len(found), gigabytes=nbytes / 1e9, save_s=save_s, load_s=load_s,
               bit_equal=equal, launches=read_counts())
    torch.cuda.empty_cache()
    return out


def single_device_paths(tk, vocab) -> dict:
    """Phases 14-17 on one 32-layer 8B model (the probe and the narration),
    then the native merge and the sharded checkpoint; their total time."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel, init_random_params

    t0 = time.perf_counter()
    params = init_random_params(cfg_8b(32), seed=0, device="cuda", fused=True)
    model = LoadedModel(params=params, cfg=cfg_8b(32), vocab=vocab,
                        mergeable_ranks=tk.mergeable_ranks, tensor_meta={})
    out = {}
    log("phase 14: the measured attention probe, 32-layer 8B, bf16 and int8 caches")
    out["probe"] = probe_path(model, tk, vocab)
    log("phase 15: narrated prefill and device traces, 32-layer 8B, request B")
    out["narration"] = narration_path(model, tk, vocab)
    del model, params
    torch.cuda.empty_cache()
    log("phase 16: native BPE merge vs the Python merge on request B's text")
    out["native_bpe"] = native_bpe_path(tk)
    log("phase 17: Meta's 2-shard checkpoint, 2 layers at 8B widths")
    out["shards"] = shards_path(tk, vocab)
    out["seconds"] = time.perf_counter() - t0
    log(f"phases 14-17: {out['seconds']:.1f} s")
    return out


# ------------------------------------------------ phases 18-21: tensor parallelism
#
# A: K1, K2, K4 and K8 at the per-rank shapes of Llama-3.1-8B at tp 2 and 4
#    (K8's head also at tp 8, where it takes the dense route), in this process.
# B: one NCCL rank through the whole tp code path, in a child process.
# C: two gloo ranks on the one card, eager forward, in child processes.
# D: NCCL at tp = min(4, cards) on the CLI's process model, when there are 2
#    cards or more, in child processes.
# The children start after the parent has freed its models; each writes its
# numbers to a JSON file and logs its peak memory.

TP_RANK_SHAPES = (2, 4)
# Phase C: the two-rank forward against the unsharded forward, relative L2
# per logits row on 32 layers. Both run the kernels; the sharded one sums the
# ranks' partial products in fp32 and rounds once, the unsharded one rounds
# each whole product once, and random layers amplify those ulps with depth.
# Each limit sits between the sound reading and the planted fault's (one
# rank skips its wo all-reduce) on an H100: bf16 2.2e-2 and 1.22; int4 +
# int8 KV 2.1e-4 and 9.5e-4, where, as in phase 3, attention moves these
# random int4 weights' logits little (PERF.md). Every run reads both again.
TP_REL_L2 = {"bf16": 0.1, "int4": 5e-4}
TP_CHILD_TIMEOUT_S = 480
TP_TEARDOWN_S = 60               # a rank's destroy_process_group, at most
TP_DECODE_STEPS = 8


@contextlib.contextmanager
def rank_heads(tp: int):
    """The kernel helpers above read the attention widths from ``H`` and
    ``KV``: inside, they are one tp rank's of Llama-3.1-8B (G stays 4)."""
    global H, KV
    saved = H, KV
    H, KV = 32 // tp, 8 // tp
    try:
        yield
    finally:
        H, KV = saved


def cycle_calls(items, fn):
    """A call that runs ``fn`` on the next of ``items`` each time."""
    state = {"i": 0}

    def call():
        state["i"] = (state["i"] + 1) % len(items)
        return fn(items[state["i"]])
    return call


def time_k8_at(gen, errs, ws, R: int, what: str) -> dict:
    """K8 on the weights ``ws`` (copies of one layer's Q4Tensor, enough that a
    cycled run reads them from outside the L2) at R rows, against its plain
    version with its last split dropped as a planted fault, timed beside its
    bound, its plain version and ``torch._weight_int4pack_mm``."""
    from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import (
        k8_split, q4_matmul, q4_matmul_plain)

    G, out_dim, half = ws[0].packed.shape
    in_dim = 2 * G * half
    x = randn((R, in_dim), gen)
    got = q4_matmul(x, ws[0].packed, ws[0].scale)
    torch.cuda.synchronize()
    ref = q4_matmul_plain(x, ws[0].packed, ws[0].scale)
    limits = (K8_ATOL, K8_RTOL, K8_REL_L2)
    what = f"K8 {what} R={R} out={out_dim} in={in_dim}"
    worst = kernel_err(got, ref, what, limits=limits)
    errs["K8"] = max(errs["K8"], worst)
    split = k8_split(R, in_dim, out_dim, G)
    kernel_err(k8_last_split_dropped(x, ws[0].packed, ws[0].scale), ref,
               what + f", the last of {-(-G // split)} splits dropped", planted=True,
               limits=limits)
    ms, _ = cuda_ms(cycle_calls(ws, lambda w: q4_matmul(x, w.packed, w.scale)), iters=64)
    plain, _ = cuda_ms(lambda: q4_matmul_plain(x, ws[0].packed, ws[0].scale),
                       iters=1, warmup=1)
    lib_w = [tinygemm_pack(w) for w in ws]
    library_err(torch._weight_int4pack_mm(x, *lib_w[0]), ref,
                what + ", torch._weight_int4pack_mm (bf16 output)", limit=TINYGEMM_REL_L2)
    lib_ms, _ = cuda_ms(cycle_calls(lib_w, lambda w: torch._weight_int4pack_mm(x, *w)),
                        iters=64)
    b_ms, b_by = bound_ms(*k8_work(R, in_dim, out_dim, G, half))
    log(f"{what}: {ms:.4f} ms (split {split}; plain {plain:.2f}, torch._weight_int4pack_mm "
        f"{lib_ms:.4f}, bound {b_ms:.4f} by {b_by}; {len(ws)} copies cycled)")
    return dict(shape=f"x [{R},{in_dim}], packed [{G},{out_dim},{half}]", ms=ms,
                plain_ms=plain, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=worst)


def prompt_b_ids(tk, vocab) -> list:
    """Request B's prompt (``prompts``), without an engine."""
    from llama_nuts_and_bolts_tpu_torch.tokenizer import encode_ordinary

    return [vocab.bos_id] + encode_ordinary(long_text(), tk.mergeable_ranks)[:2999]


def tp_rank_kernels(errs, results) -> dict:
    """Phase A: the kernels at one tp rank's shapes of Llama-3.1-8B, tp 2 and
    4: K1 at requests B's and A's prefills, K2 and K4 at their first decode
    steps (K4 must still form thread-block clusters at B * KV = 2 and 1),
    K8 on each of a rank's int4 weights at R = 1, the vocab-sharded head
    included (64128 and 32064 rows); the head at tp 8 (16032 rows, not whole
    out tiles of 64) takes the dense route of ``ops/linear.py``, which
    launches no K8 and computes K8's function to the library's limit. Each against its plain version, planted faults
    read against the same limits, timed beside the bound and the library."""
    from llama_nuts_and_bolts_tpu_torch.kernels.q4_matmul import (
        k8_takes, q4_matmul, q4_matmul_plain)
    from llama_nuts_and_bolts_tpu_torch.ops.linear import linear
    from llama_nuts_and_bolts_tpu_torch.parallel.sharding import shard_params_for
    from llama_nuts_and_bolts_tpu_torch.quant import init_random_params_q4

    gen = torch.Generator(device="cuda").manual_seed(12)
    A, B = results["A"], results["B"]
    out = {"K1": [], "K2": [], "K4": [], "K8": []}
    for tp in TP_RANK_SHAPES:
        with rank_heads(tp):
            for S, T, what in ((B["prefill_len"], B["prefill_len"], "request B's prefill"),
                               (A["prefill_len"], A["cache_len"], "request A's prefill")):
                numbers, _ = time_k1(gen, errs, S, 0, T, f"tp {tp} rank, {what}")
                out["K1"].append(dict(tp=tp, max_abs_err=errs["K1"], **numbers))
                torch.cuda.empty_cache()
            for p, T, what in ((B["prompt"], B["cache_len"], "request B's first step"),
                               (A["prompt"], A["cache_len"], "request A's first step")):
                out["K2"].append(dict(tp=tp, max_abs_err=errs["K2"], **time_k2(
                    gen, errs, [p], T, f"tp {tp} rank, {what}")))
                k4 = time_k4_at(gen, errs, p, T, f"tp {tp} rank, {what}")
                if T >= 2048 and k4["cluster"] < 2:
                    check_failed(f"K4 at tp {tp}, T={T}: no thread-block cluster formed")
                out["K4"].append(dict(tp=tp, **k4))
    q4 = init_random_params_q4(cfg_8b(1), seed=0, device="cuda")
    for tp in TP_RANK_SHAPES + (8,):
        rank = shard_params_for(q4, 0, tp)
        names = ("wq", "wk", "wo", "w_gate", "w_down", "output") if tp != 8 else ("output",)
        for name in names:
            w = rank.output if name == "output" else rank.layers[name][0]
            what = f"tp {tp} rank's {name}"
            if not k8_takes(1, w.packed):
                # the dense route: unpack_q4 and a product, no K8 launch
                x = randn((1, 2 * w.packed.shape[0] * w.packed.shape[2]), gen)
                before = q4_matmul.launches
                dense = linear(x, w, out_dtype=torch.float32)
                if q4_matmul.launches != before:
                    check_failed(f"{what}: the dense route launched K8")
                rel = library_err(dense, q4_matmul_plain(x, w.packed, w.scale),
                                  f"{what} [{tuple(w.packed.shape)}], the dense route "
                                  "(unpack_q4 + mm) against K8's function",
                                  limit=TINYGEMM_REL_L2)
                ms, _ = cuda_ms(lambda: linear(x, w, out_dtype=torch.float32), iters=16)
                log(f"{what}: the dense route {ms:.4f} ms a call (no K8 launch)")
                out["K8"].append(dict(tp=tp, weight=name, route="dense (unpack_q4 + mm)",
                                      shape=f"packed {list(w.packed.shape)}", ms=ms,
                                      rel_l2_to_k8_function=rel))
                continue
            n_copies = max(1, -(-200 * 2**20 // w.packed.numel()))
            ws = [w] + [type(w)(packed=w.packed.clone(), scale=w.scale.clone())
                        for _ in range(n_copies - 1)]
            out["K8"].append(dict(tp=tp, weight=name, route="K8",
                                  **time_k8_at(gen, errs, ws, 1, what)))
            del ws
        del rank
    del q4
    torch.cuda.empty_cache()
    return out


# -- the child processes

def run_tp_children(phase: str, world: int, timeout: float = TP_CHILD_TIMEOUT_S) -> list:
    """Start ``world`` ranks of ``phase`` (``python3 chip_smoke.py --tp-rank
    PHASE RANK WORLD PORT DIR``), wait for all of them within ``timeout``
    (a rank still running then is killed, with the others), and return
    each rank's JSON result; a rank that failed fails the phase."""
    import tempfile

    from llama_nuts_and_bolts_tpu_torch.parallel.launch import free_port

    port = free_port()
    out = tempfile.mkdtemp(prefix=f"tp_{phase}_")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank",
                               phase, str(r), str(world), str(port), out], cwd=ROOT)
             for r in range(world)]
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        check_failed(f"phase {phase}: a rank ran past {timeout:.0f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(out, f"rank{r}.json")
        if p.returncode != 0:
            check_failed(f"phase {phase}: rank {r} exited with {p.returncode}")
        if not os.path.exists(path):
            results.append(None)
            continue
        # a rank that wrote its result and then failed (its teardown)
        # still reports its numbers; the failed check above stands
        with open(path) as f:
            results.append(json.load(f))
        for msg in results[-1].get("failed", []):
            check_failed(f"phase {phase} rank {r}: {msg}")
    return results


def tp_rank_main(phase: str, rank: int, world: int, port: int, out: str) -> int:
    """A rank of phase B, C, D, F, G or H: join the group, run, write
    rank<r>.json."""
    import torch.distributed as dist

    from llama_nuts_and_bolts_tpu_torch.parallel import initialize_multihost, make_mesh
    from llama_nuts_and_bolts_tpu_torch.parallel.launch import leave_group

    # phases C and G put two ranks on the one card: gloo (NCCL refuses a
    # duplicate device); the others drive a card a rank over NCCL
    shared = phase in ("C", "G")
    device = torch.device("cuda", 0 if shared else rank)
    torch.cuda.set_device(device)
    initialize_multihost(f"127.0.0.1:{port}", world, rank,
                         backend="gloo" if shared else "nccl")
    torch.cuda.reset_peak_memory_stats()
    tk, vocab = synthetic_tokenizer()
    mesh = make_mesh(tp=world)
    result = {"B": tp_phase_b, "C": tp_phase_c, "D": tp_phase_d, "F": tp_phase_f,
              "G": tp_phase_g, "H": tp_phase_h}[phase](mesh, rank, tk, vocab, device)
    result["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"phase {phase} rank {rank}: peak device memory {result['peak_memory_gib']:.2f} GiB")
    result["failed"] = list(FAILED)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    # every rank's work is done: a teardown that hangs dumps every thread's
    # stack and ends the rank (code 1) instead of holding the phase
    faulthandler.dump_traceback_later(TP_TEARDOWN_S, exit=True)
    dist.barrier()
    leave_group()
    faulthandler.cancel_dump_traceback_later()
    return 0


def graph_ms(engine, cache_len: int) -> dict:
    """The engine's one-step greedy graph of the ``cache_len`` bucket: the
    device ms of one replay (CUDA events over 16 replays), and the kernels
    one replay runs under torch.profiler, NCCL's apart (the launches the
    replays add to the counters are taken back). The slot's position moves
    on, inside its cache."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama_nuts_and_bolts_tpu_torch.runtime.decode_graph import uncounted

    key = next(k for k in engine._chunk_fns if k[:3] == (1, cache_len, "g"))
    graph = engine._chunk_fns[key]
    graph.slot.set([0], [cache_len // 2])
    with uncounted():
        ms, _ = cuda_ms(graph.replay, iters=16)
        if engine.mesh is not None:
            # the ranks start the profiled replay together, so that NCCL's
            # kernels do not count another rank's lag as their own time
            dist.barrier(group=engine.mesh.get_group("tp"))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return dict(ms=ms, kernels=sum(e.count for e in kernels),
                busy_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
                nccl_kernels=sum(e.count for e in nccl),
                nccl_ms=sum(e.self_device_time_total for e in nccl) / 1e3,
                top=[(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top])


def tp_phase_b(mesh, rank, tk, vocab, device) -> dict:
    """Phase B: one NCCL rank, the whole tp code path (``make_mesh(tp=1)``):
    the 32-layer 8B, bf16 and int4 weights with an int8 cache, requests A
    and B through ``generate_string`` on captured graphs, at decode_chunk
    auto and 8, on an engine with the mesh and one without: the tokens, the
    last step's logits and the launches must be equal, bit for bit; request
    B's prefill logits too, and a planted fault (the logits all-gather
    shifted by one shard row) must break that. The collectives' cost: the
    one-step graph's device ms with and without the mesh."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import (
        KVCache, LoadedModel, forward, init_random_params)
    from llama_nuts_and_bolts_tpu_torch.models.llama import model as mod
    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params
    from llama_nuts_and_bolts_tpu_torch.quant import init_random_params_q4
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    cfg = cfg_8b(32)
    L = cfg.n_layers
    out = {}
    for kind in ("bf16", "int4"):
        t0 = time.perf_counter()
        params = (init_random_params(cfg, seed=0, device=device) if kind == "bf16"
                  else init_random_params_q4(cfg, seed=0, device=device))
        log(f"phase B, {kind}: 8B random init {time.perf_counter() - t0:.1f}s")
        models = {m: LoadedModel(params=shard_params(params, mesh) if m == "mesh" else params,
                                 cfg=cfg, vocab=vocab, mergeable_ranks=tk.mergeable_ranks,
                                 tensor_meta={}) for m in ("plain", "mesh")}
        kv = "bf16" if kind == "bf16" else "int8"

        def expect(steps, prefill_len):
            if kind == "bf16":
                return {"K1": L, "K2": L * steps}
            k8_prefill = 7 * L + 1 if prefill_len <= 32 else 1
            return {"K8": k8_prefill + (7 * L + 1) * steps, "K4": L * steps}

        res = out[kind] = {}
        for chunk in (0, 8):
            engines = {m: InferenceEngine(models[m], InferenceArgs(
                sequence_length=8192, kv_cache_dtype=kv, decode_chunk=chunk), device=device,
                mesh=mesh if m == "mesh" else None) for m in models}
            chat, long_prompt, _ = prompts(engines["plain"], vocab)
            k = max(1, chunk)
            for key, tokens, n in (("A", chat, 64), ("B", long_prompt, 32)):
                runs = {m: run_request(e, tokens, n, expect, f"phase B {kind} request {key} "
                                       f"at decode_chunk {k}, {m} engine", captures=(k,))
                        for m, e in engines.items()}
                cache_len = runs["plain"]["cache_len"]
                logits = {m: e._slots[(1, cache_len)][0].logits for m, e in engines.items()}
                same = (runs["plain"]["ids"] == runs["mesh"]["ids"]
                        and torch.equal(logits["plain"], logits["mesh"])
                        and runs["plain"]["launches"] == runs["mesh"]["launches"])
                log(f"phase B {kind} request {key} at decode_chunk {k}: tokens, last "
                    f"logits and launches {'bit-equal' if same else 'DIFFER'} with and "
                    f"without the mesh")
                if not same:
                    check_failed(f"phase B {kind} {key} k={k}: the mesh engine differs")
                res[f"{key}_k{k}"] = {m: {f: r[f] for f in ("ttft_ms", "decode_tok_s",
                                                             "launches", "generated")}
                                      for m, r in runs.items()}
                if key == "B" and chunk == 0:
                    g = res["one_step_graph"] = {m: graph_ms(e, cache_len)
                                                 for m, e in engines.items()}
                    log(f"phase B {kind}: one-step graph at bucket {cache_len}: "
                        f"{g['plain']['ms']:.4f} ms without the mesh, {g['mesh']['ms']:.4f} "
                        f"with it (2 * {L} all-reduces + the logits all-gather: "
                        f"{g['mesh']['ms'] - g['plain']['ms']:+.4f} ms); kernels a replay "
                        f"{g['plain']['kernels']} and {g['mesh']['kernels']}, of them NCCL's "
                        f"{g['mesh']['nccl_kernels']} ({g['mesh']['nccl_ms']:.4f} ms)")
            del engines
        # request B's prefill, eager, with and without the mesh, and with the
        # logits all-gather shifted by one row (the planted fault)
        padded = torch.zeros((1, 4096), dtype=torch.int32, device=device)
        padded[0, :len(long_prompt)] = torch.tensor(long_prompt, dtype=torch.int32)
        impl = "flash" if kind == "bf16" else "plain"
        sound_gather = mod.gather_last
        got = {}
        for name, m, gather in (("plain", "plain", sound_gather), ("mesh", "mesh", sound_gather),
                                ("shifted", "mesh", lambda x, mesh_: torch.roll(
                                    sound_gather(x, mesh_), 1, -1))):
            cache = KVCache.create(cfg, 1, 4096, device=device,
                                   dtype=torch.int8 if kv == "int8" else torch.bfloat16)
            mod.gather_last = gather
            try:
                got[name], _ = forward(models[m].params, cfg, padded, 0, cache, attn_impl=impl,
                                       logits_at=len(long_prompt) - 1,
                                       mesh=mesh if m == "mesh" else None)
            finally:
                mod.gather_last = sound_gather
            del cache
        res["prefill_bit_equal"] = torch.equal(got["plain"], got["mesh"])
        res["planted_shift_bit_equal"] = torch.equal(got["plain"], got["shifted"])
        log(f"phase B {kind}: request B's prefill logits with the mesh "
            f"{'bit-equal' if res['prefill_bit_equal'] else 'DIFFER'}; planted fault "
            f"(all-gather shifted one row): "
            f"{'bit-equal (NOT caught)' if res['planted_shift_bit_equal'] else 'differs'}")
        if not res["prefill_bit_equal"]:
            check_failed(f"phase B {kind}: prefill logits differ with the mesh")
        if res["planted_shift_bit_equal"]:
            check_failed(f"phase B {kind}: the shifted all-gather was not caught")
        del models, params, got
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def wo_all_reduce_skipped(rank: int):
    """Phases C and D's planted fault: rank 1 keeps its own partial product
    after each ``wo`` all-reduce (the first of a block's two). The
    collective still runs, so every rank makes the same calls and none
    waits for a missing one."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import model as mod

    sound = mod.reduce_partial
    calls = {"n": 0}

    def wo_skipped(partial, mesh_, dtype_):
        i = calls["n"]
        calls["n"] += 1
        mine = partial.clone()
        summed = sound(partial, mesh_, dtype_)
        return mine.to(dtype_) if rank == 1 and i % 2 == 0 else summed

    mod.reduce_partial = wo_skipped
    try:
        yield
    finally:
        mod.reduce_partial = sound


def tp_phase_c(mesh, rank, tk, vocab, device) -> dict:
    """Phase C: two gloo ranks on the one card, eager ``forward`` only (no
    graphs: gloo's collectives cannot be captured): the 32-layer 8B sharded
    over tp 2, request B's prefill (K1 at 4 KV heads a rank) and 8 decode
    steps (K2), and the int4 + int8-KV model (prefill on the plain path,
    decode on K8 and K4), against the unsharded forward that rank 0 runs
    first, per logits row within TP_REL_L2; then again with a planted fault,
    rank 1 keeping its own partial after each wo all-reduce, which must
    fail the limit."""
    import torch.distributed as dist

    from llama_nuts_and_bolts_tpu_torch.models.llama import (
        KVCache, forward, init_random_params)
    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params, tp_size
    from llama_nuts_and_bolts_tpu_torch.quant import init_random_params_q4

    cfg = cfg_8b(32)
    tp = tp_size(mesh)
    ids = prompt_b_ids(tk, vocab)
    out = {}
    for kind in ("bf16", "int4"):
        whole = (init_random_params(cfg, seed=0, device=device) if kind == "bf16"
                 else init_random_params_q4(cfg, seed=0, device=device))
        shard = shard_params(whole, mesh)
        dtype = torch.bfloat16 if kind == "bf16" else torch.int8
        prefill_impl = "flash" if kind == "bf16" else "plain"
        padded = torch.zeros((1, 4096), dtype=torch.int32, device=device)
        padded[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)

        def run(params, mesh_, feed):
            """Request B's prefill, then a decode step per token of ``feed``
            (greedy tokens of the reference when ``feed`` is None)."""
            cache = KVCache.create(cfg, 1, 4096, device=device, dtype=dtype,
                                   tp=tp_size(mesh_))
            logits, _ = forward(params, cfg, padded, 0, cache, attn_impl=prefill_impl,
                                logits_at=len(ids) - 1, mesh=mesh_)
            rows, toks = [logits[0, 0]], []
            for i in range(TP_DECODE_STEPS):
                tok = int(torch.argmax(rows[-1])) if feed is None else feed[i]
                toks.append(tok)
                step = torch.tensor([[tok]], dtype=torch.int32, device=device)
                logits, _ = forward(params, cfg, step, len(ids) + i, cache,
                                    attn_impl="flash", mesh=mesh_)
                rows.append(logits[0, 0])
            return torch.stack(rows), toks

        if rank == 0:
            ref, feed = run(whole, None, None)
        del whole
        torch.cuda.empty_cache()
        feed_t = torch.tensor(feed if rank == 0 else [0] * TP_DECODE_STEPS, device=device)
        dist.broadcast(feed_t, src=0)
        feed = feed_t.tolist()
        got, _ = run(shard, mesh, feed)
        with wo_all_reduce_skipped(rank):
            planted, _ = run(shard, mesh, feed)
        res = out[kind] = {}
        if rank == 0:
            errs = [rel_l2(g, r) for g, r in zip(got, ref)]
            bad = [rel_l2(g, r) for g, r in zip(planted, ref)]
            limit = TP_REL_L2[kind]
            res.update(rel_l2=errs, planted_rel_l2=bad, limit=limit)
            log(f"phase C {kind}, tp {tp} on one card over gloo, 32 layers: relative L2 "
                f"per row (prefill, then {TP_DECODE_STEPS} decode steps) "
                f"{[f'{e:.2e}' for e in errs]}; planted fault (rank 1 skips its wo "
                f"all-reduce) {[f'{e:.2e}' for e in bad]} (limit {limit})")
            if not (max(errs) <= limit and bool(torch.isfinite(got).all())):
                check_failed(f"phase C {kind}: the sharded forward is outside {limit}")
            if min(bad) <= limit:
                check_failed(f"phase C {kind}: the planted fault passes {limit}")
        del shard, got, planted
        torch.cuda.empty_cache()
    return out


def tp_phase_d(mesh, rank, tk, vocab, device) -> dict:
    """Phase D: NCCL at tp = the world, one card a rank, on the CLI's process
    model: rank 0 broadcasts each request's token ids over a gloo control
    group (``parallel.launch.broadcast``) and every rank runs the same engine calls
    in lockstep. The 32-layer 8B constructed-cyclic model (``cyclic_params``:
    wo and w_down zeroed, head rows walking 0..7), bf16; requests A and B
    with their last token set to 0, so greedy decoding walks the cycle from
    1. Rank 0 first runs the same requests on the whole model on its card:
    every rank's tokens must equal them and the cycle. Records TTFT, decode
    tok/s, launches per rank, the one-step graph's device ms."""
    import torch.distributed as dist

    from llama_nuts_and_bolts_tpu_torch.parallel.launch import broadcast
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel, init_random_params
    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params, tp_size
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    cfg = cfg_8b(32)
    L, tp = cfg.n_layers, tp_size(mesh)
    control = dist.new_group(backend="gloo")
    whole = cyclic_params(init_random_params(cfg, seed=0, device=device), SPEC_CYCLE)

    def loaded(params):
        return LoadedModel(params=params, cfg=cfg, vocab=vocab,
                           mergeable_ranks=tk.mergeable_ranks, tensor_meta={})

    def expect(steps, prefill_len):
        return {"K1": L, "K2": L * steps}

    out = {"tp": tp, "single": {}, "mesh": {}}
    requests = None
    if rank == 0:
        single = InferenceEngine(loaded(whole), InferenceArgs(sequence_length=8192),
                                 device=device)
        chat, long_prompt, _ = prompts(single, vocab)
        requests = {"A": (chat[:-1] + [0], 64), "B": (long_prompt[:-1] + [0], 32)}
        for key, (tokens, n) in requests.items():
            r = run_request(single, tokens, n, expect, f"phase D request {key}, "
                            "the whole model on one card", captures=(1,))
            out["single"][key] = {f: r[f] for f in ("ids", "ttft_ms", "decode_tok_s",
                                                    "launches")}
        out["single"]["one_step_graph"] = graph_ms(single, 4096)
        del single
    requests = broadcast(requests, control)
    engine = InferenceEngine(loaded(shard_params(whole, mesh)),
                             InferenceArgs(sequence_length=8192), device=device, mesh=mesh)
    del whole
    torch.cuda.empty_cache()
    for key, (tokens, n) in requests.items():
        r = run_request(engine, tokens, n, expect, f"phase D request {key}, tp {tp} rank "
                        f"{rank}", captures=(1,))
        out["mesh"][key] = {f: r[f] for f in ("ids", "ttft_ms", "decode_tok_s", "launches")}
        cycle = [(i + 1) % SPEC_CYCLE for i in range(len(r["ids"]))]
        if r["ids"] != cycle:
            check_failed(f"phase D request {key} rank {rank}: tokens leave the cycle")
    g = out["mesh"]["one_step_graph"] = graph_ms(engine, 4096)
    log(f"phase D rank {rank}: one-step graph at bucket 4096 {g['ms']:.4f} ms at tp {tp}, "
        f"{g['kernels']} kernels a replay, of them NCCL's {g['nccl_kernels']} "
        f"({g['nccl_ms']:.4f} ms)")
    del engine
    torch.cuda.empty_cache()
    out["graph_logits"] = tp_graph_logits(mesh, rank, control, cfg, prompt_b_ids(tk, vocab),
                                          4096, tk, vocab, device)
    broadcast(None, control)          # the CLI's quit sentinel
    return out


def tp_graph_logits(mesh, rank, control, cfg, ids, cache_len, tk, vocab, device) -> dict:
    """Phase D's check of the sharded arithmetic through the captured graphs
    (the cyclic model's tokens ignore attention, wo and w_down): random bf16
    weights (seed 0), the prefill of ``ids`` (eager) and TP_DECODE_STEPS
    decode steps, each a replay of the mesh engine's one-step graph with its
    all-reduces and logits all-gather inside, fed the tokens of the
    unsharded eager forward that rank 0 runs first. Every logits row must
    lie within phase C's TP_REL_L2 of that forward's, and every rank's rows
    must be bit-equal to rank 0's. Then again with phase C's planted fault
    captured into a fresh graph (rank 1 keeps its own partial after each wo
    all-reduce), which must fail the limit."""
    import torch.distributed as dist

    from llama_nuts_and_bolts_tpu_torch.parallel.launch import broadcast
    from llama_nuts_and_bolts_tpu_torch.models.llama import (
        KVCache, LoadedModel, forward, init_random_params)
    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params, tp_size
    from llama_nuts_and_bolts_tpu_torch.parallel.mesh import tp_group
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.runtime.decode_graph import DecodeGraph, DecodeSlot

    tp = tp_size(mesh)
    whole = init_random_params(cfg, seed=0, device=device)
    engine = InferenceEngine(LoadedModel(params=shard_params(whole, mesh), cfg=cfg,
                                         vocab=vocab, mergeable_ranks=tk.mergeable_ranks,
                                         tensor_meta={}),
                             InferenceArgs(sequence_length=2 * cache_len), device=device,
                             mesh=mesh)
    prefill_impl = engine._attn_impl(len(ids), cache_len)
    step_impl = engine._attn_impl(1, cache_len)
    padded = torch.zeros((1, cache_len), dtype=torch.int32, device=device)
    padded[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    feed = ref = None
    if rank == 0:
        cache = KVCache.create(cfg, 1, cache_len, device=device)
        logits, _ = forward(whole, cfg, padded, 0, cache, attn_impl=prefill_impl,
                            logits_at=len(ids) - 1)
        rows, feed = [logits[0, 0]], []
        for i in range(TP_DECODE_STEPS):
            feed.append(int(torch.argmax(rows[-1])))
            step = torch.tensor([[feed[-1]]], dtype=torch.int32, device=device)
            logits, _ = forward(whole, cfg, step, len(ids) + i, cache, attn_impl=step_impl)
            rows.append(logits[0, 0])
        ref = torch.stack(rows)
        del cache
    del whole
    torch.cuda.empty_cache()
    feed = broadcast(feed, control)

    def graph_run(index: int) -> torch.Tensor:
        """The prefill into a fresh slot, then a replay of its one-step
        graph per token of ``feed``: the logits rows."""
        slot = DecodeSlot(engine, 1, cache_len, index)
        graph = DecodeGraph(engine, slot, 1)
        logits, _ = forward(engine.model.params, cfg, padded, 0, slot.cache,
                            attn_impl=prefill_impl, logits_at=len(ids) - 1, mesh=mesh)
        rows = [logits[0, 0]]
        for i, tok in enumerate(feed):
            slot.set([tok], [len(ids) + i])
            graph.replay()
            rows.append(slot.logits[0].clone())
        return torch.stack(rows)

    got = graph_run(0)
    with wo_all_reduce_skipped(rank):
        planted = graph_run(1)
    first = got.clone()
    dist.broadcast(first, src=0, group=tp_group(mesh))
    res = {"tp": tp, "rows_equal_rank0": torch.equal(first, got),
           "attn_impl": [prefill_impl, step_impl]}
    if not res["rows_equal_rank0"]:
        check_failed(f"phase D rank {rank}: the graph's logits differ from rank 0's")
    if rank == 0:
        errs = [rel_l2(g, r) for g, r in zip(got, ref)]
        bad = [rel_l2(g, r) for g, r in zip(planted, ref)]
        limit = TP_REL_L2["bf16"]
        res.update(rel_l2=errs, planted_rel_l2=bad, limit=limit)
        log(f"phase D, tp {tp}, random bf16 weights through the captured one-step graph: "
            f"relative L2 per row (prefill, then {TP_DECODE_STEPS} replays) against the "
            f"single-card forward {[f'{e:.2e}' for e in errs]}; planted fault (rank 1 "
            f"skips its wo all-reduce) {[f'{e:.2e}' for e in bad]} (limit {limit})")
        if not (max(errs) <= limit and bool(torch.isfinite(got).all())):
            check_failed(f"phase D: the graph's sharded logits are outside {limit}")
        if min(bad) <= limit:
            check_failed(f"phase D: the planted fault passes {limit}")
    del engine
    torch.cuda.empty_cache()
    return res


# -- phases E-H (22-25): tensor parallelism for serving
#
# E: K6 through tp_paged_flash_decode at one rank's shapes, in this process.
# F: one NCCL rank (make_mesh(tp=1)) through the server over HTTP, against the
#    same server without a mesh, in a child process.
# G: two gloo ranks on the one card, the eager paged model functions against
#    the unsharded ones, in child processes.
# H: the server at --tp min(4, cards) over NCCL, when there are 2 cards or
#    more, in child processes; one card: a line says it did not run.

TP_PAGED_CASES = (("B=4 at [3, 700, 2047, 1000]", [3, 700, 2047, 1000]),
                  ("B=4 at 114", [114] * 4), ("every row at 2047", [2047] * 4),
                  ("B=1 at 1850", [1850]))
# Phase F: 8B width at SERVE_LAYERS_F layers (the server's host work a step
# shrinks with depth, so three configurations twice fit the phase's time)
SERVE_LAYERS_F = 4
# Phase G: request B's prompt, then request C (its first 2048 tokens and
# 500 of its own: a prefix-cache hit of 64 blocks), TP_DECODE_STEPS decode
# steps of both rows on K6, one verify step of SPEC_K + 1 rows a slot. The
# limits per logits row, between the sound reading and the planted fault's
# (rank 1 skips its wo all-reduce), as phase C's (PERF.md).
TP_PAGED_REL_L2 = {"bf16": 0.1, "int4": 5e-4}
H_PROFILE_AT, H_PROFILE_STEPS = 16, 8     # phase H's profiled batched steps


def tp_rank_paged(errs) -> list:
    """Phase E: K6 and its int8 mode through ``tp_paged_flash_decode`` at
    one rank's shapes of Llama-3.1-8B (tp 2: H 16, KV 4; tp 4: H 8, KV 2),
    on a 32-layer pool of 32-position blocks, scattered tables of 64
    entries, at PERF.md's shapes (TP_PAGED_CASES), each against its plain
    version under the kernel limits, with the planted last-split fault,
    timed (layers cycled) beside its bound and the gather path."""
    from llama_nuts_and_bolts_tpu_torch.kernels.paged_attention import (
        paged_chunk, paged_flash_decode_int8_plain, paged_flash_decode_plain, paged_split)
    from llama_nuts_and_bolts_tpu_torch.models.llama.paged import _gathered_attention
    from llama_nuts_and_bolts_tpu_torch.parallel.kernel_shard import tp_paged_flash_decode

    gen = torch.Generator(device="cuda").manual_seed(22)
    rows, M, L = [], 64, 32
    for tp in TP_RANK_SHAPES:
        with rank_heads(tp):
            for int8 in (False, True):
                n_blocks = 4 * M + 1
                shape = (L, n_blocks, KV, BS, D)
                if int8:
                    (k, ks), (v, vs) = (int8_cache(shape, gen) for _ in range(2))
                    scales = dict(pool_ks=ks, pool_vs=vs)
                else:
                    k, v, ks, vs, scales = randn(shape, gen), randn(shape, gen), None, None, {}
                for label, positions in TP_PAGED_CASES:
                    B = len(positions)
                    tables = scattered_tables(B, M, n_blocks, seed=B + tp)
                    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
                    q = randn((B, 1, H, D), gen)

                    def plain(p, li=0):
                        if int8:
                            return paged_flash_decode_int8_plain(q, k, v, ks, vs, tables, p, li)
                        return paged_flash_decode_plain(q, k, v, tables, p, li,
                                                        paged_chunk(M, BS))

                    what = (f"K6 {'int8' if int8 else 'bf16'} through tp_paged_flash_decode, "
                            f"tp {tp} rank (H {H}, KV {KV}), {label}")
                    got = tp_paged_flash_decode(None, q, k, v, tables, pos, layer=0, **scales)
                    torch.cuda.synchronize()
                    ref = plain(pos)
                    tag = "K6i8" if int8 else "K6"
                    errs[tag] = max(errs[tag], kernel_err(got, ref, what))
                    rule = paged_split(B, KV, M, BS)
                    if max(positions) // BS + 1 > rule:      # two splits or more
                        kernel_err(tp_paged_flash_decode(
                            None, q, k, v, tables, last_split_dropped(pos, M, rule),
                            layer=0, **scales), ref,
                            f"{what}, the last active split of {rule} entries dropped",
                            planted=True)
                    state = {"li": 0}

                    def cycled(fn):
                        def call():
                            state["li"] = (state["li"] + 1) % L
                            return fn(state["li"])
                        return call

                    ms, _ = cuda_ms(cycled(lambda li: tp_paged_flash_decode(
                        None, q, k, v, tables, pos, layer=li, **scales)), iters=64)
                    gather, _ = cuda_ms(cycled(lambda li: _gathered_attention(
                        q, k[li], v[li], tables, pos,
                        *((ks[li], vs[li]) if int8 else ()))), iters=16)
                    plain_ms, _ = cuda_ms(lambda: plain(pos), iters=1, warmup=1)
                    b_ms, b_by = bound_ms(*paged_work(positions, int8))
                    log(f"{what}: {ms:.4f} ms (split {rule}; plain {plain_ms:.2f}, gather "
                        f"path {gather:.4f}, bound {b_ms:.4f} by {b_by})")
                    rows.append(dict(tp=tp, kernel=tag, case=label, ms=ms, plain_ms=plain_ms,
                                     gather_path_ms=gather, bound_ms=b_ms, bound_by=b_by,
                                     max_abs_err=errs[tag]))
                del k, v, ks, vs
                torch.cuda.empty_cache()
    return rows


def gated_traffic(srv, url, reqs) -> dict:
    """``reqs`` through ``srv`` with the batcher held at its next step until
    every request is submitted, one after another, so the batched steps
    depend on nothing but the requests: the texts, the steps and the
    launches are then the same on any server that computes alike. Returns
    the results and the host ms of each batched step."""
    from concurrent.futures import ThreadPoolExecutor

    b = srv.batcher
    gate, submitted, step_ms = threading.Event(), [0], []
    submit, step = b.submit, b.step

    def counted_submit(*a, **kw):
        req = submit(*a, **kw)
        submitted[0] += 1
        return req

    def gated_step():
        gate.wait()
        t0 = time.perf_counter()
        step()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    b.submit, b.step = counted_submit, gated_step
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(reqs)) as pool:
            futures = []
            for i, (_, path, body, stream) in enumerate(reqs):
                futures.append(pool.submit(sse_request, url + path, body, stream))
                deadline = time.perf_counter() + 60
                while submitted[0] <= i and time.perf_counter() < deadline:
                    time.sleep(0.001)
            gate.set()
            results = [f.result() for f in futures]
    finally:
        gate.set()
        b.submit, b.step = submit, step
    return dict(results=results, wall_s=time.perf_counter() - t0, step_ms=step_ms)


F_CONFIGS = (("bf16 pool, n-gram speculation k = 4", dict(kv="bf16", paged=True, spec=SPEC_K)),
             ("int8 pool (K6's int8 mode)", dict(kv="int8", paged=True, spec=0)),
             ("dense batcher, int4 weights, int8 cache", dict(kv="int8", paged=False, spec=0,
                                                             quant="int4")))


def tp_phase_f(mesh, rank, tk, vocab, device) -> dict:
    """Phase F: one NCCL rank (``make_mesh(tp=1)``) through the server over
    HTTP, 8B width at SERVE_LAYERS_F layers, serving_requests' traffic
    submitted in order (``gated_traffic``) on each of F_CONFIGS: the
    bf16-pool paged batcher speculating (K6), the int8 pool (K6's int8
    mode), the dense batcher on int4 weights and an int8 cache (K8, K4);
    each on a server without a mesh and one with it. Texts, /metrics counts
    and launches must be equal; the step record's cost reads in the host
    ms of a batched step with and without the mesh."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel, init_random_params
    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params
    from llama_nuts_and_bolts_tpu_torch.quant import init_random_params_q4
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.serving.server import LlamaHTTPServer

    cfg = cfg_8b(SERVE_LAYERS_F)
    out = {}
    for name, c in F_CONFIGS:
        params = (init_random_params_q4(cfg, seed=0, device=device) if c.get("quant")
                  else init_random_params(cfg, seed=0, device=device))
        runs = {}
        for m in (None, mesh):
            p = params if m is None else shard_params(params, m)
            engine = InferenceEngine(
                LoadedModel(params=p, cfg=cfg, vocab=vocab, mergeable_ranks=tk.mergeable_ranks,
                            tensor_meta={}),
                InferenceArgs(sequence_length=SERVE_CONTEXT, kv_cache_dtype=c["kv"],
                              speculate_k=c["spec"],
                              attn_impl="flash" if c["paged"] and c["kv"] == "int8" else "auto"),
                device=device, mesh=m)
            srv = LlamaHTTPServer(engine, continuous_slots=SERVE_SLOTS,
                                  paged_blocks=SERVE_BLOCKS if c["paged"] else 0)
            srv.prewarm()
            url = f"http://127.0.0.1:{srv.start_background()}"
            reset_counts()
            traffic = gated_traffic(srv, url, serving_requests(int8=c["kv"] == "int8"))
            torch.cuda.synchronize()
            counts = {k: n for k, n in read_counts().items() if n}
            metrics = {line.split()[0]: line.split()[1]
                       for line in srv.render_metrics().splitlines()
                       if line.startswith("llama_") and "inflight" not in line
                       and "seconds" not in line}
            srv.shutdown()
            tokens = float(metrics["llama_tokens_generated_total"])
            steps = traffic["step_ms"]
            runs["mesh" if m is not None else "plain"] = r = dict(
                texts=[res[1] for res in traffic["results"]],
                statuses=[res[0] for res in traffic["results"]], metrics=metrics,
                launches=counts, aggregate_tok_s=tokens / traffic["wall_s"],
                host_ms_per_step=sum(steps) / max(1, len(steps)), steps=len(steps))
            log(f"phase F, {name}, {'mesh' if m is not None else 'no mesh'}: "
                f"{r['aggregate_tok_s']:.2f} tok/s, {len(steps)} batched steps of "
                f"{r['host_ms_per_step']:.3f} host ms, launches {counts}")
            del srv, engine, p
            torch.cuda.empty_cache()
        same = {f: runs["plain"][f] == runs["mesh"][f]
                for f in ("texts", "statuses", "metrics", "launches")}
        log(f"phase F, {name}: texts, /metrics counts and launches with the mesh "
            f"{'equal' if all(same.values()) else 'DIFFER: ' + str(same)} to those without; "
            f"a batched step {runs['mesh']['host_ms_per_step'] - runs['plain']['host_ms_per_step']:+.3f} "
            "host ms with the step record")
        if not all(same.values()):
            check_failed(f"phase F {name}: the mesh server differs ({same})")
        if any(s != 200 for s in runs["mesh"]["statuses"]):
            check_failed(f"phase F {name}: statuses {runs['mesh']['statuses']}")
        out[name] = {m: {f: v for f, v in r.items() if f not in ("texts", "statuses")}
                     for m, r in runs.items()}
        del params
        torch.cuda.empty_cache()
    return out


def paged_g_run(params, cfg, mesh, pool, ids_b, ids_c, feed, device):
    """Phase G's sequence on ``params`` and ``pool`` (shards under ``mesh``):
    request B's prefill into blocks 1.., request C's prefill of its suffix
    after a 2048-token hit on B's blocks, TP_DECODE_STEPS decode steps of
    both on K6 ("flash"), one verify step of SPEC_K + 1 rows a slot; the
    tokens fed are ``feed`` (the reference's greedy ones when None). The
    logits rows and the tokens."""
    from llama_nuts_and_bolts_tpu_torch.models.llama.paged import (
        paged_decode_step, paged_decode_step_spec, paged_prefill, paged_prefill_shared)

    M, shared = 128, 2048
    nb_b = -(-(len(ids_b) + TP_DECODE_STEPS + SPEC_K + 1) // BS)
    table_b = torch.zeros(M, dtype=torch.int32, device=device)
    table_b[:nb_b] = torch.arange(1, nb_b + 1, dtype=torch.int32)
    table_c = table_b.clone()
    nb_c = -(-(len(ids_c) + TP_DECODE_STEPS + SPEC_K + 1) // BS)
    table_c[shared // BS:nb_c] = torch.arange(nb_b + 1, nb_b + 1 + nb_c - shared // BS,
                                              dtype=torch.int32)

    def padded(ids):
        t = torch.zeros((1, -(-len(ids) // BS) * BS), dtype=torch.int32, device=device)
        t[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
        return t

    rows, toks = [], []
    logits, _ = paged_prefill(params, cfg, padded(ids_b), len(ids_b) - 1, pool, table_b,
                              mesh=mesh)
    rows.append(logits[0])
    suffix = ids_c[shared:]
    logits, _ = paged_prefill_shared(params, cfg, padded(suffix), shared, len(suffix) - 1,
                                     pool, table_c, mesh=mesh)
    rows.append(logits[0])
    tables = torch.stack([table_b, table_c])
    pos = torch.tensor([len(ids_b), len(ids_c)], dtype=torch.int32, device=device)
    last = torch.stack([rows[0], rows[1]])
    for i in range(TP_DECODE_STEPS + 1):
        step = (torch.argmax(last, -1).to(torch.int32) if feed is None else
                torch.tensor(feed[i], dtype=torch.int32, device=device))
        toks.append(step.tolist())
        if i == TP_DECODE_STEPS:
            break
        last, _ = paged_decode_step(params, cfg, step[:, None], pos + i, pool, tables,
                                    "flash", mesh=mesh)
        rows += list(last)
    drafts = torch.tensor([[(t + j) % 1000 for j in range(1, SPEC_K + 1)]
                           for t in toks[-1]], dtype=torch.int32, device=device)
    verify = torch.cat([torch.tensor(toks[-1], dtype=torch.int32, device=device)[:, None],
                        drafts], dim=1)
    logits, _ = paged_decode_step_spec(params, cfg, verify, pos + TP_DECODE_STEPS, pool,
                                       tables, mesh=mesh)
    rows += list(logits.reshape(-1, logits.shape[-1]))
    return torch.stack(rows), toks


def tp_phase_g(mesh, rank, tk, vocab, device) -> dict:
    """Phase G: two gloo ranks on the one card, the eager paged model
    functions on a rank's shards of the 32-layer 8B and of the pool
    (``paged_g_run``: prefill, shared prefill, decode on K6 at 4 KV heads a
    rank, the verify step), bf16 weights and pool, then int4 weights and an
    int8 pool (K8, K6's int8 mode), against the unsharded functions that
    rank 0 runs first, per logits row within TP_PAGED_REL_L2; then again
    with rank 1 skipping its wo all-reduce, which must fail the limit. No
    engine: the engine rightly refuses gloo on a card."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import init_random_params
    from llama_nuts_and_bolts_tpu_torch.models.llama.paged import PagedKVPool
    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params, tp_size
    from llama_nuts_and_bolts_tpu_torch.parallel.launch import broadcast, new_control_group
    from llama_nuts_and_bolts_tpu_torch.quant import init_random_params_q4

    cfg = cfg_8b(32)
    tp = tp_size(mesh)
    control = new_control_group()
    ids_b = prompt_b_ids(tk, vocab)
    ids_c = ids_b[:2048] + [(t * 7 + 3) % 100000 for t in ids_b[2048:2548]]
    out = {}
    for kind in ("bf16", "int4"):
        whole = (init_random_params(cfg, seed=0, device=device) if kind == "bf16"
                 else init_random_params_q4(cfg, seed=0, device=device))
        shard = shard_params(whole, mesh)
        dtype = torch.bfloat16 if kind == "bf16" else torch.int8

        def pool(tp_):
            return PagedKVPool.create(cfg, 1 + 2 * 128, BS, dtype, device=device, tp=tp_)

        feed = ref = None
        if rank == 0:
            ref, feed = paged_g_run(whole, cfg, None, pool(1), ids_b, ids_c, None, device)
        del whole
        torch.cuda.empty_cache()
        feed = broadcast(feed, control)
        got, _ = paged_g_run(shard, cfg, mesh, pool(tp), ids_b, ids_c, feed, device)
        with wo_all_reduce_skipped(rank):
            planted, _ = paged_g_run(shard, cfg, mesh, pool(tp), ids_b, ids_c, feed, device)
        res = out[kind] = {}
        if rank == 0:
            errs = [rel_l2(g, r) for g, r in zip(got, ref)]
            bad = [rel_l2(g, r) for g, r in zip(planted, ref)]
            limit = TP_PAGED_REL_L2[kind]
            res.update(rel_l2_max=max(errs), rel_l2_min=min(errs), planted_min=min(bad),
                       planted_max=max(bad), rows=len(errs), limit=limit)
            log(f"phase G {kind}, tp {tp} on one card over gloo, 32 layers, paged: relative "
                f"L2 per row (B's prefill, C's shared prefill, {TP_DECODE_STEPS} decode steps "
                f"of 2 rows on K6, a verify step of 2 x {SPEC_K + 1} rows) {min(errs):.2e} to "
                f"{max(errs):.2e}; planted fault (rank 1 skips its wo all-reduce) "
                f"{min(bad):.2e} to {max(bad):.2e} (limit {limit})")
            if not (max(errs) <= limit and bool(torch.isfinite(got).all())):
                check_failed(f"phase G {kind}: the sharded paged functions are outside {limit}")
            if min(bad) <= limit:
                check_failed(f"phase G {kind}: the planted fault passes {limit}")
        del shard, got, planted
        torch.cuda.empty_cache()
    return out


def h_requests():
    """Phase H's traffic: four streamed completions of 64 tokens (beside
    them ``cancelled_stream`` sends the first again and leaves)."""
    reqs = [(f"completion {i}", "/v1/completions",
             {"prompt": f"Request {i} of the cyclic walk", "max_tokens": 64, "stream": True},
             True) for i in range(4)]
    return reqs


def cancelled_stream(url, body, chunks: int = 4) -> int:
    """A streamed request whose client goes away after ``chunks`` chunks."""
    import http.client
    from urllib.parse import urlparse

    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=600)
    conn.request("POST", "/v1/completions", json.dumps(dict(body, stream=True)))
    resp = conn.getresponse()
    seen = 0
    while seen < chunks:
        line = resp.fp.readline()
        seen += line.startswith(b"data: ")
    conn.sock.close()
    conn.close()
    return seen


class StepProbe:
    """Host wall of each batched step of a batcher on this rank, and its
    device time under torch.profiler over steps H_PROFILE_AT onward (the
    same steps on every rank: they run in lockstep). The profiler runs only
    where the steps run on the main thread, the followers': rank 0 steps
    in the server's batcher thread, where the profiler refuses to start
    ("External init callback must run in same thread as registerClient")."""

    def __init__(self, batcher, cuda: bool):
        self.ms, self.prof, self.kernels = [], None, None
        self.cuda = cuda
        self.inner = batcher._step_once
        batcher._step_once = self.step

    def step(self):
        from torch.profiler import ProfilerActivity, profile

        i = len(self.ms)
        if (self.cuda and i == H_PROFILE_AT
                and threading.current_thread() is threading.main_thread()):
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        t0 = time.perf_counter()
        self.inner()
        if self.cuda:
            torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        if self.prof is not None and i == H_PROFILE_AT + H_PROFILE_STEPS - 1:
            self.prof.__exit__(None, None, None)
            self.kernels = [e for e in self.prof.key_averages() if e.self_device_time_total > 0]
            self.prof = None

    def summary(self) -> dict:
        out = dict(steps=len(self.ms), host_ms_per_step=sum(self.ms) / max(1, len(self.ms)))
        if self.kernels:
            n = H_PROFILE_STEPS
            wall = sum(self.ms[H_PROFILE_AT:H_PROFILE_AT + n]) / n
            busy = sum(e.self_device_time_total for e in self.kernels) / 1e3 / n
            nccl = [e for e in self.kernels if "nccl" in e.key.lower()]
            out.update(profiled_wall_ms=wall, device_busy_ms=busy, idle=1 - busy / wall,
                       kernels_per_step=sum(e.count for e in self.kernels) // n,
                       nccl_kernels_per_step=sum(e.count for e in nccl) / n,
                       nccl_ms_per_step=sum(e.self_device_time_total for e in nccl) / 1e3 / n)
        return out


def h_servers(mesh, rank, params, cfg, tk, vocab, device) -> dict:
    """Phase H's servers on ``params`` (a rank's shards under ``mesh``):
    the paged and the dense batcher, each with h_requests' traffic at once
    and a request cancelled mid-stream, then the sequential server with a
    streamed request whose client leaves and a blocking one after it. Rank
    0 serves and returns each request's text and the aggregate tok/s;
    every rank returns its batched steps' StepProbe summary."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.serving.server import LlamaHTTPServer

    cuda = device.type == "cuda"
    model = LoadedModel(params=params, cfg=cfg, vocab=vocab, mergeable_ranks=tk.mergeable_ranks,
                        tensor_meta={})
    out = {}
    for kind, kw in (("paged", dict(continuous_slots=SERVE_SLOTS, paged_blocks=SERVE_BLOCKS)),
                     ("dense", dict(continuous_slots=SERVE_SLOTS)), ("sequential", {})):
        engine = InferenceEngine(model, InferenceArgs(sequence_length=SERVE_CONTEXT),
                                 device=device, mesh=mesh)
        srv = LlamaHTTPServer(engine, **kw)
        probe = StepProbe(srv.batcher, cuda) if srv.batcher is not None else None
        if rank != 0:
            srv.follow()
            out[kind] = {"steps": probe.summary() if probe else None}
            continue
        srv.prewarm()
        url = f"http://127.0.0.1:{srv.start_background()}"
        reset_counts()
        t0 = time.perf_counter()
        if srv.batcher is not None:
            from concurrent.futures import ThreadPoolExecutor

            reqs = h_requests()
            with ThreadPoolExecutor(max_workers=len(reqs) + 1) as pool:
                futures = [pool.submit(sse_request, url + path, body, stream)
                           for _, path, body, stream in reqs]
                cut = pool.submit(cancelled_stream, url, reqs[0][2])
                results = [f.result() for f in futures]
                cut.result()
        else:
            cancelled_stream(url, h_requests()[0][2])
            results = [sse_request(url + "/v1/completions",
                                   {"prompt": "After the disconnect", "max_tokens": 32},
                                   False)]
        wall = time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize()
        launches = {k: n for k, n in read_counts().items() if n}
        tokens = srv.metrics["tokens_generated_total"]
        srv.shutdown()
        out[kind] = dict(texts=[r[1] for r in results], statuses=[r[0] for r in results],
                         aggregate_tok_s=tokens / wall, wall_s=wall, launches=launches,
                         steps=probe.summary() if probe else None)
        del srv, engine
        if cuda:
            torch.cuda.empty_cache()
    return out


def tp_phase_h(mesh, rank, tk, vocab, device, cfg=None) -> dict:
    """Phase H: the server at tp = the world over NCCL, one card a rank, the
    32-layer 8B constructed-cyclic model (bf16): rank 0 first runs the same
    servers on the whole model on its card (``h_servers`` without a mesh);
    then every rank serves its shards in lockstep. Every request's text must
    equal the single card's. ``cfg`` (a tiny one) runs the phase over gloo
    on the CPU, a check before a multi-card call."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import init_random_params
    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params, tp_size

    cfg = cfg or cfg_8b(32)
    if device.type == "cuda":
        # the first profiler session of a process starts slowly: not in the
        # profiled steps, where the other ranks would wait for it in NCCL
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize()
    whole = cyclic_params(init_random_params(cfg, seed=0, device=device), SPEC_CYCLE)
    out = {"tp": tp_size(mesh)}
    if rank == 0:
        out["single"] = h_servers(None, 0, whole, cfg, tk, vocab, device)
    shard = shard_params(whole, mesh)
    del whole
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["mesh"] = h_servers(mesh, rank, shard, cfg, tk, vocab, device)
    if rank == 0:
        for kind, res in out["mesh"].items():
            same = res["texts"] == out["single"][kind]["texts"]
            ok = same and all(s == 200 for s in res["statuses"])
            log(f"phase H, {kind}, tp {out['tp']}: every request's text "
                f"{'equals' if same else 'DIFFERS from'} the single card's; "
                f"{res['aggregate_tok_s']:.2f} aggregate tok/s (single card "
                f"{out['single'][kind]['aggregate_tok_s']:.2f}); steps {res['steps']}")
            if not ok:
                check_failed(f"phase H {kind}: the tp server's texts differ from one card's")
    return out


def tp_phase_h_parent(tp: int) -> dict:
    """Phase H's ranks; each rank's batched-step summary beside rank 0's
    traffic."""
    log(f"phase 25 (tp H): the server at --tp {tp} over NCCL, 32-layer cyclic 8B")
    ranks = run_tp_children("H", tp)
    if any(r is None for r in ranks):
        return {"ran": True, "tp": tp, "ranks": ranks}
    summary = {"ran": True, "tp": tp,
               "single": {k: {f: v for f, v in d.items() if f != "texts"}
                          for k, d in ranks[0]["single"].items()},
               "mesh": {k: {f: v for f, v in d.items() if f != "texts"}
                        for k, d in ranks[0]["mesh"].items()},
               "ranks": [{k: d["steps"] for k, d in r["mesh"].items()}
                         | {"peak_memory_gib": r["peak_memory_gib"]} for r in ranks]}
    log(f"phase H: {json.dumps(summary)}")
    return summary


def tp_serving_phases(errs) -> dict:
    """Phases 22-25 (E-H), after phases 18-21."""
    log("phase 22 (tp E): K6 through tp_paged_flash_decode at one rank's shapes")
    out = {"E": tp_rank_paged(errs)}
    torch.cuda.empty_cache()
    log("phase 23 (tp F): one NCCL rank through the server over HTTP, with and without "
        "the mesh")
    out["F"] = (run_tp_children("F", 1) or [None])[0]
    log("phase 24 (tp G): two gloo ranks on the one card, the eager paged functions")
    out["G"] = run_tp_children("G", 2)[0]
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"phase 25 (tp H): the server at --tp > 1 needs 2 or more cards; this machine "
            f"has {cards}, so phase H did not run")
        out["H"] = {"ran": False, "cards": cards}
    else:
        out["H"] = tp_phase_h_parent(min(4, cards))
    return out


def tp_phases(errs, results, tk, vocab) -> dict:
    """Phases 18-21 (A-D), after the parent has freed its models."""
    log("phase 18 (tp A): K1, K2, K4 and K8 at one tp rank's shapes of the 8B")
    out = {"A": tp_rank_kernels(errs, results)}
    torch.cuda.empty_cache()
    log("phase 19 (tp B): one NCCL rank, make_mesh(tp=1), the whole tp code path")
    out["B"] = (run_tp_children("B", 1) or [None])[0]
    log("phase 20 (tp C): two gloo ranks on the one card, eager forward")
    out["C"] = run_tp_children("C", 2)[0]
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"phase 21 (tp D): NCCL at tp > 1 needs 2 or more cards; this machine has "
            f"{cards}, so phase D did not run")
        out["D"] = {"ran": False, "cards": cards}
    else:
        out["D"] = tp_phase_d_parent(min(4, cards))
    return out


def tp_phase_d_parent(tp: int) -> dict:
    """Phase D's ranks, and their tokens held against rank 0's single-card
    run and each other's."""
    log(f"phase 21 (tp D): NCCL at tp {tp}, the CLI's process model, 32-layer "
        "cyclic 8B")
    ranks = run_tp_children("D", tp)
    if any(r is None for r in ranks):
        return {"ran": True, "tp": tp, "ranks": ranks}
    single = ranks[0]["single"]
    for r, res in enumerate(ranks):
        for key in ("A", "B"):
            if res["mesh"][key]["ids"] != single[key]["ids"]:
                check_failed(f"phase D rank {r} request {key}: tokens differ from the "
                             "single-card run's")
    summary = {"ran": True, "tp": tp, "graph_logits": ranks[0]["graph_logits"],
               "single": {k: {f: v for f, v in d.items() if f != "ids"}
                                                 if isinstance(d, dict) else d
                                                 for k, d in single.items()},
               "ranks": [{k: {f: v for f, v in d.items() if f != "ids"}
                          if isinstance(d, dict) else d for k, d in res["mesh"].items()}
                         | {"peak_memory_gib": res["peak_memory_gib"]} for res in ranks]}
    log(f"phase D: every rank's tokens equal rank 0's and the single-card run's: "
        f"{json.dumps(summary)}")
    return summary


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
                        results["B"]["prefill_len"], results["A"]["prefill_len"],
                        results["A"]["cache_len"])
    log("phase 5: main path, 32-layer 8B, int4 weights and an int8 cache")
    qresults, qrows = quant_main_path(tk, vocab, errs)
    rows += qrows
    # each kernel's launches are those of its path's requests
    for row, tag, runs in zip(rows, ("K1", "K2", "K3", "K4", "K8"),
                              ((results,) * 2 + (qresults,) * 3)):
        row["launches"] = sum(runs[r]["launches"][tag] for r in (
            "A", "B", "C", "A_chunk8", "B_chunk8", "C_chunk8") if r in runs)
    log("phase 6: paged kernels K6 (bf16, int8), K7 and K5 vs plain at 8B widths")
    errs.update(check_paged_kernels())
    log("phase 7: 2-layer paged decode, K6 vs the gather path; cyclic batchers")
    paged_readings = check_paged_model_path(tk, vocab)
    log("phase 8: serving path, 32-layer 8B over HTTP, bf16 pool (K6)")
    serving, srows = serving_path(tk, vocab, int8=False)
    log("phase 9: serving path, 32-layer 8B over HTTP, int8 pool (K6's int8 mode)")
    serving8, srows8 = serving_path(tk, vocab, int8=True)
    log("phase 10: speculative sequential engine, 32-layer 8B, bf16, k = 4")
    spec = spec_main_path(tk, vocab)
    log("phase 11: speculative sequential engine, 32-layer 8B, int4 weights, int8 cache")
    spec_q = spec_quant_path(tk, vocab)
    log("phase 12: speculative dense and paged batchers, 2-layer cyclic model")
    spec_b = spec_batchers(tk, vocab)
    log("phase 13: speculative serving, 32-layer 8B over HTTP, bf16 pool")
    spec_s = spec_serving_path(tk, vocab)
    single = single_device_paths(tk, vocab)
    torch.cuda.empty_cache()
    tp = tp_phases(errs, results, tk, vocab)
    tps = tp_serving_phases(errs)
    # the speculative paths' launches join their kernels' counts, and so do
    # the probe's requests (its timed graphs included), the narrated prefill,
    # the traced prefill and decode step and the sharded load's prefills
    spec_launches = [r["launches"] for r in spec.values() if isinstance(r, dict)
                     and "launches" in r] + [spec_q["launches"], spec_s["launches"]]
    spec_launches += [r[impl]["launches"] for r in single["probe"].values()
                      for impl in ("probe", "auto")]
    spec_launches += [single["narration"]["launches"], single["shards"]["launches"]]
    spec_launches += [t["launches"] for t in single["narration"]["trace"].values()]
    for row, tag in zip(rows, ("K1", "K2", "K3", "K4", "K8")):
        row["launches"] += sum(c.get(tag, 0) for c in spec_launches)
    # K6's launches are the serving runs'; K5 and K7 serve no path (0)
    for row in srows + srows8:
        tag = row.pop("tag")
        row["max_abs_err"] = errs[tag]
        row["launches"] = (serving["launches"][tag] + serving8["launches"][tag]
                           + sum(c.get(tag, 0) for c in spec_launches))
    rows += srows + srows8
    # the per-rank shapes of phases A and E join their kernels' rows, and the
    # launches of phase B's mesh engine and phase F's mesh servers (the main
    # paths under a mesh) their counts
    mesh_launches = [run["mesh"]["launches"] for kind in (tp["B"] or {}).values()
                     if isinstance(kind, dict) for run in kind.values()
                     if isinstance(run, dict) and "launches" in run.get("mesh", ())]
    mesh_launches += [runs["mesh"]["launches"] for runs in (tps["F"] or {}).values()
                      if isinstance(runs, dict) and "mesh" in runs]
    for row in rows:
        tag = "K" + row["name"].split("(K")[-1].rstrip(")")
        tag = "K6i8" if tag == "K6" and "int8" in row["name"] else tag
        if tag in tp["A"]:
            row["tp_rank_shapes"] = tp["A"][tag]
        if tag in ("K6", "K6i8"):
            row["tp_rank_shapes"] = [r for r in tps["E"] if r["kernel"] == tag]
        row["launches"] += sum(c.get(tag, 0) for c in mesh_launches)
    rows.sort(key=lambda r: r["name"].split("(K")[-1])
    log(f"summary: {json.dumps(results)}")
    log(f"summary, quantized path: {json.dumps(qresults)}")
    log(f"summary, paged 2-layer logits (relative L2 per step): {json.dumps(paged_readings)}")
    log(f"summary, serving bf16 pool: {json.dumps(serving)}")
    log(f"summary, serving int8 pool: {json.dumps(serving8)}")
    log(f"summary, speculative engine (bf16): {json.dumps(spec)}")
    log(f"summary, speculative engine (int4 + int8 KV): {json.dumps(spec_q)}")
    log(f"summary, speculative batchers: {json.dumps(spec_b)}")
    log(f"summary, speculative serving: {json.dumps(spec_s)}")
    log(f"summary, probe, narration, native BPE, shards: {json.dumps(single)}")
    log(f"summary, tensor parallelism (phases B-D): "
        f"{json.dumps({k: v for k, v in tp.items() if k != 'A'})}")
    log(f"summary, tensor parallelism for serving (phases F-H): "
        f"{json.dumps({k: v for k, v in tps.items() if k != 'E'})}")
    if FAILED:
        fail(f"{len(FAILED)} checks failed: " + "; ".join(FAILED))
    log(f"total {time.perf_counter() - T_START:.1f}s on {smi}")
    print(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "dense_bf16_mm_ms", "gather_path_ms", "ms_full_context",
            "bound_ms_full_context", "ms_b1_pos1850", "bound_ms_b1_pos1850",
            "gather_path_ms_b1_pos1850", "more_shapes", "tp_rank_shapes")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:
        # a rank of phase B, C, D, F, G or H (run_tp_children)
        phase, rank, world, port, out_dir = sys.argv[2:7]
        sys.exit(tp_rank_main(phase, int(rank), int(world), int(port), out_dir))
    sys.exit(main())
