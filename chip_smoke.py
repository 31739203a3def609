"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the CUDA kernels from ``llama_nuts_and_bolts_tpu_torch/csrc``, holds
each against its plain PyTorch version at Llama-3.1-8B attention widths and
at the main path's own shapes, checks the forward pass with the kernels
against the plain path on a 2-layer full-width model, and drives the main
path -- greedy streaming chat through ``InferenceEngine.generate_string`` --
on the full 32-layer 8B architecture with seeded random weights; then times
the kernels. Every limit is also read against planted faults, which must
fail it. Any failed check exits non-zero.

Run from the repository root: ``python3 chip_smoke.py``. The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it is
the kernel table as JSON, and before that the card's name and power limit.
"""

from __future__ import annotations

import contextlib
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
    the last call's result."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
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
               planted: bool = False) -> float:
    """``got`` against the plain version's ``ref`` at the kernel tolerance;
    returns the max-abs error. A sound kernel must pass; a planted fault
    must fail."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    worst = float(err.max())
    excess = float((err - (KERNEL_ATOL + KERNEL_RTOL * ref.abs())).max())
    rel = rel_l2(got, ref)
    ok = bool(torch.isfinite(got).all()) and excess <= 0 and rel <= KERNEL_REL_L2
    log(f"{'planted fault, ' if planted else ''}{what}: max_abs_err={worst:.3e}, "
        f"relative L2 {rel:.3e} (limits {KERNEL_ATOL} + 2^-7*|ref| per element, "
        f"{KERNEL_REL_L2} relative L2): {'passes' if ok else 'fails'}")
    if ok == planted:
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


def k2_mask_off_by_one(q, k, v, start_pos, layer):
    """Planted fault: K2 with its mask off by one, so row b sees
    t < start_pos[b]."""
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        flash_decode_attention)

    return flash_decode_attention(q, k, v, start_pos - 1, layer=layer)


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
    previous cycle element, so greedy output walks 0→1→…→C-1→0."""
    import dataclasses

    layers = dict(params.layers)
    layers["wo"] = torch.zeros_like(layers["wo"])
    layers["w_down"] = torch.zeros_like(layers["w_down"])
    out = torch.zeros_like(params.output)              # fused: [dim, vocab]
    idx = (torch.arange(cycle) - 1) % cycle
    out[:, :cycle] = params.tok_embeddings[idx].t()
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


def run_request(engine, tokens, max_new, k1, k2, n_layers, what):
    from llama_nuts_and_bolts_tpu_torch.runtime.engine import prefill_bucket

    k1.launches = 0
    k2.launches = 0
    t0 = time.perf_counter()
    parts, t_first = [], None
    for part in engine.generate_string(tokens, max_new_tokens=max_new):
        if t_first is None:
            t_first = time.perf_counter()
        parts.append(part)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = (k1.launches, k2.launches)
    ids = [p.token_id for p in parts if not p.is_resend_of_waiting]
    if not ids or any(not 0 <= i < engine.model.cfg.vocab_size for i in ids):
        fail(f"{what}: bad token ids {ids[:8]}")
    text = "".join(p.decoded_string for p in parts)
    steps = len(ids) - 1            # every emitted token but the last ran a step
    if launches != (n_layers, n_layers * steps):
        fail(f"{what}: launches K1={launches[0]} K2={launches[1]}, expected "
             f"{n_layers} per prefill and {n_layers} per decode step "
             f"({n_layers}, {n_layers * steps})")
    ttft = t_first - t0
    tok_s = steps / (t_end - t_first) if steps else float("nan")
    log(f"{what}: prompt {len(tokens)} tokens, {len(ids)} generated, "
        f"TTFT {ttft * 1e3:.1f} ms, decode {tok_s:.2f} tok/s, K1 launches "
        f"{launches[0]}, K2 launches {launches[1]}; text[:60]={text[:60]!r}")
    cache_len = engine.cache_bucket(len(tokens), max_new)
    return dict(prompt=len(tokens), generated=len(ids), ttft_ms=ttft * 1e3,
                cache_len=cache_len,
                prefill_len=prefill_bucket(len(tokens), cache_len),
                decode_tok_s=tok_s, k1_launches=launches[0],
                k2_launches=launches[1])


def main_path(tk, vocab):
    from llama_nuts_and_bolts_tpu_torch.kernels.attention import flash_gqa_attention
    from llama_nuts_and_bolts_tpu_torch.kernels.decode_attention import (
        flash_decode_attention)
    from llama_nuts_and_bolts_tpu_torch.models.llama import (
        KVCache, LoadedModel, forward, init_random_params)
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.tokenizer import PromptPart

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

    chat = engine.tokenize([
        PromptPart("system", "You are a helpful assistant."),
        PromptPart("user", "Explain what a key-value cache is, in a few sentences."),
    ])
    words = ("the quick brown fox jumps over a lazy dog while seven wizards "
             "quietly box with jovial frogs near the old mill; ").split()
    text = " ".join(words[(i * 7) % len(words)] for i in range(4000))
    long_prompt = [vocab.bos_id] + engine.tokenize_string(text)[:2999]

    torch.cuda.reset_peak_memory_stats()
    results = {}
    results["A"] = run_request(engine, chat, 64, flash_gqa_attention,
                               flash_decode_attention, cfg.n_layers,
                               "request A (chat, 64 new tokens)")
    results["B"] = run_request(engine, long_prompt, 32, flash_gqa_attention,
                               flash_decode_attention, cfg.n_layers,
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
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                kernels_per_step=sum(e.count for e in kernels) // steps,
                top=[(e.key[:90], e.self_device_time_total / 1e3 / steps) for e in top])


def main() -> int:
    name, smi = setup()
    log("phase 2: kernels vs plain at 8B attention widths")
    errs = check_kernels()
    tk, vocab = synthetic_tokenizer()
    log("phase 3: 2-layer full-width model, kernels vs plain path")
    check_model_path(tk, vocab)
    log("phase 4: main path, 32-layer 8B, random weights")
    results = main_path(tk, vocab)
    rows = time_kernels(errs, results["B"]["prompt"], results["B"]["cache_len"],
                        results["B"]["prefill_len"])
    rows[0]["launches"] = results["A"]["k1_launches"] + results["B"]["k1_launches"]
    rows[1]["launches"] = results["A"]["k2_launches"] + results["B"]["k2_launches"]
    log(f"summary: {json.dumps(results)}")
    if FAILED:
        fail(f"{len(FAILED)} checks failed: " + "; ".join(FAILED))
    log(f"total {time.perf_counter() - T_START:.1f}s on {smi}")
    print(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
