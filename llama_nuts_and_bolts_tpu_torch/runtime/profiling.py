"""Tracing and profiling: device traces and the narrated forward pass.

Port of ``llama_nuts_and_bolts_tpu/runtime/profiling.py``:

  * :func:`device_trace` -- a context manager around ``torch.profiler``
    that writes a Chrome trace (``chrome://tracing``, Perfetto) of the host
    and, on a card, the device timeline into a directory;
  * :func:`narrated_forward` -- the forward pass a layer at a time, with each
    layer's wall-clock time and the shapes through ``log_fn``: the
    reference's "Transformer block layer i / L was run, took X sec(s)"
    lines. It runs ``models/llama/model.py``'s own three parts
    (``prepare_forward``, ``decoder_block``, ``output_head``), so it runs
    the served code (the kernels, an int8 cache, quantized weights) and, on
    a card, gives the logits of ``forward`` at the same ``attn_impl`` bit
    for bit; it only synchronises between them. For inspection, not serving;
  * :class:`StepTimer` -- per-token latency aggregation (p50/p95/mean).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama.model import (
    KVCache,
    LlamaParams,
    decoder_block,
    layer_weights,
    output_head,
    prepare_forward,
)
from llama_nuts_and_bolts_tpu_torch.utils.logging import get_logger


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``with device_trace("/tmp/trace") as prof:`` traces the block with
    ``torch.profiler`` (host activity, and the card's where there is one)
    and on exit writes a Chrome trace ``trace_*.json`` of its own into
    ``log_dir``. ``prof.key_averages()`` gives the times by name after the
    block."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="trace_", suffix=".json", dir=log_dir)
    os.close(fd)
    prof.export_chrome_trace(path)


@dataclass
class StepTimer:
    samples: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.samples.append(dt)
        return dt

    def summary(self) -> dict:
        if not self.samples:
            return {}
        arr = sorted(self.samples)
        n = len(arr)
        return {
            "count": n,
            "mean_s": sum(arr) / n,
            "p50_s": arr[n // 2],
            "p95_s": arr[min(n - 1, int(n * 0.95))],
            "total_s": sum(arr),
        }


def narrated_forward(
    params: LlamaParams,
    cfg: ModelArgs,
    tokens: torch.Tensor,
    start_pos: int,
    cache: KVCache,
    log_fn: Optional[Callable[[str], None]] = None,
    attn_impl: str = "plain",
    logits_at: Optional[int] = None,
    mesh=None,
) -> Tuple[torch.Tensor, KVCache]:
    """``forward`` with per-layer wall-clock and shape narration: one line
    for the embeddings, one a layer, one for the output norm and head
    (``cfg.n_layers + 2`` lines). On a card each time ends on a
    synchronisation, so it is the layer's device time plus its launches.
    Under ``mesh`` it runs this rank's shards, as ``forward`` does."""
    log = log_fn or (lambda msg: get_logger().info("%s", msg))
    on_card = tokens.device.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(tokens.device)

    t0 = time.perf_counter()
    x, inp = prepare_forward(params, cfg, tokens, start_pos, cache, attn_impl, mesh)
    sync()
    log(f"embeddings: shape{tuple(x.shape)} dtype={str(x.dtype).replace('torch.', '')} "
        f"took {time.perf_counter() - t0:.4f} sec(s)")
    for li in range(cfg.n_layers):
        t0 = time.perf_counter()
        x = decoder_block(layer_weights(params, li), li, x, inp)
        sync()
        log(f"Transformer block layer {li + 1} / {cfg.n_layers} was run, "
            f"took {time.perf_counter() - t0:.4f} sec(s)")
    t0 = time.perf_counter()
    logits = output_head(params, cfg, x, logits_at, mesh)
    sync()
    log(f"output norm+projection: logits{tuple(logits.shape)} "
        f"took {time.perf_counter() - t0:.4f} sec(s)")
    return logits, cache
