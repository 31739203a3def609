"""The entries a mix drives: the program's own objects over the cell's
model (its family's ``program``), built as its CLI and server build them
(with the program's defaults: ``attn_impl`` auto, a bf16 KV cache, the
prefix cache on), warmed up on the cell's shapes, then run over the window
with the benchmark's spans around the calls into them.

A mix names its entry; ``portbench/entries/<entry>.py`` defines it as
``ENTRY``, a subclass of :class:`Entry`, found by name
(``Bench.entry``):

  * ``engine``: the CLI's chat (``engine.py``);
  * ``paged_batcher``: the server's paged continuous batcher
    (``paged_batcher.py``).

Each request's output is stamped with the host clock as the program
delivers it: as ``generate_tokens`` yields it, or as the batcher puts it on
the request's stream (:class:`Stamped`, which stands in for the stream's
queue).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

DRAIN_S = 60.0          # how long a run waits past the window for first tokens


def synthetic_vocab(size: int):
    """A vocabulary of ``size`` ids with no stop token: every request runs
    to the output length the mix drew for it."""
    from llama_nuts_and_bolts_tpu_torch.tokenizer import Vocabulary

    return Vocabulary(token_to_id={}, id_to_token=[b""] * size, special_token_to_id={},
                      special_ids=set(), bos_id=-1, eos_id=-1, stop_token_ids=set())


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stamped:
    """A request's output stream as the benchmark reads it: each entry the
    program puts is kept with the host clock's time of the put."""

    def __init__(self) -> None:
        self.entries: List[tuple] = []

    def put(self, item) -> None:
        self.entries.append((time.perf_counter(), item))


class Entry:
    """Build the program (``setup``), then run the window (``run``).
    ``family`` is the cell's model family (``Bench.family``), whose
    ``program`` is the model the entry serves, and ``dims`` its shapes.
    ``copies_weights``: the program keeps a copy of its own, and not the
    benchmark's tensors."""

    copies_weights = False

    def __init__(self, mix: Dict, family, dims, cfg_path, device) -> None:
        self.mix = mix
        self.family = family
        self.dims = dims
        self.cfg_path = cfg_path
        self.device = device

    def close(self) -> None:
        """Drop the program's state, so the reference finds the card free."""
        for name in ("batcher", "engine", "model"):
            if hasattr(self, name):
                setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
