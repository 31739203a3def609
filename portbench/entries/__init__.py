"""The entries a mix drives: the program's own objects, built as its CLI and
server build them (with the program's defaults: ``attn_impl`` auto, a bf16
KV cache, the prefix cache on), warmed up on the cell's shapes, then run
over the window with the benchmark's spans around the calls into them.

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

from portbench.yardstick import Dims

DRAIN_S = 60.0          # how long a run waits past the window for first tokens


def synthetic_vocab(size: int):
    """A vocabulary of ``size`` ids with no stop token: every request runs
    to the output length the mix drew for it."""
    from llama_nuts_and_bolts_tpu_torch.tokenizer import Vocabulary

    return Vocabulary(token_to_id={}, id_to_token=[b""] * size, special_token_to_id={},
                      special_ids=set(), bos_id=-1, eos_id=-1, stop_token_ids=set())


def port_model(weights: Dict, cfg_path, context: int, device, fused: bool):
    """The program's ``LoadedModel`` over the benchmark's weights: the
    configuration read by the port's own ``params.json`` loader, its rotary
    tables, and (``fused``) its fused decode layout."""
    from llama_nuts_and_bolts_tpu_torch.io.params import load_model_args
    from llama_nuts_and_bolts_tpu_torch.models.llama import LoadedModel
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import (
        LlamaParams,
        fuse_decode_params,
        rope_tables,
    )

    cfg = load_model_args(str(cfg_path), max_sequence_length=context)
    cos, sin = rope_tables(cfg, device)
    params = LlamaParams(tok_embeddings=weights["tok_embeddings"],
                         layers={k: weights[k] for k in
                                 ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo",
                                  "w_gate", "w_up", "w_down")},
                         norm=weights["norm"], output=weights["output"],
                         rope_cos=cos, rope_sin=sin)
    if fused:
        params = fuse_decode_params(params)
    return LoadedModel(params=params, cfg=cfg, vocab=synthetic_vocab(cfg.vocab_size),
                       mergeable_ranks={}, tensor_meta={})


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
    ``copies_weights``: the program keeps a copy of its own, and not the
    benchmark's tensors."""

    copies_weights = False

    def __init__(self, mix: Dict, dims: Dims, cfg_path, device) -> None:
        self.mix = mix
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
