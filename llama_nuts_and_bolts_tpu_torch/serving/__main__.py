"""``python -m llama_nuts_and_bolts_tpu_torch.serving [--tiny] [--port N] ...``

The JAX package's server flags, plus ``--device {cuda,cpu}`` (default
``cuda``; no fallback). ``--attn-impl probe`` measures the sequential
engine's decode path per cache bucket; the batchers keep the ``auto`` rules.

``--tp N`` shards the model over N ranks on the process model of
``parallel/launch.py``: this process is rank 0 (the socket, the console,
the logs) and spawns N - 1 followers; NCCL on cards (rank r on ``cuda:r``;
fewer than N cards raise), gloo with ``--device cpu``. Each rank shards the
``--tiny`` params (``shard_params``) or loads its slices of a checkpoint
(``param_sharding_fn``), keeps the split layout (no fused decode layout
under a mesh, as in the JAX package), and loads a ``--draft-model`` whole.
The followers follow rank 0's batcher step records or sequential engine
calls (``serving/server.py``); SIGINT or SIGTERM to rank 0 ends every
rank with code 0. A rank that fails or dies ends every rank: rank 0 exits
with code 1.
``--decode-chunk K`` reaches the engine: the sequential path (no
``--continuous``) streams in captured K-step chunks. ``--speculate K``
speculates on the sequential engine and in both batchers; ``--draft-model
DIR`` loads a smaller Llama as the sequential engine's proposer, on the same
device.
"""

import argparse
import signal
import sys
import traceback

from llama_nuts_and_bolts_tpu_torch.device import resolve_device
from llama_nuts_and_bolts_tpu_torch.parallel.launch import abort, launch, rank_group
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.serving.server import serve


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="llama_nuts_and_bolts_tpu_torch.serving")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (default cuda; no fallback)")
    p.add_argument("--tiny", action="store_true",
                   help="serve the tiny random demo model (no weights needed)")
    p.add_argument("--quant", choices=["none", "int8", "int4"], default="none",
                   help="weight-only quantization")
    p.add_argument("--draft-model", default=None, metavar="DIR",
                   help="with --speculate: smaller Llama checkpoint dir used "
                        "as the draft model (default: n-gram prompt lookup)")
    p.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="n-gram prompt-lookup speculative decoding (greedy only)")
    p.add_argument("--continuous", type=int, default=0, metavar="SLOTS",
                   help="continuous batching: requests share decode steps "
                        "across SLOTS cache slots (0 disables)")
    p.add_argument("--paged-blocks", type=int, default=0, metavar="N",
                   help="with --continuous: use a paged KV cache of N shared "
                        "blocks instead of dense per-slot rows")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="with --paged-blocks: disable automatic prefix "
                        "caching (hash-shared prompt blocks)")
    p.add_argument("--tp", type=int, default=0, metavar="N",
                   help="tensor parallelism: shard the model over N ranks, one a "
                        "device (0 = single device)")
    p.add_argument("--kv-cache", choices=["bf16", "int8"], default="bf16",
                   help="KV cache dtype: int8 halves the cache's bytes")
    p.add_argument("--prefill-chunk", type=int, default=0, metavar="C",
                   help="chunked prefill: prompts longer than C tokens run in "
                        "C-token chunks (0 disables)")
    p.add_argument("--attn-impl", choices=["auto", "plain", "flash", "probe"],
                   default="auto",
                   help="attention: the CUDA kernels on a card (auto), forced, "
                        "or a one-shot measured probe of the decode step at "
                        "each cache bucket (the batchers keep auto)")
    p.add_argument("--decode-chunk", type=int, default=0, metavar="K",
                   help="streaming (greedy or sampled) decodes K tokens per "
                        "captured graph replay; sampled keeps seeded RNG parity "
                        "(0 = auto: per-token on a host-attached card)")
    p.add_argument("--max-pending", type=int, default=0, metavar="N",
                   help="admit at most N concurrent generation requests; "
                        "excess get an immediate 429 + Retry-After "
                        "(0 = auto: 4x --continuous slots, else 8)")
    p.add_argument("--step-quantum", type=int, default=0, metavar="K",
                   help="decode steps per scheduler iteration (0 = 1); larger "
                        "coarsens admission/stop granularity")
    p.add_argument("--no-prewarm", action="store_true",
                   help="skip the warm-up request before the socket opens")
    p.add_argument("--token-timeout", type=float, default=120.0, metavar="S",
                   help="max seconds to wait for one token from the batcher "
                        "before failing the request cleanly")
    p.add_argument("--cache-system-prompt", default=None, metavar="TEXT",
                   help="prefill TEXT's system-prompt block once at startup; "
                        "chat requests that start with it prefill only their "
                        "suffix (no effect in --continuous mode)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.tiny and args.draft_model:
        from llama_nuts_and_bolts_tpu_torch.cli.main import TINY_DRAFT_REFUSAL

        raise SystemExit(TINY_DRAFT_REFUSAL)
    if args.tp > 1:
        return launch(_run_rank, argv, args.tp, args.device)
    return run(args, resolve_device(args.device))


def _run_rank(argv, rank: int, port: int) -> int:
    """One rank of ``--tp N``: join the group and serve (rank 0) or follow."""
    args = parse_args(argv)
    if rank == 0:
        # SIGTERM ends the server as SIGINT does: the followers are told
        signal.signal(signal.SIGTERM, signal.default_int_handler)
    else:
        # a terminal's Ctrl-C reaches every rank: rank 0 ends the followers
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    with rank_group(rank, args.tp, port, args.device) as (device, mesh, control):
        try:
            return run(args, device, mesh, control)
        except KeyboardInterrupt:
            return 0
        except Exception:
            # the other ranks may be in a collective this one will not join
            abort(f"tensor-parallel rank {rank} failed:\n{traceback.format_exc()}")


def run(args, device, mesh=None, control=None) -> int:
    """The server on ``device``; under ``mesh``, this rank's part of it."""
    quant = None if args.quant == "none" else args.quant
    if args.tiny:
        from llama_nuts_and_bolts_tpu_torch.cli.main import load_tiny_model

        model = load_tiny_model(device)
        if quant is not None:
            from llama_nuts_and_bolts_tpu_torch.quant import (
                quantize_params,
                quantize_params_q4,
            )

            qfn = quantize_params_q4 if quant == "int4" else quantize_params
            model.params = qfn(model.params)
        if mesh is not None:
            from llama_nuts_and_bolts_tpu_torch.parallel import shard_params

            model.params = shard_params(model.params, mesh)
        elif quant is None and not args.paged_blocks:
            # the fused decode layout (paged batching keeps the split layout:
            # models/llama/paged.py has its own forward)
            from llama_nuts_and_bolts_tpu_torch.models.llama import fuse_decode_params

            model.params = fuse_decode_params(model.params)
        name = "tiny-random"
    else:
        from llama_nuts_and_bolts_tpu_torch.cli.main import discover_model_dir
        from llama_nuts_and_bolts_tpu_torch.models.llama.loader import load_llama_model

        sharding_fn = None
        if mesh is not None:
            from llama_nuts_and_bolts_tpu_torch.parallel import param_sharding_fn

            sharding_fn = param_sharding_fn(mesh)
        model = load_llama_model(discover_model_dir(args.model_dir),
                                 max_sequence_length=args.seq_len, device=device,
                                 quant=quant, sharding_fn=sharding_fn,
                                 fused=quant is None and mesh is None and not args.paged_blocks)
        name = "llama-3.1-8b-instruct"

    draft = None
    if args.draft_model:
        from llama_nuts_and_bolts_tpu_torch.models.llama.loader import load_llama_model

        draft = load_llama_model(args.draft_model, max_sequence_length=args.seq_len,
                                 device=device)
    engine = InferenceEngine(model, InferenceArgs(sequence_length=args.seq_len,
                                                  speculate_k=args.speculate,
                                                  kv_cache_dtype=args.kv_cache,
                                                  prefill_chunk=args.prefill_chunk,
                                                  attn_impl=args.attn_impl,
                                                  decode_chunk=args.decode_chunk),
                             draft_model=draft, device=device, mesh=mesh)
    if args.cache_system_prompt and not args.continuous:
        from llama_nuts_and_bolts_tpu_torch.tokenizer import PromptPart, render_prefix_tokens

        engine.cache_prefix(render_prefix_tokens(
            [PromptPart("system", args.cache_system_prompt)],
            model.vocab, model.mergeable_ranks))
    serve(engine, args.host, args.port, name, continuous_slots=args.continuous,
          paged_blocks=args.paged_blocks,
          prefix_cache=not args.no_prefix_cache,
          max_pending=args.max_pending, prewarm=not args.no_prewarm,
          token_timeout_s=args.token_timeout,
          step_quantum=args.step_quantum or None, control=control)
    return 0


if __name__ == "__main__":
    sys.exit(main())
