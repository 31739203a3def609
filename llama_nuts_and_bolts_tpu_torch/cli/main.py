"""Interactive CLI: prompt menu, streaming generation, live console repaint.

Port of ``llama_nuts_and_bolts_tpu/cli/main.py`` for the single-request
path, with bf16, int8 or int4 weights (``--quant``), a bf16 or int8 KV cache
(``--kv-cache``), greedy speculative decoding (``--speculate``, with
``--draft-model``), a measured choice of the decode step's attention
(``--attn-impl probe``), a narrated layer-at-a-time prefill
(``--narrate``) and tensor parallelism (``--tp N``). Runs on ``cuda`` unless
``--device cpu`` is given.

``--tp N`` is one command, as in the JAX package, on the process model of
``parallel/launch.py`` (shared with the server): this process is rank 0
and starts N - 1 followers. Rank 0 owns the console: it reads the prompt,
broadcasts each request's token ids to the followers over the control
group (a person may take minutes to type), then a quit sentinel. Every
rank runs the same engine calls in lockstep on its shards; the followers'
output is discarded. ``--tp N`` with fewer than N cards raises.

Run: ``python -m llama_nuts_and_bolts_tpu_torch.cli [flags]``
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass
from typing import List, Optional

from llama_nuts_and_bolts_tpu_torch.cli.console import AppState
from llama_nuts_and_bolts_tpu_torch.device import resolve_device
from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs, find_model_dir
from llama_nuts_and_bolts_tpu_torch.parallel.launch import broadcast, launch, rank_group
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.runtime.types import GenerationState
from llama_nuts_and_bolts_tpu_torch.tokenizer import PromptPart
from llama_nuts_and_bolts_tpu_torch.utils.logging import Logger, set_logger

MODELS_DIR_NAME = "models-original"
MODEL_NAME = "Meta-Llama-3.1-8B-Instruct"
TINY_DRAFT_REFUSAL = ("error: --draft-model needs a checkpoint directory whose "
                      "vocabulary matches the target's; the --tiny model has "
                      "none (use --speculate alone: n-gram prompt lookup)")


@dataclass
class PromptInput:
    prompt: str
    system_prompt: str = ""
    is_chat_mode: bool = False


PREDEFINED_PROMPTS = [
    PromptInput(is_chat_mode=False, prompt="Hello, my name is"),
    PromptInput(is_chat_mode=True, system_prompt="You are Einstein",
                prompt="Describe your theory."),
    PromptInput(is_chat_mode=True,
                system_prompt="Answer in 20 words, directly, and without an introduction",
                prompt="Can you explain what is Theory of relativity?"),
    PromptInput(is_chat_mode=True, system_prompt="You are a pirate",
                prompt="Explain what is quantum computer in 20 words."),
    PromptInput(is_chat_mode=True, system_prompt="Always answer with emojis",
                prompt="How to go from Beijing to NY?"),
    PromptInput(is_chat_mode=True, system_prompt="Answer with only one emoji",
                prompt="What is the flag of Turkey?"),
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="llama_nuts_and_bolts_tpu_torch",
        description="Llama 3.1 inference engine (PyTorch/CUDA port)")
    p.add_argument("--model-dir", default=None,
                   help="directory with consolidated.00.pth, params.json, tokenizer.model")
    p.add_argument("--seq-len", type=int, default=200,
                   help="total sequence length cap (the reference CLI uses 200)")
    p.add_argument("--prompt", type=int, default=None, metavar="N",
                   help="run predefined prompt N (1-6) non-interactively")
    p.add_argument("--prompt-text", default=None,
                   help="run this prompt text non-interactively")
    p.add_argument("--chat", action="store_true",
                   help="with --prompt-text: use chat template")
    p.add_argument("--system-prompt", default="",
                   help="with --chat: the system prompt")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--quant", choices=["none", "int8", "int4"], default="none",
                   help="weight-only quantization: int8 per output channel, or "
                        "int4 in groups of 256 (the K8 kernel decodes it)")
    p.add_argument("--kv-cache", choices=["bf16", "int8"], default="bf16",
                   help="KV cache dtype: int8 halves the cache's bytes; it "
                        "decodes through the K4 kernel when the context is a "
                        "multiple of 128, else on the plain path")
    p.add_argument("--draft-model", default=None, metavar="DIR",
                   help="with --speculate: directory of a smaller Llama "
                        "checkpoint used as the speculation draft model "
                        "(default: n-gram prompt lookup, no second model)")
    p.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="n-gram prompt-lookup speculative decoding: verify up "
                        "to K drafts per step (greedy only; 0 disables)")
    p.add_argument("--prefill-chunk", type=int, default=0, metavar="C",
                   help="process prompts longer than C tokens in C-token "
                        "chunks (bounds prefill memory at long context; "
                        "0 disables)")
    p.add_argument("--attn-impl", choices=["auto", "plain", "flash", "probe"],
                   default="auto",
                   help="attention: auto (the CUDA kernels on a card when "
                        "the model has their shape), plain (PyTorch), flash "
                        "(the CUDA kernels K1/K2, K4 for an int8 cache), or "
                        "probe (time the decode step's captured graph on each "
                        "viable path once per cache bucket and keep the "
                        "fastest; prefill keeps the auto rules)")
    p.add_argument("--decode-chunk", type=int, default=0, metavar="K",
                   help="streaming (greedy or sampled) decodes K tokens per "
                        "device dispatch (a captured K-step CUDA graph, identical "
                        "transcript; sampled runs keep their seeded RNG "
                        "sequence); 0 = auto: per-token on a host-attached "
                        "card, each step one captured graph")
    p.add_argument("--tp", type=int, default=0, metavar="N",
                   help="tensor parallelism: shard the model over N devices "
                        "(Megatron column/row splits, one all-reduce per "
                        "sub-block; one process per device; 0 = single device)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (default cuda; no fallback)")
    p.add_argument("--debug", action="store_true", help="write debug.log trace")
    p.add_argument("--narrate", action="store_true",
                   help="before generating, run one layer-at-a-time narrated "
                        "prefill showing each layer's time (the reference's "
                        "'Transformer block layer x/y took ...' lines; slower "
                        "than the served prefill)")
    p.add_argument("--tiny", action="store_true",
                   help="use a tiny random-weights model + synthetic tokenizer "
                        "(no model files needed; for smoke-testing the stack)")
    p.add_argument("--meta", action="store_true",
                   help="print model metadata and exit")
    return p.parse_args(argv)


def discover_model_dir(flag_value: Optional[str]) -> str:
    candidates = []
    if flag_value:
        candidates.append(flag_value)
    for root in (".", "..", "../..", os.path.expanduser("~")):
        candidates.append(os.path.join(root, MODELS_DIR_NAME, MODEL_NAME))
        candidates.append(os.path.join(root, MODELS_DIR_NAME))
    found = find_model_dir(candidates)
    if found is None:
        sys.exit(
            f"error: model files not found. Searched: {candidates}\n"
            "Expected consolidated.00.pth, params.json, tokenizer.model "
            "(pass --model-dir, or --tiny for a weights-free demo)")
    return found


def load_tiny_model(device):
    """Random tiny model + byte-level tokenizer: exercises the whole stack
    (load → tokenize → generate → stream → repaint) without the 16 GB files."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import init_random_params
    from llama_nuts_and_bolts_tpu_torch.models.llama.loader import LoadedModel
    from llama_nuts_and_bolts_tpu_torch.tokenizer import TiktokenModel, Vocabulary
    from llama_nuts_and_bolts_tpu_torch.tokenizer.tiktoken_io import build_special_tokens

    ranks = {bytes([i]): i for i in range(256)}
    special = build_special_tokens(len(ranks))
    tk = TiktokenModel(
        mergeable_ranks=ranks, special_tokens=special,
        bos_id=special["<|begin_of_text|>"], eos_id=special["<|end_of_text|>"],
        stop_token_ids=[special["<|eom_id|>"], special["<|eot_id|>"]])
    vocab = Vocabulary.from_tiktoken(tk)
    cfg = ModelArgs(dim=256, n_layers=4, n_heads=8, n_kv_heads=4,
                    vocab_size=vocab.size, multiple_of=64,
                    max_sequence_length=512)
    params = init_random_params(cfg, seed=0, device=device)
    return LoadedModel(params=params, cfg=cfg, vocab=vocab,
                       mergeable_ranks=ranks, tensor_meta={})


def ask_user_prompt_choice(model, out=sys.stdout) -> PromptInput:
    from llama_nuts_and_bolts_tpu_torch.cli.meta import format_meta

    n = len(PREDEFINED_PROMPTS)
    while True:
        out.write("\x1b[1mSelect from our predefined prompts (latest two are for manual input):\x1b[0m\n")
        out.write(f"{0:2d}. {'':<17} Print model metadata (tensor list, hyperparameters, etc...)\n")
        for i, pp in enumerate(PREDEFINED_PROMPTS):
            if pp.is_chat_mode:
                system = pp.system_prompt or "(empty)"
                out.write(f"{i+1:2d}. {'[Chat mode]':<17} \x1b[1mSystem Prompt:\x1b[0m {system}\n"
                          f"{'':22}\x1b[1mPrompt:\x1b[0m {pp.prompt}\n")
            else:
                out.write(f"{i+1:2d}. {'[Text completion]':<17} \x1b[1mPrompt:\x1b[0m {pp.prompt}\n")
        out.write(f"{n+1:2d}. {'[Text completion]':<17} Other, manual input\n")
        out.write(f"{n+2:2d}. {'[Chat mode]':<17} Other, manual input\n")
        out.write(f"\n\x1b[1mYour choice (choose 0 to {n+2} and press Enter):\x1b[0m ")
        out.flush()
        try:
            choice = input().strip()
        except EOFError:
            sys.exit("\nno input; exiting")
        try:
            num = int(choice)
        except ValueError:
            out.write("\nNot a valid number.\n\n")
            continue
        if num < 0 or num > n + 2:
            out.write(f"\nChoice must be between 0 and {n+2}.\n\n")
            continue
        if num == 0:
            out.write(format_meta(model))
            out.write("\nModel metadata was printed.\n\n")
            continue
        if num <= n:
            return PREDEFINED_PROMPTS[num - 1]
        is_chat = num == n + 2
        system_prompt = ""
        if is_chat:
            out.write("\x1b[1mWrite down your \"system prompt\" (optional) and press Enter:\x1b[0m ")
            out.flush()
            system_prompt = input().rstrip("\r\n")
            out.write("\x1b[1mWrite down your prompt (chat) and press Enter:\x1b[0m ")
        else:
            out.write("\x1b[1mWrite down your prompt and press Enter:\x1b[0m ")
        out.flush()
        prompt = input().rstrip("\r\n")
        if not prompt:
            out.write("\nThe prompt you entered is empty.\n")
            continue
        return PromptInput(prompt=prompt, system_prompt=system_prompt, is_chat_mode=is_chat)


def prompt_tokens(engine: InferenceEngine, prompt_input: PromptInput) -> List[int]:
    if prompt_input.is_chat_mode:
        parts: List[PromptPart] = [
            PromptPart("system", prompt_input.system_prompt),
            PromptPart("user", prompt_input.prompt),
        ]
        return engine.tokenize(parts)
    text = prompt_input.prompt
    if not text.endswith(" "):
        text += " "
    return [engine.model.vocab.bos_id] + engine.tokenize_string(text)


def narrate_prefill(engine: InferenceEngine, tokens: List[int], log_fn) -> None:
    """One layer-at-a-time prefill of ``tokens`` into a fresh cache on the
    attention path the engine's prefill takes (K1 on a card), each line
    through ``log_fn`` (the reference: src/model/llamatransformer.go:163)."""
    import torch

    from llama_nuts_and_bolts_tpu_torch.runtime.profiling import narrated_forward

    cache = engine.new_cache(1)
    tok = torch.tensor([tokens], dtype=torch.int32, device=engine.device)
    narrated_forward(engine.model.params, engine.model.cfg, tok, 0, cache, log_fn=log_fn,
                     attn_impl=engine._attn_impl(len(tokens), cache.max_seq),
                     logits_at=len(tokens) - 1, mesh=engine.mesh)


def run_generation(engine: InferenceEngine, tokens: List[int],
                   app: AppState, narrate: bool = False) -> GenerationState:
    prompt_pieces, prompt_text = engine.token_batch_to_string(tokens)
    app.begin_generation(prompt_pieces, prompt_text, engine.seq_len)
    if narrate:
        def narrate_log(msg):
            engine.log("%s", msg)
            app.latest_log_text = msg
            app.update_output()

        narrate_prefill(engine, tokens, narrate_log)
    for part in engine.generate_string(tokens):
        app.consume(part)
    app.finish_generation()
    return app.generation_state


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.tiny and args.draft_model:
        raise SystemExit(TINY_DRAFT_REFUSAL)
    if args.tp > 1:
        return run_tensor_parallel(argv, args)
    return run(args, resolve_device(args.device))


# ------------------------------------------------------- tensor parallelism


def run_tensor_parallel(argv: List[str], args) -> int:
    """Rank 0 of ``--tp N`` (``parallel/launch.py``): start the followers,
    run, and wait for them; nonzero if any rank failed."""
    return launch(_run_rank, argv, args.tp, args.device)


def _run_rank(argv: List[str], rank: int, port: int) -> int:
    """One rank of ``--tp N``: join the group, build the mesh and run."""
    args = parse_args(argv)
    with rank_group(rank, args.tp, port, args.device) as (device, mesh, control):
        return run(args, device, mesh, rank, control)


def run(args, device, mesh=None, rank: int = 0, control=None) -> int:
    """The CLI on ``device``; under ``mesh``, this rank's part of it."""
    say = print if rank == 0 else (lambda *a, **k: None)
    say("Welcome to Llama 3.1 Nuts and Bolts (PyTorch/CUDA port)!")
    say("=================================\n\n")

    set_logger(Logger(debug_path="debug.log" if args.debug and rank == 0 else None))
    if mesh is not None:
        say(f"Tensor parallelism: tp={args.tp} over {args.tp} devices.")

    quant = None if args.quant == "none" else args.quant
    if args.tiny:
        model = load_tiny_model(device)
        if quant is not None:
            from llama_nuts_and_bolts_tpu_torch.quant import (
                quantize_params,
                quantize_params_q4,
            )

            qfn = quantize_params_q4 if quant == "int4" else quantize_params
            model.params = qfn(model.params)
            say(f"Tiny demo model loaded ({quant}-quantized).\n")
        else:
            say("Tiny random-weights demo model loaded.\n")
        if mesh is not None:
            from llama_nuts_and_bolts_tpu_torch.parallel import shard_params

            model.params = shard_params(model.params, mesh)
        elif quant is None:
            from llama_nuts_and_bolts_tpu_torch.models.llama import fuse_decode_params

            # the fused decode layout is the default for single-device bf16
            model.params = fuse_decode_params(model.params)
    else:
        from llama_nuts_and_bolts_tpu_torch.models.llama.loader import load_llama_model

        model_dir = discover_model_dir(args.model_dir)
        say(f'Found model files in "{model_dir}"...')
        sharding_fn = None
        if mesh is not None:
            from llama_nuts_and_bolts_tpu_torch.parallel import param_sharding_fn

            sharding_fn = param_sharding_fn(mesh)
        # only single-device unquantized weights take the fused decode layout
        model = load_llama_model(model_dir, max_sequence_length=args.seq_len,
                                 fused=quant is None and mesh is None, device=device,
                                 quant=quant, sharding_fn=sharding_fn)
        say(f'Model "{model_dir}" was loaded.\n')

    if args.meta:
        from llama_nuts_and_bolts_tpu_torch.cli.meta import format_meta

        say(format_meta(model))
        return 0

    app = AppState()

    def live_log(fmt, *a):
        # surfaces engine progress in the "Running for next token" line
        app.latest_log_text = (fmt % a) if a else fmt
        if app.prompt_text:
            app.update_output()

    draft = None
    if args.draft_model:
        from llama_nuts_and_bolts_tpu_torch.models.llama.loader import load_llama_model

        draft = load_llama_model(args.draft_model, max_sequence_length=args.seq_len,
                                 device=device)
        say(f'Draft model "{args.draft_model}" was loaded.\n')

    engine = InferenceEngine(
        model,
        InferenceArgs(sequence_length=args.seq_len, temperature=args.temperature,
                      top_k=args.top_k, top_p=args.top_p,
                      speculate_k=args.speculate, kv_cache_dtype=args.kv_cache,
                      prefill_chunk=args.prefill_chunk,
                      attn_impl=args.attn_impl,
                      decode_chunk=args.decode_chunk),
        log_fn=live_log,
        draft_model=draft,
        device=device,
        mesh=mesh,
    )

    if rank > 0:
        # follow rank 0's requests until its quit sentinel (None)
        while (tokens := broadcast(None, control)) is not None:
            run_generation(engine, tokens, app, narrate=args.narrate)
        return 0

    if args.prompt is not None:
        prompt_input = PREDEFINED_PROMPTS[args.prompt - 1]
    elif args.prompt_text is not None:
        prompt_input = PromptInput(prompt=args.prompt_text,
                                   system_prompt=args.system_prompt,
                                   is_chat_mode=args.chat)
    else:
        prompt_input = ask_user_prompt_choice(model)

    tokens = prompt_tokens(engine, prompt_input)
    if mesh is not None:
        broadcast(tokens, control)
    state = run_generation(engine, tokens, app, narrate=args.narrate)
    if mesh is not None:
        broadcast(None, control)
    reason = {
        GenerationState.FINISHED_BY_REACHING_EOS: "reaching EOS token",
        GenerationState.FINISHED_BY_REACHING_SEQ_LEN: "reaching sequence length",
    }.get(state, "unknown")
    print(f"\n\nFinished \x1b[1mby {reason}\x1b[0m.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
