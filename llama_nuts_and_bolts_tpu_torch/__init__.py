"""llama_nuts_and_bolts_tpu_torch — the PyTorch/CUDA port of llama_nuts_and_bolts_tpu.

Same layout and module names as the JAX package, so each counterpart is
found by path; PyTorch idiom inside. The JAX package stays the reference and
nothing here imports it. Entry points run on ``cuda`` unless the caller asks
for the CPU.

  cli/        interactive console app
  runtime/    inference engine, streaming, detokenizer, emoji
  models/     Llama forward pass, random init, checkpoint loader, weight bridge
  io/         params.json
  tokenizer/  tiktoken ranks file, BPE, chat template
  ops/        plain PyTorch ops (norm, linear, attention, swiglu, sampling)
  kernels/    hand-written CUDA kernels (csrc/) with their plain versions
  parallel/   tensor parallelism over torch.distributed (mesh, splits)
  utils/      logging, test comparators
"""

__version__ = "0.1.0"
