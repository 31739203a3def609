"""Weight-only int8 quantization (per-output-channel, symmetric).

Port of ``llama_nuts_and_bolts_tpu/quant/quantize.py``. For each weight
matrix ``w[out, in]`` (stacked ``[L, out, in]``), ``q = round(w / scale)``
with ``scale[out] = max|w[out, :]| / 127``, rounded half to even and clipped
at ±127, the scale stored in bf16. The bytes are identical to the JAX
package's. ``ops.linear`` takes a :class:`QTensor` as it is: the int8 matrix
is cast to bf16 for the product and the scale multiplies the fp32 result.
Norms, embeddings and the RoPE tables stay as they are.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from llama_nuts_and_bolts_tpu_torch.device import exact_div, resolve_device
from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs, refuse_experts
from llama_nuts_and_bolts_tpu_torch.models.llama.model import (
    LlamaParams,
    layer_weight_shapes,
    rope_tables,
)

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclass
class QTensor:
    """int8 values + per-output-channel bf16 scales; shape = q.shape.
    Indexing the leading (layer) axis gives a view of one layer."""

    q: torch.Tensor        # int8 [..., out, in]
    scale: torch.Tensor    # bf16 [..., out]

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def device(self) -> torch.device:
        return self.q.device

    def __getitem__(self, i) -> "QTensor":
        return QTensor(q=self.q[i], scale=self.scale[i])


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """Per-output-channel symmetric int8 over the last (contraction) dim."""
    w32 = w.float()
    scale = exact_div(w32.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(1e-8)
    q = torch.round(w32 / scale).clamp(-127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale[..., 0].to(torch.bfloat16))


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (qt.q.float() * qt.scale.float()[..., None]).to(dtype)


def stack_quantized(parts, cls):
    """Per-layer quantized tensors stacked to one ``[L, ...]`` tensor."""
    fields = [f for f in ("q", "packed", "scale") if hasattr(parts[0], f)]
    return cls(**{f: torch.stack([getattr(p, f) for p in parts]) for f in fields})


def quantize_params(params: LlamaParams, quantize_output: bool = True) -> LlamaParams:
    """int8-quantize the matmul weight groups of checkpoint-layout params,
    one layer at a time (the bytes do not depend on the batching: every row
    is quantized on its own)."""
    refuse_experts(expert_count(params), "int8 weights")
    layers = dict(params.layers)
    for key in QUANT_KEYS:
        w = layers[key]
        layers[key] = stack_quantized([quantize_tensor(w[i]) for i in range(w.shape[0])],
                                      QTensor)
    output = quantize_tensor(params.output) if quantize_output else params.output
    return LlamaParams(tok_embeddings=params.tok_embeddings, layers=layers,
                       norm=params.norm, output=output,
                       rope_cos=params.rope_cos, rope_sin=params.rope_sin)


def expert_count(params: LlamaParams) -> int:
    """Experts a layer of ``params`` (0: a dense model)."""
    router = params.layers.get("router")
    return 0 if router is None else router.shape[1]


def init_random_params_q8(cfg: ModelArgs, seed: int = 0, device=None) -> LlamaParams:
    """Random int8 params made directly as int8 from a seeded
    ``torch.Generator``, one layer at a time, so the full 32-layer 8B
    architecture is built without a bf16 copy. Values are uniform on
    [-127, 127] (a byte, -128 clipped), scales ``1 / (127 sqrt(in))``."""
    refuse_experts(cfg.n_experts, "int8 weights")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand_int8(shape):
        bits = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8, device=dev)
        return bits.view(torch.int8).clamp_(min=-127)

    def rand_q(shape) -> QTensor:
        q = torch.empty(shape, dtype=torch.int8, device=dev)
        for i in range(shape[0]):           # one layer at a time (the head: one)
            q[i] = rand_int8(shape[1:])
        scale = torch.full(shape[:-1], 1.0 / (127 * math.sqrt(shape[-1])),
                           dtype=torch.bfloat16, device=dev)
        return QTensor(q=q, scale=scale)

    L = cfg.n_layers
    layers = {}
    for name, shape in layer_weight_shapes(cfg).items():
        if name.endswith("norm"):
            layers[name] = torch.ones((L,) + shape, dtype=torch.bfloat16, device=dev)
        else:
            layers[name] = rand_q((L,) + shape)
    head = rand_q((1, cfg.vocab_size, cfg.dim))[0]
    emb = (torch.randn((cfg.vocab_size, cfg.dim), generator=gen, device=dev)
           / math.sqrt(cfg.dim)).to(torch.bfloat16)
    cos, sin = rope_tables(cfg, dev)
    return LlamaParams(tok_embeddings=emb, layers=layers,
                       norm=torch.ones((cfg.dim,), dtype=torch.bfloat16, device=dev),
                       output=head, rope_cos=cos, rope_sin=sin)
