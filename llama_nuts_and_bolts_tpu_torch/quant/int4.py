"""Weight-only int4 quantization (group-wise symmetric, packed nibbles).

Port of ``llama_nuts_and_bolts_tpu/quant/int4.py``; the packed bytes are
identical to the JAX package's. ``w[out, in]``'s contraction dim is split
into groups of ``group_size``; per (group, out) ``scale = max|w| / 7`` and
``q = round(w / scale)`` in [-8, 7], half to even.

Storage layout (group-major):

  packed: uint8 ``[..., G, out, K/2]``   (K = group_size)
  scale:  bf16  ``[..., G, out]``

Within a group, byte ``j`` holds element ``j`` in its low nibble and element
``j + K/2`` in its high nibble, each offset by +8. ``ops.linear`` runs a
:class:`Q4Tensor` through K8 (``kernels/q4_matmul.py``) for decode-shaped
calls on the card and through :func:`unpack_q4` and a dense product
otherwise. The JAX package's ``Q4Native`` / ``nativize_q4`` unpack the int4
weights once per jitted on-device decode block; the port has no
counterpart, because K8 reads the packed bytes themselves, so a captured
decode block (``runtime/device_loop.py``) has nothing to unpack.
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
from llama_nuts_and_bolts_tpu_torch.quant.quantize import (
    QUANT_KEYS,
    expert_count,
    stack_quantized,
)

DEFAULT_GROUP = 256


@dataclass
class Q4Tensor:
    """Packed int4 weights + per-(group, out) bf16 scales. Indexing the
    leading (layer) axis gives a view of one layer."""

    packed: torch.Tensor   # uint8 [..., G, out, K/2]
    scale: torch.Tensor    # bf16  [..., G, out]

    @property
    def shape(self):
        """Logical dense shape ``[..., out, in]``."""
        *lead, G, out, half = self.packed.shape
        return tuple(lead) + (out, G * half * 2)

    @property
    def ndim(self) -> int:
        return self.packed.dim() - 1

    @property
    def group_size(self) -> int:
        return self.packed.shape[-1] * 2

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def __getitem__(self, i) -> "Q4Tensor":
        return Q4Tensor(packed=self.packed[i], scale=self.scale[i])


def fit_group(in_dim: int, group_size: int = DEFAULT_GROUP) -> int:
    """Largest divisor of ``in_dim`` that is <= ``group_size`` and even."""
    if in_dim % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {in_dim}")
    g = min(group_size, in_dim)
    while in_dim % g or g % 2:
        g -= 1
    return g


def quantize_tensor_q4(w: torch.Tensor, group_size: int = DEFAULT_GROUP) -> Q4Tensor:
    """Group-wise symmetric int4 over the last (contraction) dim of
    ``w[..., out, in]``, in the grouped storage layout."""
    *lead, out, in_dim = w.shape
    K = fit_group(in_dim, group_size)
    G = in_dim // K
    n = len(lead)
    wg = w.float().reshape(*lead, out, G, K).movedim(n + 1, n)      # [..., G, out, K]
    scale = exact_div(wg.abs().amax(dim=-1, keepdim=True), 7.0).clamp_min(1e-8)
    q = torch.round(wg / scale).clamp(-8, 7).to(torch.int32) + 8
    half = K // 2
    packed = (q[..., :half] | (q[..., half:] << 4)).to(torch.uint8)
    return Q4Tensor(packed=packed.contiguous(),
                    scale=scale[..., 0].to(torch.bfloat16).contiguous())


def host_quantize_q4(host: torch.Tensor, group_size: int = DEFAULT_GROUP):
    """:func:`quantize_tensor_q4` on the CPU, for checkpoint loading: a
    memory-mapped bf16 view becomes packed bytes before it reaches the card.
    Returns ``(packed, scale)`` CPU tensors."""
    qt = quantize_tensor_q4(host.to("cpu"), group_size)
    return qt.packed, qt.scale


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., K/2] → int32 [..., K] in [-8, 7] (split-half layout)."""
    p = packed.to(torch.int32)
    return torch.cat([(p & 0xF) - 8, (p >> 4) - 8], dim=-1)


def unpack_q4(qt: Q4Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize to a dense ``[..., out, in]`` tensor: each integer and its
    scale in ``dtype``, multiplied in ``dtype``."""
    deq = unpack_nibbles(qt.packed).to(dtype) * qt.scale[..., None].to(dtype)
    n = qt.packed.dim() - 3
    *lead, G, out, K = deq.shape
    return deq.movedim(n, n + 1).reshape(*lead, out, G * K)


def quantize_params_q4(params: LlamaParams, group_size: int = DEFAULT_GROUP,
                       quantize_output: bool = True) -> LlamaParams:
    """int4-quantize the matmul weight groups of checkpoint-layout params,
    one layer at a time."""
    refuse_experts(expert_count(params), "int4 weights")
    layers = dict(params.layers)
    for key in QUANT_KEYS:
        w = layers[key]
        layers[key] = stack_quantized(
            [quantize_tensor_q4(w[i], group_size) for i in range(w.shape[0])], Q4Tensor)
    output = (quantize_tensor_q4(params.output, group_size) if quantize_output
              else params.output)
    return LlamaParams(tok_embeddings=params.tok_embeddings, layers=layers,
                       norm=params.norm, output=output,
                       rope_cos=params.rope_cos, rope_sin=params.rope_sin)


def init_random_params_q4(cfg: ModelArgs, seed: int = 0, device=None,
                          group_size: int = DEFAULT_GROUP) -> LlamaParams:
    """Random packed-int4 params made directly as bytes from a seeded
    ``torch.Generator``, one layer at a time (~4.9 GB for the full 32-layer
    8B with its bf16 embedding). Scales are ``1 / (7 sqrt(in))``."""
    refuse_experts(cfg.n_experts, "int4 weights")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand_q4(shape) -> Q4Tensor:
        L, out, in_dim = shape
        K = fit_group(in_dim, group_size)
        G = in_dim // K
        packed = torch.empty((L, G, out, K // 2), dtype=torch.uint8, device=dev)
        for i in range(L):
            packed[i] = torch.randint(0, 256, packed.shape[1:], generator=gen,
                                      dtype=torch.uint8, device=dev)
        scale = torch.full((L, G, out), 1.0 / (7 * math.sqrt(in_dim)),
                           dtype=torch.bfloat16, device=dev)
        return Q4Tensor(packed=packed, scale=scale)

    L = cfg.n_layers
    layers = {}
    for name, shape in layer_weight_shapes(cfg).items():
        if name.endswith("norm"):
            layers[name] = torch.ones((L,) + shape, dtype=torch.bfloat16, device=dev)
        else:
            layers[name] = rand_q4((L,) + shape)
    head = rand_q4((1, cfg.vocab_size, cfg.dim))[0]
    emb = (torch.randn((cfg.vocab_size, cfg.dim), generator=gen, device=dev)
           / math.sqrt(cfg.dim)).to(torch.bfloat16)
    cos, sin = rope_tables(cfg, dev)
    return LlamaParams(tok_embeddings=emb, layers=layers,
                       norm=torch.ones((cfg.dim,), dtype=torch.bfloat16, device=dev),
                       output=head, rope_cos=cos, rope_sin=sin)
