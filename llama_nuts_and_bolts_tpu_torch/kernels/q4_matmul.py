"""K8: ``x[R, in] @ w.T`` with w in grouped packed int4, dequantized in the kernel.

Port of ``llama_nuts_and_bolts_tpu/kernels/q4_matmul.py::q4_matmul``. ``packed``
is uint8 ``[G, out, K/2]`` (byte ``j`` of a group holds element ``j`` in its
low nibble and ``j + K/2`` in its high nibble, both offset by +8), ``scale``
bf16 ``[G, out]``; the result is fp32 ``[R, out]``:

    out = sum over g, in order, of  scale[g] * (x_lo[g] @ lo[g].T + x_hi[g] @ hi[g].T)

The CUDA kernel is ``csrc/q4_matmul.cu`` (its header says what bounds it and
how it is laid out); :func:`q4_matmul_plain` computes the same function in
PyTorch in the kernel's order: per group the dot of the low half plus the
dot of the high half with the exact integer weights and an fp32 accumulator,
then ``acc += part * scale[g]``. Decode-shaped calls (R <= 32) take it on the
card (``ops/linear.py``).
"""

from __future__ import annotations

import ctypes

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.build import check_launch, library

K8_MAX_ROWS = 32          # the kernel is built for R up to 32
# the row counts the path gives it (a decode step or the head: 1; prefill
# buckets 16 and 32); any other R runs on the next one, its extra rows zero
K8_ROW_BUCKETS = (1, 16, 32)
K8_OUT_TILE = 32          # out rows per block
K8_HALF_TILE = 128        # packed bytes of one group row read per pass


def _check(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dim() != 2 or packed.dim() != 3 or scale.dim() != 2:
        raise ValueError(f"expected x [R,in], packed [G,out,K/2], scale [G,out]; got "
                         f"{tuple(x.shape)}, {tuple(packed.shape)}, {tuple(scale.shape)}")
    R, in_dim = x.shape
    G, out_dim, half = packed.shape
    if in_dim != G * 2 * half:
        raise ValueError(f"x in dim {in_dim} != G*K = {G * 2 * half}")
    if tuple(scale.shape) != (G, out_dim):
        raise ValueError(f"scale {tuple(scale.shape)} != (G, out) = {(G, out_dim)}")
    if not x.is_floating_point():
        raise TypeError(f"K8 takes a floating x, got {x.dtype}")
    if packed.dtype != torch.uint8 or scale.dtype != torch.bfloat16:
        raise TypeError(f"K8 takes uint8 packed and bf16 scale, got {packed.dtype}, "
                        f"{scale.dtype}")
    for name, t in (("packed", packed), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def q4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch, in its order (fp32 throughout: the
    bf16 x and the integer weights are exact in fp32)."""
    G, out_dim, half = packed.shape
    K = 2 * half
    xf = x.to(torch.bfloat16).float()
    acc = torch.zeros((x.shape[0], out_dim), dtype=torch.float32, device=x.device)
    for g in range(G):
        p = packed[g].to(torch.int32)
        lo = ((p & 0xF) - 8).float()
        hi = ((p >> 4) - 8).float()
        part = xf[:, g * K:g * K + half] @ lo.t()
        part += xf[:, g * K + half:(g + 1) * K] @ hi.t()
        acc += part * scale[g].float()
    return acc


def q4_matmul(x: torch.Tensor, packed: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """Returns fp32 ``[R, out]``; x is taken in bf16, as the JAX kernel
    does. CUDA tensors launch the kernel (and count it in ``launches``); CPU
    tensors take :func:`q4_matmul_plain`."""
    _check(x, packed, scale)
    if x.device.type == "cpu":
        return q4_matmul_plain(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"K8 runs on cuda or cpu tensors, got {x.device}")
    R, in_dim = x.shape
    G, out_dim, half = packed.shape
    if not 1 <= R <= K8_MAX_ROWS:
        raise ValueError(f"the K8 kernel takes 1..{K8_MAX_ROWS} rows, got {R}")
    if half % K8_HALF_TILE or out_dim % K8_OUT_TILE:
        raise ValueError(f"the K8 kernel needs K/2 % {K8_HALF_TILE} == 0 and out % "
                         f"{K8_OUT_TILE} == 0, got K/2={half}, out={out_dim}")
    for name, t in (("packed", packed), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"K8 takes a contiguous {name}")
    if packed.data_ptr() % 16:
        raise ValueError("K8 takes a 16-byte aligned packed")
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    rows = next(b for b in K8_ROW_BUCKETS if b >= R)
    out = torch.empty((R, out_dim), dtype=torch.float32, device=x.device)
    fn = library("q4_matmul").lnb_q4_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 R, rows, in_dim, out_dim, G, half, stream)
    check_launch(err, "q4_matmul")
    q4_matmul.launches += 1
    return out


q4_matmul.launches = 0
