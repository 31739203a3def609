"""K8: ``x[R, in] @ w.T`` with w in grouped packed int4, dequantized in the kernel.

Port of ``llama_nuts_and_bolts_tpu/kernels/q4_matmul.py::q4_matmul``. ``packed``
is uint8 ``[G, out, K/2]`` (byte ``j`` of a group holds element ``j`` in its
low nibble and ``j + K/2`` in its high nibble, both offset by +8), ``scale``
bf16 ``[G, out]``; the result is fp32 ``[R, out]``:

    out = sum over g, in order, of  scale[g] * (x_lo[g] @ lo[g].T + x_hi[g] @ hi[g].T)

The CUDA kernel is ``csrc/q4_matmul.cu`` (its header says what bounds it and
how it is laid out). It cuts the contraction into splits of whole groups
(:func:`k8_split`, from the shapes alone): each block sums its split's groups
in order into an fp32 partial of one 64-row out tile, and the block that
draws the tile's last ticket adds the partials in split order, in the same
launch. :func:`q4_matmul_plain` computes the same function in PyTorch on the
same partition: per group the dot of the low half plus the dot of the high
half with the exact integer weights and an fp32 accumulator, then ``acc +=
part * scale[g]`` from zero in each split, then the splits added in order.
Decode-shaped calls (R <= 32) take it on the card (``ops/linear.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from llama_nuts_and_bolts_tpu_torch.kernels.build import (
    check_launch,
    cuda_stream,
    library,
    split_workspace,
)

K8_MAX_ROWS = 32          # the kernel is built for R up to 32
# x rows per build, one per count of 8-row mma n-tiles (1, 2 or 4); R runs on
# the first bucket that holds it, its padded rows zero and never written
K8_ROW_BUCKETS = (8, 16, 32)
K8_OUT_TILE = 64          # out rows per block: one 16-row mma tile per warp
K8_HALF_TILE = 128        # packed bytes of one group row per k pass
K8_MAX_HALF = 512         # K/2 up to which four ring stages and x fit a block
K8_X_BYTES = 64 * 1024    # the most bytes of x a block stages (csrc: X_BYTES)
K8_SMS = 132              # H100 SXM streaming multiprocessors
# the fewest splits whose blocks reach 1.5 per SM, at most 8 partials a tile
# but where x's budget needs more: the fastest split at every 8B shape at
# R = 1 in a sweep on an H100 (PERF.md §6, kernels/k8_splits.py); 2 blocks
# per SM ran slower
K8_MIN_BLOCKS = K8_SMS * 3 // 2
K8_MAX_SPLITS = 8


def k8_split(R: int, in_dim: int, out_dim: int, G: int) -> int:
    """Groups per split of the contraction, from the shapes alone: the
    fewest splits (at most ``K8_MAX_SPLITS``) whose ``out / 64`` tiles make
    ``K8_MIN_BLOCKS`` blocks, where the groups allow it (one group per split
    is the most), and no more groups than the ``R`` rows of x a block stages
    fit in ``K8_X_BYTES``. The last split takes what is left, so a split
    need not divide G; a split never cuts a group."""
    K = in_dim // G
    tiles = out_dim // K8_OUT_TILE
    wanted = min(-(-K8_MIN_BLOCKS // tiles), K8_MAX_SPLITS)
    return max(1, min(G // wanted, K8_X_BYTES // (R * K * 2)))


def k8_takes(rows: int, packed: torch.Tensor) -> bool:
    """Whether a product of ``rows`` rows with this weight runs the kernel on
    a card (``ops/linear.py``): the JAX package's rule (at most 32 rows, one
    layer's 3-D ``packed``, ``K/2`` and ``out`` multiples of 128), and a
    group this build holds (``K/2`` at most ``K8_MAX_HALF``)."""
    if packed.dim() != 3:
        return False
    _, out_dim, half = packed.shape
    return (rows <= K8_MAX_ROWS and half % K8_HALF_TILE == 0 and half <= K8_MAX_HALF
            and out_dim % 128 == 0)


def k8_row_bucket(R: int) -> int:
    """The build that takes R rows of x: the first of ``K8_ROW_BUCKETS``
    that holds them."""
    if not 1 <= R <= K8_MAX_ROWS:
        raise ValueError(f"the K8 kernel takes 1..{K8_MAX_ROWS} rows, got {R}")
    return next(b for b in K8_ROW_BUCKETS if b >= R)


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


def q4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                    split: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in PyTorch, on its partition (fp32 throughout:
    the bf16 x and the integer weights are exact in fp32). ``split`` is the
    groups per split, :func:`k8_split`'s when None."""
    G, out_dim, half = packed.shape
    R, in_dim = x.shape
    K = 2 * half
    split = split or k8_split(R, in_dim, out_dim, G)
    if split < 1:
        raise ValueError(f"a split takes at least one group, got {split}")
    xf = x.to(torch.bfloat16).float()
    out = None
    for g0 in range(0, G, split):
        acc = torch.zeros((R, out_dim), dtype=torch.float32, device=x.device)
        for g in range(g0, min(G, g0 + split)):
            p = packed[g].to(torch.int32)
            lo = ((p & 0xF) - 8).float()
            hi = ((p >> 4) - 8).float()
            part = xf[:, g * K:g * K + half] @ lo.t()
            part += xf[:, g * K + half:(g + 1) * K] @ hi.t()
            acc += part * scale[g].float()
        out = acc if out is None else out + acc
    return out


def k8_scratch(device: torch.device, R: int, out_dim: int,
               n_splits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's workspace for a launch on the current stream
    (:func:`build.split_workspace`): every split's fp32 partial ``[R, 64]``
    of every out tile, and one ticket counter per tile."""
    tiles = out_dim // K8_OUT_TILE
    return split_workspace(device, ("k8", R, out_dim, n_splits),
                           tiles * n_splits * R * K8_OUT_TILE, tiles)


def q4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
              split: Optional[int] = None) -> torch.Tensor:
    """Returns fp32 ``[R, out]``; x is taken in bf16, as the JAX kernel
    does. ``split`` is the groups per split; callers on the model's path
    leave it to :func:`k8_split` (None), and tests and ``k8_splits`` force
    other partitions with it. CUDA tensors launch the kernel (and count it
    in ``launches``); CPU tensors take :func:`q4_matmul_plain`."""
    _check(x, packed, scale)
    if x.device.type == "cpu":
        return q4_matmul_plain(x, packed, scale, split)
    if x.device.type != "cuda":
        raise ValueError(f"K8 runs on cuda or cpu tensors, got {x.device}")
    R, in_dim = x.shape
    G, out_dim, half = packed.shape
    rows = k8_row_bucket(R)
    if half % K8_HALF_TILE or half > K8_MAX_HALF or out_dim % K8_OUT_TILE:
        raise ValueError(f"the K8 kernel needs K/2 % {K8_HALF_TILE} == 0, K/2 <= "
                         f"{K8_MAX_HALF} and out % {K8_OUT_TILE} == 0, got K/2={half}, "
                         f"out={out_dim}")
    for name, t in (("packed", packed), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"K8 takes a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"K8 takes a 16-byte aligned {name}")
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    split = split or k8_split(R, in_dim, out_dim, G)
    if not 1 <= split <= min(G, K8_X_BYTES // (R * 4 * half)):
        raise ValueError(f"a split of {split} groups: K8 takes 1..G = {G}, and as many as "
                         f"R = {R} rows of x fit in {K8_X_BYTES} bytes")
    n_splits = -(-G // split)
    scratch = (0, 0)                       # one split writes out directly
    if n_splits > 1:
        scratch = tuple(t.data_ptr() for t in k8_scratch(x.device, R, out_dim, n_splits))
    out = torch.empty((R, out_dim), dtype=torch.float32, device=x.device)
    fn = library("q4_matmul").lnb_q4_matmul
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 *scratch, R, rows, in_dim, out_dim, G, half, split, cuda_stream(x.device))
    check_launch(err, "q4_matmul")
    q4_matmul.launches += 1
    return out


q4_matmul.launches = 0
