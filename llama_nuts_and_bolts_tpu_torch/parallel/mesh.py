"""The device mesh for tensor parallelism, and the collectives on its tp axis.

Port of ``llama_nuts_and_bolts_tpu/parallel/mesh.py``. JAX drives every
device from one process and XLA emits the collectives from the sharding
annotations; PyTorch runs one process per card, so here the mesh is a
``torch.distributed`` :class:`DeviceMesh` over the process group, with the
JAX package's axis names ``("dp", "sp", "tp")``, and the model calls the
collectives itself (``models/llama/model.py``):

  * :func:`reduce_partial`: the all-reduce after a row-split projection
    (``wo``, ``w_down``), one a sub-block;
  * :func:`gather_last`: the all-gather of a column-split result along its
    last axis (the vocab-sharded logits, an activation a replicated weight
    needs whole).

Rank ``r`` of a card group drives ``cuda:r`` over NCCL; on the CPU the group
is gloo. Only the tp axis runs here: ``dp`` and ``sp`` are ROADMAP item 17b.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

MESH_AXES = ("dp", "sp", "tp")
ITEM_17B = "ROADMAP item 17b"


def make_mesh(tp: Optional[int] = None, dp: int = 1, sp: int = 1):
    """The ``(dp, sp, tp)`` mesh over the initialized process group (one
    rank a device). ``tp=None`` puts every rank on tp. The device type
    follows the group's backend: ``cuda`` for NCCL, ``cpu`` for gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_multihost(...) or dist.init_process_group first")
    n = dist.get_world_size()
    if tp is None:
        tp = n // (dp * sp)
    total = dp * sp * tp
    if total > n or total == 0 or n % max(total, 1) != 0:
        raise ValueError(
            f"dp({dp}) * sp({sp}) * tp({tp}) incompatible with device count ({n})")
    if dp > 1 or sp > 1:
        raise NotImplementedError(f"the dp and sp axes are {ITEM_17B}; this port "
                                  "shards on tp only")
    if total != n:
        raise ValueError(f"a mesh of {total} ranks in a group of {n}: each rank "
                         "drives one device, so the mesh spans the whole group")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, sp, tp), mesh_dim_names=MESH_AXES)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """The process group, from the JAX package's arguments: rank
    ``process_id`` of ``num_processes`` meeting at ``coordinator_address``
    (``host:port``). No-op when no coordinator is given (single process).
    The backend defaults to NCCL when the process has a card, else gloo;
    a card rank drives ``cuda:process_id % cards``."""
    if coordinator_address is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)


def tp_size(mesh) -> int:
    """Ranks on the mesh's tp axis (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index("tp")]


def tp_rank(mesh) -> int:
    """This process's index on the tp axis (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank("tp")


def tp_group(mesh):
    return mesh.get_group("tp")


def tp_backend(mesh) -> str:
    return dist.get_backend(tp_group(mesh))


def reduce_partial(partial: torch.Tensor, mesh, dtype: torch.dtype) -> torch.Tensor:
    """Sum ``partial`` over the tp axis, in place, and cast the sum to
    ``dtype`` once. Nothing is read back to the host, so a captured decode
    step holds the collective."""
    dist.all_reduce(partial, group=tp_group(mesh))
    return partial.to(dtype)


def gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x [..., n]`` of every tp rank, concatenated in rank order along the
    last axis: ``[..., tp * n]``."""
    tp = tp_size(mesh)
    lead, n = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, n).contiguous()
    parts = torch.empty((tp,) + tuple(flat.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(parts.unbind(0)), flat, group=tp_group(mesh))
    return parts.permute(1, 0, 2).reshape(*lead, tp * n)


def broadcast_choice(index: int, mesh, device: torch.device) -> int:
    """Rank 0's ``index`` on every rank of the tp axis (the probe's choice,
    so that every rank captures the same graphs)."""
    t = torch.tensor([index], dtype=torch.int64, device=device)
    src = dist.get_global_rank(tp_group(mesh), 0)
    dist.broadcast(t, src=src, group=tp_group(mesh))
    return int(t.item())
