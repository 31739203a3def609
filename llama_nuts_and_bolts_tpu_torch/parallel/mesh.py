"""The device mesh ``(dp, sp, tp)`` and the collectives on its axes.

Port of ``llama_nuts_and_bolts_tpu/parallel/mesh.py``. JAX drives every
device from one process and XLA emits the collectives from the sharding
annotations; PyTorch runs one process per card, so here the mesh is a
``torch.distributed`` :class:`DeviceMesh` over the process group, with the
JAX package's axis names ``("dp", "sp", "tp")`` (rank ``(d * sp + s) * tp
+ t`` sits at ``(d, s, t)``, as JAX's ``make_mesh`` reshapes its devices),
and the model calls the collectives itself (``models/llama/model.py``):

  * tp, the heads and the FFN width: :func:`reduce_partial`, the all-reduce
    after a row-split projection (``wo``, ``w_down``), and
    :func:`gather_last`, the all-gather of a column-split result along its
    last axis (the vocab-sharded logits, an activation a replicated weight
    needs whole);
  * sp, the prompt's rows in a sequence-parallel prefill: :func:`gather_seq`,
    the all-gather of every rank's rows in rank order (the new K/V rows each
    layer writes, the hidden rows of a whole-sequence head), :func:`rotate`,
    a tensor to the next rank of the ring (ring attention's
    ``lax.ppermute``), and :func:`broadcast_from`, one rank's tensor on all;
  * dp, the batch rows: :func:`gather_rows`, every rank's rows for a caller
    that needs the whole batch. The forward itself runs no dp collective:
    the weights are replicated on dp and a rank's rows meet no other's.

Rank ``r`` of a card group drives ``cuda:r % cards`` over NCCL; on the CPU
the group is gloo. Gloo's point-to-point ops take host tensors only, so
:func:`rotate` on a gloo group stages a card's tensor through the host,
explicitly and counted in :data:`HOST_STAGED`; on NCCL it sends the device
tensor as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

MESH_AXES = ("dp", "sp", "tp")
# card tensors a gloo group moved through the host, by collective
HOST_STAGED = {"rotate": 0}


def make_mesh(tp: Optional[int] = None, dp: int = 1, sp: int = 1):
    """The ``(dp, sp, tp)`` mesh over the initialized process group (one
    rank a device). ``tp=None`` puts every rank not on dp or sp on tp. The
    device type follows the group's backend: ``cuda`` for NCCL, ``cpu`` for
    gloo."""
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
    (``host:port``, reachable from every host). No-op when no coordinator
    is given (single process). The backend defaults to NCCL when the
    process has a card, else gloo; a card rank drives ``cuda:process_id %
    cards``, so consecutive process ids fill one host's cards."""
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


def axis_size(mesh, axis: str) -> int:
    """Ranks on one axis of the mesh (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh, axis: str) -> int:
    """This process's index on one axis (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def tp_size(mesh) -> int:
    return axis_size(mesh, "tp")


def tp_rank(mesh) -> int:
    return axis_rank(mesh, "tp")


def dp_size(mesh) -> int:
    return axis_size(mesh, "dp")


def dp_rank(mesh) -> int:
    return axis_rank(mesh, "dp")


def sp_size(mesh) -> int:
    return axis_size(mesh, "sp")


def sp_rank(mesh) -> int:
    return axis_rank(mesh, "sp")


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


def _gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``x`` of every rank of ``axis``, concatenated in rank order along
    ``dim`` (a one-rank axis gathers too: its copy is the collective's)."""
    n = axis_size(mesh, axis)
    moved = x.movedim(dim, 0).contiguous()
    parts = torch.empty((n,) + tuple(moved.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(parts.unbind(0)), moved, group=mesh.get_group(axis))
    return parts.flatten(0, 1).movedim(0, dim).contiguous()


def gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x [..., n]`` of every tp rank, concatenated in rank order along the
    last axis: ``[..., tp * n]``."""
    return _gather(x, mesh, "tp", -1)


def gather_seq(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """Every sp rank's rows of ``x`` in rank order along ``dim`` (the
    sequence): ``[B, S/sp, ...]`` -> ``[B, S, ...]``."""
    return _gather(x, mesh, "sp", dim)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every dp rank's batch rows of ``x`` in rank order: ``[B/dp, ...]`` ->
    ``[B, ...]``."""
    return _gather(x, mesh, "dp", 0)


def _peer(mesh, axis: str, index: int) -> int:
    """The global rank at ``index`` on ``axis`` beside this process."""
    return dist.get_global_rank(mesh.get_group(axis), index)


def rotate(x: torch.Tensor, mesh, axis: str = "sp") -> torch.Tensor:
    """``x`` of rank ``(i - 1) % n`` on rank ``i`` of ``axis``: each rank
    sends its tensor to ``(i + 1) % n`` (``lax.ppermute(perm=[(i, (i + 1) %
    n)])``). A gloo group moves a card tensor through the host (gloo's send
    and receive take host tensors), counted in ``HOST_STAGED``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    group = mesh.get_group(axis)
    i = axis_rank(mesh, axis)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    send = x.cpu() if staged else x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _peer(mesh, axis, (i + 1) % n), group),
           dist.P2POp(dist.irecv, recv, _peer(mesh, axis, (i - 1) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        HOST_STAGED["rotate"] += 1
        return recv.to(x.device)
    return recv


def broadcast_from(x: torch.Tensor, mesh, axis: str, index: int) -> torch.Tensor:
    """Rank ``index``'s ``x`` on every rank of ``axis`` (in place)."""
    if axis_size(mesh, axis) > 1:
        dist.broadcast(x, src=_peer(mesh, axis, index), group=mesh.get_group(axis))
    return x


def broadcast_choice(index: int, mesh, device: torch.device) -> int:
    """The mesh's first rank's ``index`` on every rank of the mesh (the
    probe's choice: every rank captures the same graphs, and the replicas
    on dp and sp run the same numbers)."""
    t = torch.tensor([index], dtype=torch.int64, device=device)
    dist.broadcast(t, src=int(mesh.mesh.flatten()[0]))
    return int(t.item())
