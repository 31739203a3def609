"""One process a rank: the process model of ``--tp N``, for the CLI and the server.

The JAX package drives every device from one process; PyTorch runs one
process a device. ``--tp N`` stays one command: :func:`launch` makes this
process rank 0 and spawns N - 1 followers (``torch.multiprocessing``,
spawn), which meet it at a free localhost port (:func:`rank_group`). Rank r
drives ``cuda:r`` over NCCL; with ``--device cpu`` the group is gloo.

Rank 0 owns the console, the HTTP socket and the logs (a follower's stdout
goes to /dev/null). What the followers must run next -- a prompt, an engine
call, a batcher's step record -- rank 0 sends over a gloo *control group*
of its own (:func:`broadcast`), whose collectives wait a day: a person may
type for minutes and a server idle for hours, and NCCL never waits on
either.

Failures end every rank within a bounded time, never in a collective that
a dead rank will not join: rank 0 watches its followers, and one that exits
with a non-zero code (or is killed) makes rank 0 print which, stop the
others and exit 1 within ``WATCH_S``; a follower whose rank 0 is gone exits
too. A rank whose run fails (rank 0's batcher thread included) ends at
once through :func:`abort`, without leaving the group: the others may be
inside a collective it will never join, and leaving would wait on them.
``--tp N`` with fewer than N cards raises before any rank starts. Every
rank that ends cleanly leaves the group through :func:`leave_group`.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import socket
import sys
import threading
import time
from datetime import timedelta
from typing import Callable, List

FOLLOWER_JOIN_S = 120.0      # how long rank 0 waits for a follower to exit
WATCH_S = 0.5                # how often the ranks look at each other
CONTROL_TIMEOUT = timedelta(days=1)

# entry(argv, rank, port) -> exit code: one rank's whole run
Entry = Callable[[List[str], int, int], int]


def check_cards(tp: int, device: str) -> None:
    """``--tp N`` on cards needs N of them: one rank a card, no sharing."""
    if device != "cuda":
        return
    from llama_nuts_and_bolts_tpu_torch.device import resolve_device

    resolve_device("cuda")
    import torch

    n = torch.cuda.device_count()
    if n < tp:
        raise RuntimeError(f"--tp {tp} needs {tp} CUDA devices (one a rank); this "
                           f"machine has {n}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(entry: Entry, argv: List[str], tp: int, device: str) -> int:
    """Rank 0 of ``tp``: start the followers, run ``entry(argv, 0, port)``
    here, and wait for them; nonzero if any rank failed."""
    import torch.multiprocessing as mp

    check_cards(tp, device)
    port = free_port()
    ctx = mp.get_context("spawn")
    followers = [ctx.Process(target=_follower, args=(_entry_name(entry), argv, r, port),
                             daemon=True) for r in range(1, tp)]
    for f in followers:
        f.start()
    done = threading.Event()
    threading.Thread(target=_watch_followers, args=(followers, done), daemon=True,
                     name="tp-watch").start()
    ok = False
    try:
        rc = entry(argv, 0, port)
        ok = True
    finally:
        done.set()
        for f in followers:
            f.join(FOLLOWER_JOIN_S if ok else 5.0)
            if f.is_alive():
                f.terminate()
                f.join()
    failed = [r for r, f in enumerate(followers, 1) if f.exitcode != 0]
    if failed:
        print(f"error: tensor-parallel ranks {failed} exited with "
              f"{[followers[r - 1].exitcode for r in failed]}", file=sys.stderr)
        return 1
    return rc


def abort(why: str) -> None:
    """End this rank now with code 1, saying ``why`` on stderr; the other
    ranks' watches end them."""
    print(f"error: {why}", file=sys.stderr, flush=True)
    os._exit(1)


def _watch_followers(followers, done: threading.Event) -> None:
    """Rank 0's watch: a follower gone with a non-zero code (or a signal)
    while rank 0 runs ends rank 0 at once, with code 1."""
    while not done.wait(WATCH_S):
        dead = [(r, f.exitcode) for r, f in enumerate(followers, 1)
                if f.exitcode not in (None, 0)]
        if dead and not done.is_set():
            print(f"error: tensor-parallel rank(s) {[r for r, _ in dead]} exited with "
                  f"{[c for _, c in dead]}; rank 0 stops", file=sys.stderr, flush=True)
            for f in followers:
                if f.exitcode is None:
                    f.kill()
            os._exit(1)


def _watch_parent(parent: int) -> None:
    """A follower's watch: rank 0 gone (the follower re-parented) ends it."""
    while os.getppid() == parent:
        time.sleep(WATCH_S)
    os._exit(1)


def _entry_name(entry: Entry) -> str:
    """``module:function`` of ``entry``; a ``python -m pkg`` run's
    ``__main__`` by its module's name (spawn does not re-import a package's
    ``__main__``)."""
    module = entry.__module__
    if module == "__main__":
        module = sys.modules["__main__"].__spec__.name
    return f"{module}:{entry.__qualname__}"


def _follower(entry: str, argv: List[str], rank: int, port: int) -> None:
    sys.stdout = open(os.devnull, "w")      # rank 0 owns the console
    threading.Thread(target=_watch_parent, args=(os.getppid(),), daemon=True,
                     name="tp-parent").start()
    module, name = entry.split(":")
    sys.exit(getattr(importlib.import_module(module), name)(argv, rank, port))


@contextlib.contextmanager
def rank_group(rank: int, tp: int, port: int, device: str):
    """Join the group as ``rank`` of ``tp`` at ``port``; yields ``(device,
    mesh, control)`` and leaves the group after."""
    import torch
    import torch.distributed as dist

    from llama_nuts_and_bolts_tpu_torch.device import resolve_device
    from llama_nuts_and_bolts_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // tp))
    initialize_multihost(f"127.0.0.1:{port}", tp, rank, backend="nccl" if cuda else "gloo")
    try:
        control = new_control_group()
        dev = resolve_device(torch.device("cuda", rank) if cuda else "cpu")
        yield dev, make_mesh(tp=tp), control
    finally:
        leave_group()


def leave_group() -> None:
    """Leave the process group. A gloo group is destroyed. Under NCCL the
    reference cycles that keep captured graphs (and their collectives)
    alive are collected, the subgroups destroyed, and the default group's
    communicators aborted together, in one NCCL group: on four H100s, after
    the server had run, destroying the default group hung on every rank but
    one, and aborting it hung on rank 0 until its cycles were collected."""
    import gc

    import torch
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    if dist.get_backend() != "nccl":
        dist.destroy_process_group()
        return
    gc.collect()
    torch.cuda.synchronize()
    world = c10d._get_default_group()
    for pg in list(c10d._world.pg_names):
        if pg is not world:
            dist.destroy_process_group(pg)
    c10d._abort_process_group()


def new_control_group():
    """A gloo group over every rank whose collectives wait a day (a
    collective call on every rank, in the same order)."""
    import torch.distributed as dist

    return dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)


def broadcast(obj, control):
    """Rank 0's ``obj`` on every rank of the control group."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0, group=control)
    return box[0]
