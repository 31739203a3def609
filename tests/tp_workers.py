"""Ranks of a tensor-parallel CPU run for ``tests/test_torch_tp.py``.

:func:`spawn` starts ``tp`` processes that meet over gloo at a free
localhost port, build the port's mesh and run jobs of :data:`JOBS`, each on
a payload the test saved with ``torch.save``; each rank saves its results,
and the test compares them. The ranks import the port and never JAX (this
module imports nothing of the tests that do). Each rank runs on one thread,
and a rank that hangs is killed at the join deadline, so a fault fails the
test instead of holding the run.
"""

from __future__ import annotations

import os
import traceback
from pathlib import Path
from typing import Any, Dict, List

import torch

JOIN_S = 150.0


def spawn(jobs: Dict[str, Any], tp: int, tmp: Path) -> List[Dict[str, Any]]:
    """Run ``JOBS[name](mesh, payload)`` for each ``name: payload`` of
    ``jobs``, in turn, on ``tp`` gloo ranks; by rank, each job's result."""
    import torch.multiprocessing as mp

    from llama_nuts_and_bolts_tpu_torch.cli.main import free_port

    tmp = Path(tmp)
    job = "+".join(jobs)
    torch.save(jobs, tmp / f"{job}.payload.pt")
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(job, r, tp, port, str(tmp)), daemon=True)
             for r in range(tp)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(tmp / f"{job}.rank{r}.err").read_text() for r in range(tp)
              if (tmp / f"{job}.rank{r}.err").exists()]
    assert not errors, errors[0]
    assert not hung, f"ranks {hung} of the {job} job hung past {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(tmp / f"{job}.rank{r}.pt", weights_only=False) for r in range(tp)]


def _rank(job: str, rank: int, tp: int, port: int, tmp: str) -> None:
    import torch.distributed as dist

    from llama_nuts_and_bolts_tpu_torch.parallel import initialize_multihost, make_mesh

    torch.set_num_threads(1)
    out = Path(tmp)
    try:
        initialize_multihost(f"127.0.0.1:{port}", tp, rank, backend="gloo")
        jobs = torch.load(out / f"{job}.payload.pt", weights_only=False)
        mesh = make_mesh(tp=tp)
        result = {name: JOBS[name](mesh, payload) for name, payload in jobs.items()}
        torch.save(result, out / f"{job}.rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (out / f"{job}.rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


# ---------------------------------------------------------------- the jobs


def _forward_job(mesh, payload):
    """Each case: this rank's shards of the whole params, then forwards
    (tokens, start_pos, attn_impl) in turn over a shard of a fresh cache;
    the fp32 logits of each."""
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params, tp_size

    results = {}
    for name, case in payload["cases"].items():
        params = shard_params(case["params"], mesh)
        cache = KVCache.create(case["cfg"], case["batch"], case["T"], device="cpu",
                               dtype=case["cache_dtype"], tp=tp_size(mesh))
        logits = []
        for tokens, start_pos, impl in case["steps"]:
            out, cache = forward(params, case["cfg"], tokens, start_pos, cache,
                                 attn_impl=impl, mesh=mesh)
            logits.append(out)
        results[name] = logits
    return results


def _mesh_job(mesh, payload):
    """The mesh's shape and errors, the sharded loader through the mesh's
    sharding_fn, and the engine's refusal of a model tp does not divide."""
    from llama_nuts_and_bolts_tpu_torch.models.llama.loader import (
        build_params_from_checkpoint,
    )
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
    from llama_nuts_and_bolts_tpu_torch.parallel import (
        make_mesh,
        param_sharding_fn,
        tp_rank,
        tp_size,
    )
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    errors = {}
    for name, kw in (("tp3", dict(tp=3)), ("dp2", dict(tp=1, dp=2)),
                     ("sp2", dict(tp=1, sp=2))):
        try:
            make_mesh(**kw)
            errors[name] = None
        except (ValueError, NotImplementedError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    loads = {quant: build_params_from_checkpoint(
        payload["tensors"], payload["cfg"], device="cpu", quant=quant,
        sharding_fn=param_sharding_fn(mesh)) for quant in (None, "int8", "int4")}
    refusals = []
    whole = build_params_from_checkpoint(payload["tensors"], payload["cfg"], device="cpu")
    cache = KVCache.create(payload["cfg"], 1, 16, device="cpu", tp=tp_size(mesh))
    for attempt in (lambda: InferenceEngine(payload["odd_model"],
                                            InferenceArgs(sequence_length=32),
                                            device="cpu", mesh=mesh),
                    lambda: forward(whole, payload["cfg"], torch.zeros((1, 2), dtype=torch.int32),
                                    0, cache, mesh=mesh)):
        try:
            attempt()
            refusals.append(None)
        except ValueError as e:
            refusals.append(str(e))
    return {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
            "rank": tp_rank(mesh), "tp": tp_size(mesh), "errors": errors,
            "loads": loads, "refusal": refusals[0], "whole_params": refusals[1]}


def _engine_job(mesh, payload):
    """Greedy token streams of the engine on this rank's shards, one per
    argument set."""
    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    model = payload["model"]
    model.params = shard_params(model.params, mesh)
    streams = {}
    for name, args in payload["args"].items():
        eng = InferenceEngine(model, InferenceArgs(**args), device="cpu", mesh=mesh)
        streams[name] = [t for _, t in eng.generate_tokens(payload["prompt"])]
    return streams


JOBS = {"forward": _forward_job, "mesh": _mesh_job, "engine": _engine_job}
