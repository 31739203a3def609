"""Ranks of a tensor-parallel CPU run for ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_serving.py``.

:func:`spawn` starts ``tp`` processes that meet over gloo at a file of
the test's directory, build the port's mesh and run jobs of :data:`JOBS`, each on
a payload the test saved with ``torch.save``; each rank saves its results,
and the test compares them. The ranks import the port and never JAX (this
module imports nothing of the tests that do). Each rank runs on one thread,
and a rank that hangs is killed at the join deadline, so a fault fails the
test instead of holding the run.
"""

from __future__ import annotations

import dataclasses
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

    tmp = Path(tmp)
    job = "+".join(jobs)
    torch.save(jobs, tmp / f"{job}.payload.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(job, r, tp, str(tmp)), daemon=True)
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


def _rank(job: str, rank: int, tp: int, tmp: str) -> None:
    import torch.distributed as dist

    from llama_nuts_and_bolts_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    out = Path(tmp)
    try:
        # the ranks meet at a file of the test's own directory: no TCP port
        # that a concurrent test could take between its choice and its bind
        dist.init_process_group("gloo", init_method=f"file://{out / (job + '.rdzv')}",
                                world_size=tp, rank=rank)
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


def _paged_job(mesh, payload):
    """Each case: this rank's shards of the whole params and of a fresh
    pool, then the paged functions in turn -- ``(name, kwargs)`` with
    ``name`` one of prefill, shared, decode, spec; the fp32 logits of each."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import paged
    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params, shard_pool

    fns = {"prefill": paged.paged_prefill, "shared": paged.paged_prefill_shared,
           "decode": paged.paged_decode_step, "spec": paged.paged_decode_step_spec}
    results = {}
    for name, case in payload.items():
        params = shard_params(case["params"], mesh)
        pool = shard_pool(paged.PagedKVPool.create(case["cfg"], case["n_blocks"], case["bs"],
                                                   case["dtype"], device="cpu"), mesh)
        results[name] = [fns[fn](params, case["cfg"], pool=pool, mesh=mesh, **kw)[0]
                         for fn, kw in case["calls"]]
    return results


def batcher_snapshot(b) -> Dict[str, Any]:
    """The state a batcher's next step reads, by request id: it must be the
    same on every rank after every step."""
    snap = {"slots": [None if r is None else r.rid for r in b.slots],
            "pos": b._pos.tolist(), "feed": b._feed.tolist(), "pending": b.pending.qsize(),
            "live": sorted(b._live),
            "steps": (b.decode_steps, b.verify_steps), "spec": dict(b.spec_stats)}
    if hasattr(b, "allocator"):
        a = b.allocator
        snap.update(tables=b.tables.tolist(), blocks=[list(x) for x in b._slot_blocks],
                    stalled=[r.rid for r in b._stalled], available=a.available,
                    stats=dict(a.stats),
                    refs=[a.refcount(i) for i in range(a.n_blocks)])
    return snap


def _batchers_job(mesh, payload):
    """Each case: an engine on this rank's shards and a batcher over them;
    rank 0 runs the case's script (``run_script``) and stops, the others
    follow. Every rank
    records its batcher's snapshot after each step; rank 0 also returns its
    requests' streams."""
    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params, tp_rank
    from llama_nuts_and_bolts_tpu_torch.parallel.launch import new_control_group
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.runtime.continuous import ContinuousBatcher
    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher

    model = dataclasses.replace(payload["model"],
                                params=shard_params(payload["model"].params, mesh))
    results = {}
    for name, case in payload["cases"].items():
        eng = InferenceEngine(model, InferenceArgs(**case["args"]), device="cpu", mesh=mesh)
        make = PagedBatcher if case["kind"] == "paged" else ContinuousBatcher
        b = make(eng, **case["batcher"], control=new_control_group())
        snaps = []
        step_once = b._step_once

        def recorded(step_once=step_once, b=b, snaps=snaps):
            step_once()
            snaps.append(batcher_snapshot(b))

        b._step_once = recorded
        if tp_rank(mesh) != 0:
            b.follow()
            results[name] = {"snapshots": snaps}
            continue
        streams = run_script(b, case["script"])
        b.stop()
        results[name] = {"snapshots": snaps, "streams": streams}
    return results


def run_script(b, script) -> List[list]:
    """A batcher schedule -- ("submit", prompt, kwargs), ("step", n),
    ("cancel", i), ("idle",) -- on rank 0 (or without a mesh): the
    requests' streams of (state name, token)."""
    reqs = []
    for action in script:
        if action[0] == "submit":
            reqs.append(b.submit(action[1], **action[2]))
        elif action[0] == "step":
            for _ in range(action[1]):
                b.step()
        elif action[0] == "cancel":
            reqs[action[1]].cancel()
        else:
            b.run_until_idle()
    return [[(st.name, t) for st, t in r.tokens(timeout=30)] for r in reqs]


def _seq_server_job(mesh, payload):
    """The sequential server path on this rank's shards: rank 0 serves over
    HTTP on an ephemeral port -- a streamed request whose client goes away
    after its first chunk, then a blocking one -- and shuts down; the
    others follow. Rank 0 returns the blocking answer and /metrics' counts."""
    import http.client
    import json

    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params, tp_rank
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.serving.server import LlamaHTTPServer

    model = dataclasses.replace(payload["model"],
                                params=shard_params(payload["model"].params, mesh))
    eng = InferenceEngine(model, InferenceArgs(**payload["args"]), device="cpu", mesh=mesh)
    srv = LlamaHTTPServer(eng, model_name="tiny-test")
    if tp_rank(mesh) != 0:
        srv.follow()
        return {}
    srv.prewarm()
    port = srv.start_background()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/completions", json.dumps(dict(payload["stream"],
                                                                stream=True)))
        first = conn.getresponse().read1(64)
        conn.sock.close()
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/completions", json.dumps(payload["block"]))
        resp = conn.getresponse()
        block = (resp.status, json.loads(resp.read()))
        conn.request("GET", "/metrics")
        metrics = conn.getresponse().read().decode()
    finally:
        srv.shutdown()
    return {"first": first, "block": block, "metrics": metrics}


def planted_follower_failure(argv, rank: int, port: int) -> int:
    """One rank of the server's ``--tp`` (``serving/__main__.py``) whose
    follower fails where rank 0 does not: its first sequential engine call,
    rank 0's prewarm, raises a ``RuntimeError``, while rank 0 runs the same
    call into collectives the follower will never join. For
    ``parallel.launch.launch``: rank 0 must end with code 1."""
    from llama_nuts_and_bolts_tpu_torch.runtime import device_loop
    from llama_nuts_and_bolts_tpu_torch.serving.__main__ import _run_rank

    if rank != 0:
        def planted(*_args):
            raise RuntimeError("planted follower-only failure")

        device_loop.generate_block = planted
    return _run_rank(argv, rank, port)


JOBS = {"forward": _forward_job, "mesh": _mesh_job, "engine": _engine_job,
        "paged": _paged_job, "batchers": _batchers_job, "seq_server": _seq_server_job}
