"""Ranks of a multi-rank CPU run for ``tests/test_torch_tp.py``,
``tests/test_torch_tp_serving.py``, ``tests/test_torch_ring.py``,
``tests/test_torch_tp_dp.py`` and ``tests/test_torch_multiprocess.py``.

:func:`spawn` starts ``tp`` processes that meet over gloo at a file of
the test's directory, build the port's mesh and run jobs of :data:`JOBS`, each on
a payload the test saved with ``torch.save``; each rank saves its results,
and the test compares them. A job runs on ``make_mesh(tp=world)`` unless its
payload names another mesh of the same ranks (``"mesh": {"dp": 2, ...}``).
The ranks import the port and never JAX (this module imports nothing of the
tests that do). Each rank runs on one thread, and a rank that hangs is
killed at the join deadline, so a fault fails the test instead of holding
the run. :func:`multihost_main` is one process of the multi-host test,
started on its own (``python -c``), not by :func:`spawn`.
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


def job_mesh(mesh, payload):
    """The mesh a job's payload names, else the spawn's."""
    from llama_nuts_and_bolts_tpu_torch.parallel import make_mesh

    return make_mesh(**payload["mesh"]) if "mesh" in payload else mesh


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
    """The meshes' shapes and errors, the sharded loader through the mesh's
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
            m = make_mesh(**kw)
            errors[name] = (tuple(m.shape), m.mesh_dim_names)
        except ValueError as e:
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
    argument set (or the ``ValueError`` that refused it)."""
    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine

    mesh = job_mesh(mesh, payload)
    model = dataclasses.replace(payload["model"],
                                params=shard_params(payload["model"].params, mesh))
    streams = {}
    for name, args in payload["args"].items():
        eng = InferenceEngine(model, InferenceArgs(**args), device="cpu", mesh=mesh)
        try:
            streams[name] = [t for _, t in eng.generate_tokens(payload["prompt"])]
        except ValueError as e:
            streams[name] = f"ValueError: {e}"
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
    the group's rank 0 runs the case's script (``run_script``) and stops,
    the others follow. Every rank
    records its batcher's snapshot after each step; rank 0 also returns its
    requests' streams."""
    import torch.distributed as dist

    from llama_nuts_and_bolts_tpu_torch.parallel import shard_params
    from llama_nuts_and_bolts_tpu_torch.parallel.launch import new_control_group
    from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
    from llama_nuts_and_bolts_tpu_torch.runtime.continuous import ContinuousBatcher
    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher

    mesh = job_mesh(mesh, payload)
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
        if dist.get_rank() != 0:
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


def cuda_batcher_rank(rank: int, world: int, port: int, tmp: str,
                      device: str = "cuda") -> None:
    """One NCCL rank of ``test_torch_gpu.py``'s tp batcher test, on card
    ``rank`` (a gloo rank with ``device="cpu"``, a rehearsal): a paged
    batcher over this rank's shards of the cyclic tiny model with two KV
    heads; rank 0 runs ``TP_SCRIPT`` and stops, the others follow. Saves
    rank 0's streams and every rank's step counts to ``rank<r>.pt``, or
    the failure to ``rank<r>.err``."""
    from llama_nuts_and_bolts_tpu_torch.parallel.launch import rank_group
    from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher
    from tests.test_torch_gpu import CYCLE, TP_SCRIPT, tiny_engine

    out = Path(tmp)
    try:
        with rank_group(rank, world, port, device) as (dev, mesh, control):
            b = PagedBatcher(tiny_engine(dev, fused=False, mesh=mesh, cycle=CYCLE, kv_heads=2),
                             n_slots=2, control=control)
            streams = None
            if rank == 0:
                streams = run_script(b, TP_SCRIPT)
                b.stop()
            else:
                b.follow()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            torch.save({"streams": streams, "decode_steps": b.decode_steps,
                        "graph_steps": b.graph_steps,
                        "warmup_steps": b._step_graph.warmup_steps},
                       out / f"rank{rank}.pt")
            del b
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


TP_PREFILL, TP_SHARED = 200, 128    # real rows of the 256-row bucket; the hit's prefix


def tp_prefill_case(device):
    """``test_torch_gpu.py``'s tp prefill case: a 2-layer model at the
    kernels' shape with two KV heads (8 / 2 heads, head_dim 128, random
    bf16 weights, split layout), a 256-row bucket of 200 real rows, a 64-row
    suffix bucket that hits the prompt's first 128 rows, and the table row
    of both: ``(cfg, params, prompt, suffix, table)``."""
    from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import init_random_params

    cfg = ModelArgs(dim=1024, n_layers=2, n_heads=8, n_kv_heads=2, vocab_size=512,
                    multiple_of=32, norm_eps=1e-5, max_sequence_length=512)
    gen = torch.Generator(device="cpu").manual_seed(256)
    prompt = torch.zeros((1, 256), dtype=torch.int32)
    prompt[0, :TP_PREFILL] = torch.randint(0, 512, (TP_PREFILL,), generator=gen)
    suffix = torch.randint(0, 512, (1, 64), generator=gen, dtype=torch.int32)
    table = torch.arange(1, 17, dtype=torch.int32)
    return (cfg, init_random_params(cfg, seed=0, device=device), prompt.to(device),
            suffix.to(device), table.to(device))


def tp_prefills(params, cfg, pool, prompt, suffix, table, mesh=None, attn_impl="plain"):
    """The tp prefill case's two calls in turn: ``paged_prefill`` of the
    prompt, then ``paged_prefill_shared`` of the suffix after its first
    ``TP_SHARED`` rows; their logits rows."""
    from llama_nuts_and_bolts_tpu_torch.models.llama import paged

    kw = dict(mesh=mesh, attn_impl=attn_impl)
    return [paged.paged_prefill(params, cfg, prompt, TP_PREFILL - 1, pool, table, **kw)[0],
            paged.paged_prefill_shared(params, cfg, suffix, TP_SHARED, suffix.shape[1] - 4,
                                       pool, table, **kw)[0]]


def cuda_shared_prefill_rank(rank: int, world: int, port: int, tmp: str) -> None:
    """One gloo rank of ``test_torch_gpu.py``'s tp prefill test, on card 0
    beside the others (no engine: it refuses gloo on a card): this rank's
    shards of :func:`tp_prefill_case`'s model and of a pool, its two calls
    on K1. Saves the logits rows and K1's launches to ``rank<r>.pt``, or
    the failure to ``rank<r>.err``."""
    from llama_nuts_and_bolts_tpu_torch.kernels.attention import flash_gqa_attention
    from llama_nuts_and_bolts_tpu_torch.models.llama import paged
    from llama_nuts_and_bolts_tpu_torch.parallel import (
        initialize_multihost,
        make_mesh,
        shard_params,
        shard_pool,
    )
    from llama_nuts_and_bolts_tpu_torch.parallel.launch import leave_group

    out = Path(tmp)
    try:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
        try:
            mesh = make_mesh(tp=world)
            cfg, params, prompt, suffix, table = tp_prefill_case(device)
            pool = shard_pool(paged.PagedKVPool.create(cfg, 17, 32, device=device), mesh)
            before = flash_gqa_attention.launches
            logits = tp_prefills(shard_params(params, mesh), cfg, pool, prompt, suffix, table,
                                 mesh=mesh, attn_impl="flash")
            torch.cuda.synchronize()
            torch.save({"logits": [x.cpu() for x in logits],
                        "launches": flash_gqa_attention.launches - before},
                       out / f"rank{rank}.pt")
        finally:
            leave_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


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


Q_SPEC = ("dp", "sp", "tp", None)       # ring attention's q [B, S, H, D]
KV_SPEC = ("dp", "tp", "sp", None)      # and k/v [B, KV, S, D]


def _ring_job(_mesh, payload):
    """Each case on its own mesh: this rank's block of q, k and each v of
    ``vs``, and ``ring_gqa_attention`` over them; the rank's coordinates and
    out blocks."""
    from llama_nuts_and_bolts_tpu_torch.parallel import make_mesh
    from llama_nuts_and_bolts_tpu_torch.parallel.ring_attention import ring_gqa_attention
    from llama_nuts_and_bolts_tpu_torch.parallel.sharding import cut_block, mesh_coords

    results = {}
    for name, case in payload.items():
        mesh = make_mesh(**case["mesh"])
        co = mesh_coords(mesh)
        q, k = (cut_block(t, spec, co).contiguous()
                for t, spec in ((case["q"], Q_SPEC), (case["k"], KV_SPEC)))
        results[name] = {"coords": co, "out": [
            ring_gqa_attention(mesh, q, k, cut_block(v, KV_SPEC, co).contiguous(),
                               case["start_pos"]) for v in case["vs"]]}
    return results


def _mesh_forward_job(_mesh, payload):
    """Each case on its own mesh: this rank's shards of the whole params and
    of the case's cache (a fresh one, or ``cache``), then forwards ``(tokens,
    start_pos, attn_impl, seq_parallel, logits_at)`` in turn on the rank's
    block of the whole tokens (and of a ``[B]`` start_pos); the rank's
    coordinates, the logits of each step and the cache after."""
    from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
    from llama_nuts_and_bolts_tpu_torch.parallel import make_mesh, shard_cache, shard_params
    from llama_nuts_and_bolts_tpu_torch.parallel.sharding import mesh_coords, shard_tokens

    results = {}
    for name, case in payload.items():
        mesh = make_mesh(**case["mesh"])
        params = shard_params(case["params"], mesh)
        whole = case.get("cache") or KVCache.create(case["cfg"], case["batch"], case["T"],
                                                    device="cpu", dtype=case["cache_dtype"])
        cache = shard_cache(whole, mesh)
        logits = []
        for tokens, start_pos, impl, seq_parallel, logits_at in case["steps"]:
            if isinstance(start_pos, torch.Tensor):
                start_pos = shard_tokens(start_pos, mesh)
            out, cache = forward(params, case["cfg"], shard_tokens(tokens, mesh, seq_parallel),
                                 start_pos, cache, attn_impl=impl, logits_at=logits_at,
                                 mesh=mesh, seq_parallel=seq_parallel)
            logits.append(out)
        results[name] = {"coords": mesh_coords(mesh), "logits": logits, "cache": cache}
    return results


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


def multihost_main() -> None:
    """One process of ``tests/test_torch_multiprocess.py``, launched on its
    own like one process of a host: ``LNB_COORD`` (the coordinator's
    ``host:port``), ``LNB_PROC`` (its process id), ``LNB_NPROC``, ``LNB_HOST``
    (the "host" it stands for), ``LNB_PAYLOAD`` and ``LNB_OUT``. It meets the
    others through ``initialize_multihost``, builds a ``(dp 2, tp 2)`` mesh,
    and for each model of the payload prefills its row of the batch and
    takes one greedy decode step; it writes its mesh coordinates, every
    row's tokens (gathered over dp) and its rows' logits. A process still
    running after ``LNB_LIMIT_S`` dumps its stacks and exits."""
    import faulthandler
    import sys

    import torch.distributed as dist

    from llama_nuts_and_bolts_tpu_torch.models.llama.model import KVCache, forward
    from llama_nuts_and_bolts_tpu_torch.parallel import (
        initialize_multihost,
        make_mesh,
        shard_params,
    )
    from llama_nuts_and_bolts_tpu_torch.parallel.mesh import gather_rows
    from llama_nuts_and_bolts_tpu_torch.parallel.sharding import mesh_coords, shard_tokens

    faulthandler.dump_traceback_later(float(os.environ["LNB_LIMIT_S"]), exit=True)
    torch.set_num_threads(1)
    pid = int(os.environ["LNB_PROC"])
    initialize_multihost(os.environ["LNB_COORD"], int(os.environ["LNB_NPROC"]), pid)
    assert dist.get_backend() == "gloo" and dist.get_rank() == pid
    mesh = make_mesh(tp=2, dp=2)
    payload = torch.load(os.environ["LNB_PAYLOAD"], weights_only=False)
    out = {"proc": pid, "host": int(os.environ["LNB_HOST"]), "coords": mesh_coords(mesh)}
    for name, case in payload["models"].items():
        cfg, prompts = case["cfg"], payload["prompts"]
        params = shard_params(case["params"], mesh)
        tokens = shard_tokens(prompts, mesh)
        cache = KVCache.create(cfg, tokens.shape[0], payload["T"], device="cpu", tp=2)
        logits, cache = forward(params, cfg, tokens, 0, cache, mesh=mesh)
        first = logits[:, -1].argmax(-1).to(torch.int32)
        logits2, cache = forward(params, cfg, first[:, None], prompts.shape[1], cache,
                                 mesh=mesh)
        second = logits2[:, -1].argmax(-1).to(torch.int32)
        out[name] = {"tokens": gather_rows(torch.stack([first, second], 1), mesh).tolist(),
                     "logits": [logits, logits2]}
    torch.save(out, os.environ["LNB_OUT"])
    dist.barrier()
    dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    sys.stdout.write(f"proc {pid}: done\n")


JOBS = {"forward": _forward_job, "mesh": _mesh_job, "engine": _engine_job,
        "paged": _paged_job, "batchers": _batchers_job, "seq_server": _seq_server_job,
        "ring": _ring_job, "mesh_forward": _mesh_forward_job}
