"""Tensor parallelism for serving in the PyTorch port, on CPU gloo ranks,
against the JAX package's tensor parallelism on the 8-device CPU mesh of
tests/conftest.py and the port's own single-rank runs.

Three 2-rank spawns, each bundling its checks (a rank that hangs fails its
spawn at the join deadline):

  * ``tests/tp_workers.py`` ranks, importing only the port: the paged
    model functions on a rank's shards of the params and the pool (prefill,
    shared prefill, decode on the gather path and on K6's plain version
    through ``tp_paged_flash_decode``, the speculative verify step) against
    the JAX package's on ``shard_pool`` over a tp 2 mesh; both batchers on
    the cyclic model in lockstep (greedy, seeded sampled and speculating
    requests, admissions while busy, a cancel mid-flight, a pool-starved
    stall) against the port's batcher without a mesh and the JAX package's
    tp batcher, every rank's batcher state equal after every step; and the
    sequential server path, whose next request completes after a client
    goes away mid-stream;
  * ``python -m llama_nuts_and_bolts_tpu_torch.serving --tiny --device cpu
    --tp 2 --continuous 2``, once with ``--paged-blocks`` (ended by SIGTERM:
    both ranks exit 0) and once without (a follower killed: rank 0 exits 1
    within its watch).

One more spawn holds the failure path alone, without a model forward
beyond the first: a follower that raises where rank 0 does not (its
first sequential call) ends rank 0 with code 1.
"""

import dataclasses
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama_nuts_and_bolts_tpu.models.llama import paged as jpaged
from llama_nuts_and_bolts_tpu.parallel import make_mesh as jmake_mesh
from llama_nuts_and_bolts_tpu.parallel import shard_params as jshard_params
from llama_nuts_and_bolts_tpu.parallel import shard_pool as jshard_pool
from llama_nuts_and_bolts_tpu.runtime import InferenceArgs as JInferenceArgs
from llama_nuts_and_bolts_tpu.runtime import InferenceEngine as JInferenceEngine
from llama_nuts_and_bolts_tpu.runtime.continuous import ContinuousBatcher as JContinuous
from llama_nuts_and_bolts_tpu.runtime.paged import PagedBatcher as JPaged

from llama_nuts_and_bolts_tpu_torch.io.params import ModelArgs
from llama_nuts_and_bolts_tpu_torch.models.llama import paged
from llama_nuts_and_bolts_tpu_torch.models.llama.convert import params_from_numpy
from llama_nuts_and_bolts_tpu_torch.parallel.launch import free_port
from llama_nuts_and_bolts_tpu_torch.runtime import InferenceArgs, InferenceEngine
from llama_nuts_and_bolts_tpu_torch.runtime.continuous import ContinuousBatcher
from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher
from llama_nuts_and_bolts_tpu_torch.serving.server import LlamaHTTPServer
from llama_nuts_and_bolts_tpu_torch.utils.testing import compare_tensor
from tests import tp_workers
from tests.test_torch_continuous import one_torch_thread
from tests.test_torch_quant_model import BF16_DRIFT, leaves
from tests.test_torch_speculative import C, CYCLIC_PROMPT, jax_params, models
from tests.test_torch_tp import REL_L2_JAX, REL_L2_SINGLE, SPEC, WIDE, jax_params as tp_params
from tests.test_torch_tp import rel_l2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 8                     # pool blocks of 8 positions
TP = 2
SEQ_LEN = 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


# ----------------------------------------------------- the paged functions

def padded(tokens, n):
    out = np.zeros((1, n), np.int32)
    out[0, :len(tokens)] = tokens
    return out


def paged_calls(vocab, flash):
    """Request A (13 tokens) into blocks [3, 7]; B shares A's first block
    and prefills its 5-token suffix into [5]; two decode steps of both rows
    (K6's plain version with ``flash``, else the gather path); a verify step
    of 3 rows a slot. (name, port kwargs, JAX args) each."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, vocab, 13).astype(np.int32)
    b = np.concatenate([a[:8], rng.integers(0, vocab, 5).astype(np.int32)])
    tables = np.array([[3, 7, 2, 0], [3, 5, 9, 0]], np.int32)
    t = torch.from_numpy
    calls = [("prefill", dict(tokens=t(padded(a, 16)), logits_at=12, table_row=t(tables[0])),
              (jnp.asarray(padded(a, 16)), 12)),
             ("shared", dict(tokens=t(padded(b[8:], 8)), shared_len=8, logits_at=4,
                             table_row=t(tables[1])),
              (jnp.asarray(padded(b[8:], 8)), 8, 4))]
    for step in range(2):
        toks = rng.integers(0, vocab, (2, 1)).astype(np.int32)
        pos = np.array([13 + step, 13 + step], np.int32)
        calls.append(("decode", dict(tokens=t(toks), positions=t(pos), tables=t(tables),
                                     attn_impl="flash" if flash else "plain"),
                      (jnp.asarray(toks), jnp.asarray(pos))))
    toks = rng.integers(0, vocab, (2, 3)).astype(np.int32)
    pos = np.array([15, 15], np.int32)
    calls.append(("spec", dict(tokens=t(toks), positions=t(pos), tables=t(tables)),
                  (jnp.asarray(toks), jnp.asarray(pos))))
    return calls, tables


def paged_case(spec, quant=None, pool="bf16", flash=False):
    """The port's payload of one case, the JAX package's logits of the same
    calls on ``shard_params`` and ``shard_pool`` over a tp 2 mesh, and the
    port's unsharded logits."""
    jcfg, jp = tp_params(spec, quant)
    cfg = ModelArgs(**spec)
    params = params_from_numpy(leaves(jp), "cpu")
    mesh = jmake_mesh(tp=TP)
    int8 = pool == "int8"
    n_blocks = 12
    jpool = jshard_pool(jpaged.PagedKVPool.create(jcfg, n_blocks, BS, dtype=jnp.int8 if int8
                                                  else jnp.bfloat16), mesh)
    jsharded = jshard_params(jp, mesh)
    calls, tables = paged_calls(spec["vocab_size"], flash)
    jfns = {"prefill": jpaged.paged_prefill, "shared": jpaged.paged_prefill_shared,
            "decode": jpaged.paged_decode_step, "spec": jpaged.paged_decode_step_spec}
    want = []
    for i, (name, _, jargs) in enumerate(calls):
        table = jnp.asarray(tables[i] if name in ("prefill", "shared") else tables)
        extra = ("xla",) if name == "decode" else ()
        fn = jax.jit(jfns[name], static_argnums=(1, 6) if extra else (1,))
        out, jpool = fn(jsharded, jcfg, *jargs, jpool, table, *extra)
        want.append(np.asarray(out))
    dtype = torch.int8 if int8 else torch.bfloat16
    pool_ = paged.PagedKVPool.create(cfg, n_blocks, BS, dtype, device="cpu")
    fns = {"prefill": paged.paged_prefill, "shared": paged.paged_prefill_shared,
           "decode": paged.paged_decode_step, "spec": paged.paged_decode_step_spec}
    single = [fns[name](params, cfg, pool=pool_, **kw)[0] for name, kw, _ in calls]
    payload = {"params": params, "cfg": cfg, "n_blocks": n_blocks, "bs": BS, "dtype": dtype,
               "calls": [(name, kw) for name, kw, _ in calls]}
    return payload, want, single


PAGED_CASES = {"bf16": dict(spec=SPEC), "int4_kv8": dict(spec=SPEC, quant="int4", pool="int8"),
               "flash": dict(spec=WIDE, flash=True)}


# --------------------------------------------------------------- batchers

def batcher_cases():
    """Each case: the batcher, its engine args and rank 0's script."""
    sampled = dict(max_new_tokens=9, temperature=0.9, top_k=5, seed=11)
    busy = [("submit", [1, 2, 3], {}), ("submit", [4, 5, 6, 0], sampled), ("step", 3),
            ("submit", [2] * 9, dict(max_new_tokens=12)), ("step", 2), ("cancel", 0),
            ("submit", [6, 0, 1], dict(max_new_tokens=6)), ("idle",)]
    # 5 usable blocks of 8 for 3 slots: two 12-token prompts take 2 each, so
    # the third waits in the stalled queue until blocks come back
    stall = [("submit", [0, 1, 2, 3, 4, 5, 6, 0, 1, 2, 3, 4], dict(max_new_tokens=10)),
             ("submit", [3] * 12, dict(max_new_tokens=10)), ("step", 2),
             ("submit", [5] * 12, dict(max_new_tokens=6)), ("step", 4), ("cancel", 1),
             ("idle",)]
    spec = [("submit", CYCLIC_PROMPT, dict(max_new_tokens=14)), ("step", 1),
            ("submit", CYCLIC_PROMPT[2:], dict(max_new_tokens=10)),
            ("submit", [1, 2], sampled), ("idle",)]
    args = dict(sequence_length=SEQ_LEN)
    return {
        "dense": dict(kind="dense", args=args, batcher=dict(n_slots=2), script=busy),
        "paged": dict(kind="paged", args=args,
                      batcher=dict(n_slots=2, block_size=BS), script=busy),
        "paged_stall": dict(kind="paged", args=args,
                            batcher=dict(n_slots=3, block_size=BS, n_blocks=6), script=stall),
        "dense_spec": dict(kind="dense", args=args, batcher=dict(n_slots=2, speculate_k=3),
                           script=spec),
        "paged_spec": dict(kind="paged", args=args,
                           batcher=dict(n_slots=2, block_size=BS, speculate_k=3),
                           script=spec),
    }


def reference_streams(case, model, jmodel_):
    """The case's streams from the port's batcher without a mesh and from
    the JAX package's batcher on a tp 2 mesh (the latter None where a
    request was cancelled: the packages pipeline their steps apart)."""
    eng = InferenceEngine(model, InferenceArgs(**case["args"]), device="cpu")
    make = PagedBatcher if case["kind"] == "paged" else ContinuousBatcher
    tp1 = tp_workers.run_script(make(eng, **case["batcher"]), case["script"])
    mesh = jmake_mesh(tp=TP)
    jeng = JInferenceEngine(dataclasses.replace(jmodel_, params=jshard_params(
        jmodel_.params, mesh)), JInferenceArgs(decode_chunk=1, **case["args"]), mesh=mesh)
    kw = dict(case["batcher"], step_quantum=1)
    jb = (JPaged(jeng, attn_impl="xla", **kw) if case["kind"] == "paged"
          else JContinuous(jeng, **kw))
    jax_streams = tp_workers.run_script(jb, case["script"])
    cancelled = {a[1] for a in case["script"] if a[0] == "cancel"}
    return tp1, [None if i in cancelled else s for i, s in enumerate(jax_streams)]


# ------------------------------------------------------ the sequential path

SEQ_STREAM = {"prompt": "hello", "max_tokens": 24}
SEQ_BLOCK = {"prompt": "again", "max_tokens": 8}


# ----------------------------------------------------------- the one spawn

@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """The one tp_workers spawn of this module, and what it is held to."""
    paged_payload, paged_want, paged_single = {}, {}, {}
    for name, kw in PAGED_CASES.items():
        paged_payload[name], paged_want[name], paged_single[name] = paged_case(**kw)
    jmodel_, model = models(jax_params(step=1))
    cases = batcher_cases()
    refs = {name: reference_streams(case, model, jmodel_) for name, case in cases.items()}
    srv = LlamaHTTPServer(InferenceEngine(model, InferenceArgs(sequence_length=SEQ_LEN),
                                          device="cpu"), model_name="tiny-test")
    seq_want = srv.generate_block(srv._tokens_for_completion(SEQ_BLOCK["prompt"]),
                                  SEQ_BLOCK["max_tokens"])
    results = tp_workers.spawn(
        {"paged": paged_payload, "batchers": {"model": model, "cases": cases},
         "seq_server": {"model": model, "args": dict(sequence_length=SEQ_LEN),
                        "stream": SEQ_STREAM, "block": SEQ_BLOCK}},
        TP, tmp_path_factory.mktemp("tp_serving"))
    return dict(results=results, paged=(paged_want, paged_single), batchers=(cases, refs),
                seq_want=seq_want)


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_tp2_paged_functions_match_jax_tp(spawn, case):
    """Every rank's logits equal, bit for bit; within the bf16 drift bar of
    tests/test_torch_model.py and ``REL_L2_JAX`` of the JAX package's paged
    functions on a tp 2 mesh (the flash case's K6 against JAX's gather: the
    span's summation order), and within ``REL_L2_SINGLE`` of the port's
    unsharded functions (readings as in tests/test_torch_tp.py)."""
    want, single = (d[case] for d in spawn["paged"])
    ranks = [r["paged"][case] for r in spawn["results"]]
    for r in range(1, TP):
        assert all(torch.equal(a, b) for a, b in zip(ranks[0], ranks[r])), r
    for step, (got, jl, sl) in enumerate(zip(ranks[0], want, single)):
        assert got.dtype == torch.float32 and tuple(got.shape) == jl.shape, step
        compare_tensor(got.numpy(), jl, "bfloat16", tolerance_multiplier=BF16_DRIFT)
        assert rel_l2(got.numpy(), jl) < REL_L2_JAX, (case, step)
        assert rel_l2(got.numpy(), sl.numpy()) < REL_L2_SINGLE, (case, step)


@pytest.mark.parametrize("case", list(batcher_cases()))
def test_tp2_batchers_in_lockstep(spawn, case):
    """Rank 0's streams equal the port's batcher without a mesh (sampled and
    cancelled requests included) and, greedy and not cancelled, the JAX
    package's tp batcher; the greedy cyclic streams walk the cycle. Every
    rank's batcher state (slots, positions, feeds, pending and live
    requests, step counts, speculation counters, and paged:
    tables, blocks, the stalled queue, the allocator's free count, stats
    and refcounts) equals rank 0's after every step."""
    cases, refs = spawn["batchers"]
    tp1, jax_streams = refs[case]
    ranks = [r["batchers"][case] for r in spawn["results"]]
    streams = ranks[0]["streams"]
    assert streams == tp1
    for (action, stream, jstream) in zip([a for a in cases[case]["script"]
                                          if a[0] == "submit"], streams, jax_streams):
        if jstream is None:
            # cancelled (or ended by the dry pool first): short of its cap
            cap = action[2].get("max_new_tokens", SEQ_LEN - len(action[1]))
            assert len(stream) < cap
            continue
        assert stream[-1][0] != "IN_PROGRESS"
        if not action[2].get("temperature"):
            assert stream == jstream
            toks = [t for _, t in stream]
            assert all(t == (p + 1) % C for p, t in zip([action[1][-1]] + toks, toks))
    snaps = ranks[0]["snapshots"]
    assert len(snaps) > 3
    for r in range(1, TP):
        assert ranks[r]["snapshots"] == snaps, r
    if case == "paged_stall":
        assert any(s["stalled"] for s in snaps), "the schedule never stalled"
        assert snaps[-1]["available"] == 5


def test_tp2_sequential_server_survives_a_disconnect(spawn):
    """The sequential server path at tp 2: a streamed request whose client
    leaves after its first chunk is run to its end by rank 0 (the followers
    are in its collectives), so the next request completes on every rank,
    with the answer of the unsharded server; /metrics counts both."""
    res = spawn["results"][0]["seq_server"]
    assert res["first"].startswith(b"data: ")
    status, body = res["block"]
    text, finish, n = spawn["seq_want"]
    assert status == 200 and body["choices"][0]["text"] == text
    assert body["usage"]["completion_tokens"] == n
    assert "llama_requests_total 2" in res["metrics"]


# ------------------------------------------------------- the CLI's --tp 2

def start_cli(*flags):
    port = free_port()
    cmd = [sys.executable, "-m", "llama_nuts_and_bolts_tpu_torch.serving", "--tiny",
           "--device", "cpu", "--tp", "2", "--seq-len", "96", "--port", str(port),
           "--continuous", "2", *flags]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    deadline = time.time() + 120
    while time.time() < deadline:
        assert proc.poll() is None, proc.communicate()[1][-3000:]
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
            conn.request("GET", "/health")
            if conn.getresponse().status == 200:
                return proc, port
        except OSError:
            time.sleep(0.25)
    proc.kill()
    raise AssertionError("the tp 2 server did not come up in 120 s")


def request(port, body, path="/v1/chat/completions"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, json.dumps(body))
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def drive(port):
    """Three concurrent chats, a streamed one whose client leaves after its
    first chunk, then one more, and /metrics."""
    out = {}

    def chat(i):
        out[i] = request(port, {"messages": [{"role": "user", "content": f"hi {i}"}],
                                "max_tokens": 8})

    threads = [threading.Thread(target=chat, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/chat/completions", json.dumps(
        {"messages": [{"role": "user", "content": "tell"}], "max_tokens": 40,
         "stream": True}))
    first = conn.getresponse().read1(64)
    conn.sock.close()
    conn.close()
    after = request(port, {"messages": [{"role": "user", "content": "again"}],
                           "max_tokens": 8})
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/metrics")
    return out, first, after, conn.getresponse().read().decode()


def check_drive(out, first, after, metrics):
    assert sorted(out) == [0, 1, 2]
    for status, body in list(out.values()) + [after]:
        assert status == 200 and body["usage"]["completion_tokens"] == 8
    assert first.startswith(b"data: ")
    assert "llama_requests_total 5" in metrics
    assert "llama_batch_slots 2" in metrics
    return metrics


def follower_pid(proc) -> int:
    kids = open(f"/proc/{proc.pid}/task/{proc.pid}/children").read().split()
    return next(int(k) for k in kids if b"spawn_main" in open(f"/proc/{k}/cmdline", "rb").read())


def test_tp2_server_cli_paged_serves_and_exits_cleanly():
    """``--tp 2 --continuous 2 --paged-blocks 40``: the HTTP drive, then
    SIGTERM to rank 0 ends both ranks with code 0 (rank 0 returns nonzero
    when a follower fails)."""
    proc, port = start_cli("--paged-blocks", "40")
    try:
        assert "llama_kv_blocks_total 39" in check_drive(*drive(port))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, proc.stderr.read()[-3000:]


def test_tp2_server_cli_dense_ends_when_a_follower_dies():
    """``--tp 2 --continuous 2``: the HTTP drive, then a follower killed:
    rank 0 stops and exits 1 within a few seconds, never waiting in a
    collective the dead rank will not join."""
    proc, port = start_cli()
    try:
        check_drive(*drive(port))
        os.kill(follower_pid(proc), signal.SIGKILL)
        t0 = time.time()
        rc = proc.wait(30)
        took = time.time() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 1 and took < 10, (rc, took)
    assert "rank(s) [1] exited with [-9]" in proc.stderr.read()


def test_tp2_follower_only_failure_ends_rank0():
    """The server's ``--tp 2`` on the sequential path, with a failure
    planted on the follower alone (``tp_workers.planted_follower_failure``:
    its first engine call, rank 0's prewarm, raises a RuntimeError). The
    follower does not skip it and wait for the next call: it exits 1, and
    rank 0, already in the prewarm's collectives, ends with code 1 within
    its watch instead of waiting in them."""
    argv = ["--tiny", "--device", "cpu", "--tp", "2", "--seq-len", "96",
            "--port", str(free_port())]
    code = ("import sys; from tests import tp_workers; "
            "from llama_nuts_and_bolts_tpu_torch.parallel.launch import launch; "
            f"sys.exit(launch(tp_workers.planted_follower_failure, {argv!r}, 2, 'cpu'))")
    t0 = time.time()
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 1, (run.returncode, run.stderr[-3000:])
    assert "planted follower-only failure" in run.stderr
    assert "tensor-parallel rank 1 failed" in run.stderr
    assert time.time() - t0 < 60, run.stderr[-3000:]
