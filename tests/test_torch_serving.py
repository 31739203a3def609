"""HTTP serving of the PyTorch port: a live tiny server on the CPU over the
paged batcher (health, models, chat streamed against blocking, completions
with logprobs, seeded sampling, /metrics with the prefix cache, the 429
admission bound), the serialized server, the non-streaming greedy loop, the
stop-sequence filter against the JAX package's, ``--tp`` without cards,
the batchers on a one-rank mesh, and how a failure under a mesh ends the
ranks (a follower skips only the engine's refusals; rank 0's failed
batcher thread ends its process)."""

import dataclasses
import json
import time
import urllib.error
import urllib.request

import pytest
import torch
import torch.distributed as dist

from llama_nuts_and_bolts_tpu.serving.server import (
    apply_stop_sequences as jax_apply_stop_sequences,
)

from llama_nuts_and_bolts_tpu_torch.parallel import initialize_multihost, make_mesh, shard_params
from llama_nuts_and_bolts_tpu_torch.parallel import launch
from llama_nuts_and_bolts_tpu_torch.parallel.launch import free_port, new_control_group
from llama_nuts_and_bolts_tpu_torch.runtime.continuous import ContinuousBatcher
from llama_nuts_and_bolts_tpu_torch.runtime import device_loop
from llama_nuts_and_bolts_tpu_torch.runtime.device_loop import generate_block
from llama_nuts_and_bolts_tpu_torch.runtime.paged import PagedBatcher
from llama_nuts_and_bolts_tpu_torch.serving import __main__ as cli
from llama_nuts_and_bolts_tpu_torch.serving import server as server_mod
from llama_nuts_and_bolts_tpu_torch.serving.server import LlamaHTTPServer, apply_stop_sequences
from tests.test_torch_continuous import make_engine, one_torch_thread

SYSTEM = "You answer in the voice of a ship's log."   # > one 32-token block


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def start(**kw):
    srv = LlamaHTTPServer(make_engine(seq_len=160), model_name="tiny-test", **kw)
    srv.prewarm()
    return srv, f"http://127.0.0.1:{srv.start_background()}"


@pytest.fixture(scope="module")
def paged_server():
    srv, url = start(continuous_slots=2, paged_blocks=12)
    yield srv, url
    srv.shutdown()


def post(url, obj, raw=False):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = resp.read()
        return resp.status, (body.decode() if raw else json.loads(body))


def get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read().decode()


def metric(text, name):
    return float(next(line.split()[1] for line in text.splitlines()
                      if line.startswith(name + " ")))


def chat(content, **kw):
    return {"messages": [{"role": "system", "content": SYSTEM},
                         {"role": "user", "content": content}], "max_tokens": 12, **kw}


def test_health_and_models(paged_server):
    _, url = paged_server
    health = json.loads(get(url + "/health"))
    assert health["status"] == "ok" and health["model"] == "tiny-test"
    assert health["continuous"]["slots"] == 2
    assert health["continuous"]["paged"]["blocks_total"] == 11
    assert json.loads(get(url + "/v1/models"))["data"][0]["id"] == "tiny-test"


def test_stream_equals_blocking_and_is_counted_before_done(paged_server):
    _, url = paged_server
    before = metric(get(url + "/metrics"), "llama_requests_total")
    status, body = post(url + "/v1/chat/completions", chat("status report"))
    assert status == 200 and body["usage"]["completion_tokens"] == 12
    blocking = body["choices"][0]["message"]["content"]
    status, raw = post(url + "/v1/chat/completions", chat("status report", stream=True),
                       raw=True)
    # read right after [DONE]: the stream is already in /metrics
    after = metric(get(url + "/metrics"), "llama_requests_total")
    events = [line[6:] for line in raw.split("\n") if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert "".join(c["choices"][0]["delta"]["content"] for c in chunks) == blocking
    assert after == before + 2
    assert metric(get(url + "/metrics"), "llama_batch_decode_steps_total") >= 11


def test_prefix_cache_hits_on_a_shared_system_prompt(paged_server):
    _, url = paged_server
    hits = metric(get(url + "/metrics"), "llama_prefix_cache_hits_total")
    post(url + "/v1/chat/completions", chat("first watch"))
    post(url + "/v1/chat/completions", chat("second watch"))
    text = get(url + "/metrics")
    assert metric(text, "llama_prefix_cache_hits_total") >= hits + 1
    assert metric(text, "llama_kv_blocks_total") == 11


def test_metrics_expose_the_batchers_counters(paged_server):
    """Occupancy, prefill rows and padding, prefix-cache rows, admissions,
    queue wait, graphed steps and prefills on K1 (none of either on the
    CPU): /metrics reads the batcher's own counters, and a chat with a
    shared system prompt moves them."""
    srv, url = paged_server
    names = ("rows_stepped", "prefill_tokens", "prefill_padded_tokens",
             "prefill_cached_tokens", "admissions", "admission_stalls", "graph_steps",
             "prefill_flash")
    before = get(url + "/metrics")
    post(url + "/v1/chat/completions", chat("first watch"))
    post(url + "/v1/chat/completions", chat("third watch"))
    text = get(url + "/metrics")
    b = srv.batcher
    for name in names:
        assert metric(text, f"llama_batch_{name}_total") == getattr(b, name), name
    assert metric(text, "llama_batch_queue_wait_seconds_total") == pytest.approx(
        b.queue_wait_s, abs=1e-6)
    grew = {n: metric(text, f"llama_batch_{n}_total")
            - metric(before, f"llama_batch_{n}_total") for n in names}
    assert grew["admissions"] == 2 and grew["prefill_cached_tokens"] >= 32
    assert grew["rows_stepped"] >= metric(text, "llama_batch_decode_steps_total") \
        - metric(before, "llama_batch_decode_steps_total") > 0
    assert grew["prefill_tokens"] > 0 and grew["admission_stalls"] == 0
    assert metric(text, "llama_batch_graph_steps_total") == 0
    assert metric(text, "llama_batch_prefill_flash_total") == 0


def test_completions_logprobs_and_seeded_sampling(paged_server):
    _, url = paged_server
    status, body = post(url + "/v1/completions",
                        {"prompt": "hello", "max_tokens": 5, "logprobs": 2})
    lp = body["choices"][0]["logprobs"]
    assert status == 200 and len(lp["tokens"]) == len(lp["token_logprobs"]) == 5
    assert all(len(top) <= 2 for top in lp["top_logprobs"])
    sampled = {"prompt": "hello", "max_tokens": 8, "temperature": 1.2, "seed": 7}
    texts = [post(url + "/v1/completions", sampled)[1]["choices"][0]["text"]
             for _ in range(2)]
    assert texts[0] == texts[1]


def test_admission_bound_answers_429(paged_server):
    srv, url = paged_server
    # an earlier test's handler frees its slot after its reply is written:
    # wait until the server holds no admitted request before draining
    deadline = time.monotonic() + 30
    while srv._inflight and time.monotonic() < deadline:
        time.sleep(0.01)
    held = 0
    while srv.try_admission():
        held += 1
    assert held == srv.max_pending
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            post(url + "/v1/completions", {"prompt": "hi", "max_tokens": 2})
        assert e.value.code == 429 and e.value.headers["Retry-After"] == "1"
        assert metric(get(url + "/metrics"), "llama_requests_rejected_total") >= 1
    finally:
        for _ in range(held):
            srv.release_admission()
    assert post(url + "/v1/completions", {"prompt": "hi", "max_tokens": 2})[0] == 200


def test_bad_requests(paged_server):
    _, url = paged_server
    for path, body in (("/v1/completions", {"prompt": ""}),
                       ("/v1/chat/completions", {"messages": []}),
                       ("/v1/completions", {"prompt": "x", "logprobs": 9}),
                       ("/v1/completions", {"prompt": "x", "stop": [""]})):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(url + path, body)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        get(url + "/nope")
    assert e.value.code == 404


def test_serialized_server_seed_restores_the_generator():
    """Without a batcher a request's seed reseeds the engine's generator
    for that request only; greedy blocking text equals the batcher's."""
    srv, url = start()
    try:
        state = srv.engine._generator.get_state()
        sampled = {"prompt": "hello", "max_tokens": 6, "temperature": 1.3, "seed": 5}
        texts = [post(url + "/v1/completions", sampled)[1]["choices"][0]["text"]
                 for _ in range(2)]
        assert texts[0] == texts[1]
        assert torch.equal(srv.engine._generator.get_state(), state)
        greedy = post(url + "/v1/chat/completions", chat("status report"))[1]
        with pytest.raises(urllib.error.HTTPError) as e:     # logprobs need a batcher
            post(url + "/v1/completions", {"prompt": "x", "logprobs": 1})
        assert e.value.code == 400
    finally:
        srv.shutdown()
    batched, burl = start(continuous_slots=1)
    try:
        assert post(burl + "/v1/chat/completions", chat("status report"))[1][
            "choices"][0]["message"] == greedy["choices"][0]["message"]
    finally:
        batched.shutdown()


def test_metrics_expose_the_engines_graph_counters():
    """The serialized server decodes on the engine's graphs: /metrics reads
    the graphs built and evicted; a repeat in a cache bucket builds none,
    and a full LRU evicts a graph that the next request builds again."""
    srv, url = start()

    def counters():
        text = get(url + "/metrics")
        return (metric(text, "llama_decode_graphs_built_total"),
                metric(text, "llama_decode_graph_evictions_total"))

    try:
        eng = srv.engine
        warm = counters()
        assert warm == (eng.graphs_built, eng.graph_evictions) and warm[0] > 0
        post(url + "/v1/completions", {"prompt": "hello", "max_tokens": 6})
        assert counters() == warm
        eng.MAX_CHUNK_EXECUTABLES = 1
        post(url + "/v1/completions", {"prompt": "hello", "max_tokens": 6,
                                       "temperature": 1.0, "seed": 1})
        post(url + "/v1/completions", {"prompt": "hello", "max_tokens": 6})
        built, evicted = counters()
        assert (built, evicted) == (eng.graphs_built, eng.graph_evictions)
        assert built > warm[0] and evicted > warm[1]
    finally:
        srv.shutdown()


@pytest.mark.parametrize("max_new", [1, 9, 500])
def test_generate_block_matches_the_engine(max_new):
    eng = make_engine()
    prompt = [1, 2, 3]
    ids, finish = generate_block(eng, prompt, max_new)
    want = [t for _, t in eng.generate_tokens(prompt, max_new_tokens=max_new)]
    assert ids == want[:len(ids)] and len(ids) == min(max_new, eng.seq_len - len(prompt))
    assert finish == "length"


@pytest.mark.parametrize("stops", [None, ["xy"], ["b", "cd"], ["zzz"]])
def test_stop_sequences_match_jax(stops):
    pieces = [("ab", None), ("cx", None), ("yd", None), ("e", "length")]
    assert list(apply_stop_sequences(iter(pieces), stops)) == \
        list(jax_apply_stop_sequences(iter(pieces), stops))


def test_tp_on_cuda_without_cards_raises():
    """``--tp 2`` on ``cuda`` (the default) with no card raises before any
    rank starts: nothing falls back to the CPU or to fewer ranks (with
    fewer cards than ranks ``check_cards`` names both counts)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card (tests/test_torch_gpu.py checks the count)")
    assert cli.parse_args([]).device == "cuda" and cli.parse_args(["--tp", "2"]).tp == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--tiny", "--tp", "2", "--continuous", "2"])


@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo group in this process and its mesh, torn down after."""
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="gloo")
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("paged", [False, True])
def test_batchers_accept_a_mesh(one_rank_mesh, paged):
    """A one-rank gloo mesh: the batchers accept it with a control group
    (the step records go over it) and give the tokens of the batcher
    without a mesh, greedy and seeded sampled; without one they refuse."""
    streams = [batcher_streams(mesh, paged) for mesh in (None, one_rank_mesh)]
    assert streams[0] == streams[1]
    with pytest.raises(ValueError, match="needs the control group"):
        make_batcher(mesh_engine(one_rank_mesh), paged, control=None)


def mesh_engine(mesh):
    """The tiny cyclic engine, on its shards under ``mesh``."""
    eng = make_engine()
    if mesh is None:
        return eng
    return type(eng)(dataclasses.replace(eng.model, params=shard_params(
        eng.model.params, mesh)), eng.args, device="cpu", mesh=mesh)


def make_batcher(eng, paged: bool, control):
    if paged:
        return PagedBatcher(eng, n_slots=2, block_size=8, control=control)
    return ContinuousBatcher(eng, 2, control=control)


def batcher_streams(mesh, paged: bool):
    """Two requests, greedy and seeded sampled, through a batcher on the
    tiny cyclic engine (its shards under ``mesh``): their streams."""
    b = make_batcher(mesh_engine(mesh), paged,
                     control=None if mesh is None else new_control_group())
    assert (b._lockstep is None) == (mesh is None)
    reqs = [b.submit([1, 2, 3], max_new_tokens=9),
            b.submit([4, 5], max_new_tokens=7, temperature=0.9, seed=11)]
    b.run_until_idle()
    b.stop()
    return [list(r.tokens(timeout=30)) for r in reqs]


@pytest.mark.parametrize("failure", [ValueError, RuntimeError])
def test_follower_skips_only_the_engines_refusals(one_rank_mesh, monkeypatch, failure):
    """A sequential follower skips a call the engine refuses (a
    ``ValueError``, raised before any collective, as on rank 0) and follows
    the next; any other failure leaves ``follow`` (the process model then
    ends every rank), never waiting for a call rank 0 sends into
    collectives this rank will not join."""
    srv = LlamaHTTPServer(mesh_engine(one_rank_mesh), model_name="tiny-test")
    calls = iter([("block", [1, 2, 3], 4), None])
    monkeypatch.setattr(server_mod, "broadcast", lambda obj, control: next(calls))

    def planted(*_args):
        raise failure("planted")

    monkeypatch.setattr(device_loop, "generate_block", planted)
    if failure is ValueError:
        srv.follow()
        assert next(calls, "spent") == "spent"      # it went on to the stop call
    else:
        with pytest.raises(RuntimeError, match="planted"):
            srv.follow()


@pytest.mark.parametrize("paged", [False, True])
def test_rank0_batcher_failure_ends_the_rank(one_rank_mesh, monkeypatch, paged):
    """Under a mesh, rank 0's batcher thread that fails ends the process
    through ``parallel.launch.abort`` (the followers, waiting for its next
    record or collective, are ended by their watch); it does not log and
    leave the server taking requests that can only time out."""
    aborted = []
    monkeypatch.setattr(launch, "abort", aborted.append)
    b = make_batcher(mesh_engine(one_rank_mesh), paged, control=new_control_group())

    def planted():
        raise RuntimeError("planted step failure")

    b._step_once = planted
    b.submit([1, 2, 3], max_new_tokens=4)
    b.serve_forever_in_thread().join(30)
    assert not b._thread.is_alive()
    assert len(aborted) == 1 and "planted step failure" in aborted[0]


def test_server_accepts_attn_impl_probe(monkeypatch):
    """``--attn-impl probe`` reaches the engine (no refusal); a sequential
    server on a probing engine answers as an auto one does, and its
    batchers keep the auto rules."""
    served = []
    monkeypatch.setattr(cli, "serve", lambda engine, *a, **kw: served.append((engine, kw)))
    assert cli.main(["--tiny", "--device", "cpu", "--attn-impl", "probe",
                     "--continuous", "2"]) == 0
    engine, kw = served[0]
    assert engine.args.attn_impl == "probe" and kw["continuous_slots"] == 2
    texts = []
    for impl in ("probe", "auto"):
        srv = LlamaHTTPServer(make_engine(seq_len=160, attn_impl=impl), model_name="tiny-test")
        srv.prewarm()
        url = f"http://127.0.0.1:{srv.start_background()}"
        try:
            texts.append(post(url + "/v1/chat/completions", chat("status report"))[1][
                "choices"][0]["message"])
        finally:
            srv.shutdown()
        if impl == "probe":
            assert set(srv.engine._probed_decode_impl.values()) == {"plain"}
    assert texts[0] == texts[1]
