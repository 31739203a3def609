"""HTTP serving of the PyTorch port: a live tiny server on the CPU over the
paged batcher (health, models, chat streamed against blocking, completions
with logprobs, seeded sampling, /metrics with the prefix cache, the 429
admission bound), the serialized server, the non-streaming greedy loop, the
stop-sequence filter against the JAX package's, and the CLI's refusals of
unported flags."""

import json
import urllib.error
import urllib.request

import pytest
import torch

from llama_nuts_and_bolts_tpu.serving.server import (
    apply_stop_sequences as jax_apply_stop_sequences,
)

from llama_nuts_and_bolts_tpu_torch.runtime.device_loop import generate_block
from llama_nuts_and_bolts_tpu_torch.serving import __main__ as cli
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
    held = 0
    while srv.try_admission():
        held += 1
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


@pytest.mark.parametrize("flag,item", [(["--tp", "2"], "17"), (["--speculate", "2"], "12"),
                                       (["--draft-model", "d"], "12")])
def test_cli_refuses_unported_flags(flag, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        cli.main(["--tiny", "--device", "cpu", *flag])
    assert cli.parse_args([]).device == "cuda"
