"""The one generator: the same seed gives the same requests, every seed the
same set of sizes and arrival gaps in an order and with tokens of its own,
spread so that no block of neighbours takes two sizes of one stratum, and
every mix keeps its lengths and positions within its limits."""

import json

import numpy as np
import pytest

from portbench import traffic
from portbench.tests.conftest import BENCH, TINY_MIXES

MIXES = {p.stem: json.loads(p.read_text()) for p in (BENCH / "mixes").glob("*.json")}
# the shared-prefix path of the generator, at a serving cell's rate and prompts
SHARED = {**TINY_MIXES["tiny-shared"], "context": 4096,
          "arrivals": {"loop": "open", "rate_per_s": 2.4, "ramp_s": 6.0},
          "shared": {"prompts": 8, "length": 2048, "zipf": 1.1}}
OPEN = {"serve-chat": MIXES["serve-chat"], "shared": SHARED}
SEEDS = (7, 2**31 + 11)


def plan(mix, seed, seconds=45.0, vocab=32000):
    return traffic.generate(mix, seed, seconds, vocab)


def sizes(t):
    return sorted((len(r.prompt) - r.shared_len, r.max_new, r.system) for r in t.requests)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_a_seed_gives_the_same_requests(name):
    a, b = plan(MIXES[name], SEEDS[1]), plan(MIXES[name], SEEDS[1])
    assert [(r.prompt, r.max_new, r.due) for r in a.requests] == \
        [(r.prompt, r.max_new, r.due) for r in b.requests]


def window_gaps(t, mix, seconds=45.0):
    """The window's arrival gaps, the last one to the window's end."""
    ramp = mix["arrivals"]["ramp_s"]
    due = [r.due for r in t.requests if r.due >= ramp] + [ramp + seconds]
    return sorted(round(b - a, 9) for a, b in zip(due, due[1:]))


@pytest.mark.parametrize("name", sorted(MIXES))
def test_every_seed_gets_the_same_set_in_an_order_of_its_own(name):
    mix = MIXES[name]
    a, b = plan(mix, SEEDS[0]), plan(mix, SEEDS[1])
    assert sizes(a) == sizes(b)
    assert [(len(r.prompt), r.max_new) for r in a.requests] != \
        [(len(r.prompt), r.max_new) for r in b.requests]
    assert all(x.prompt[x.shared_len:] != y.prompt[y.shared_len:]
               for x, y in zip(a.requests, b.requests))
    # sizes vary within a run: the schedule is no single length repeated
    assert len(set(len(r.prompt) for r in a.requests)) > 3
    if mix["arrivals"]["loop"] == "open":
        assert window_gaps(a, mix) == window_gaps(b, mix)
        assert [r.due for r in a.requests] != [r.due for r in b.requests]


@pytest.mark.parametrize("n", [1, 5, 8, 37, 82, 100])
def test_the_order_spreads_every_stratum(n):
    rng = np.random.default_rng(n)
    order = traffic.spread_order(n, rng)
    assert sorted(order) == list(range(n))
    for lo in range(0, n, traffic.SPREAD):
        strata = [i * traffic.SPREAD // n for i in order[lo:lo + traffic.SPREAD]]
        assert len(strata) == len(set(strata))
        if len(strata) == traffic.SPREAD:
            assert strata == list(traffic.PATTERN)
    if n >= 2 * traffic.SPREAD:
        assert list(order) != list(traffic.spread_order(n, np.random.default_rng(n + 1)))


@pytest.mark.parametrize("name", sorted(MIXES))
def test_lengths_stay_inside_the_mix(name):
    mix = MIXES[name]
    t = plan(mix, SEEDS[0])
    shared = mix.get("shared")
    for r in t.requests:
        turn = len(r.prompt) - r.shared_len
        assert mix["prompt"]["min"] <= turn <= mix["prompt"]["max"]
        assert r.max_new <= mix["output"]["max"]
        assert r.max_new >= min(mix["output"]["min"], mix.get("max_total", 10**9))
        # a request and its output fit the context, with the write of the next token
        assert len(r.prompt) + r.max_new + 2 <= mix["context"]
        if shared:
            assert r.shared_len == shared["length"]
            assert r.prompt[:r.shared_len] == t.system_prompts[r.system]
        assert all(0 <= x < 32000 for x in r.prompt)


def test_phi3_stays_under_its_sliding_window():
    # the published sliding window of 2047 never binds: every position < 2047
    t = plan(MIXES["serve-chat"], SEEDS[0])
    assert max(len(r.prompt) + r.max_new for r in t.requests) <= 2000


@pytest.mark.parametrize("name", sorted(OPEN))
def test_open_loop_arrivals_cover_the_window_alike_for_every_seed(name):
    mix = OPEN[name]
    rate, ramp = mix["arrivals"]["rate_per_s"], mix["arrivals"]["ramp_s"]
    for seed in SEEDS:
        t = plan(mix, seed)
        inside = [r for r in t.requests if r.due >= ramp]
        assert inside[0].due == ramp
        assert ramp + 45.0 - 10 / rate < inside[-1].due < ramp + 45.0
        assert len(inside) == round(rate * 45.0)
        assert len(t.requests) - len(inside) == round(rate * ramp)
        # the window's requests are a whole set of the mix's quantiles
        want = sorted(p for p, _, _ in traffic._sizes(mix, len(inside)))
        assert sorted(len(r.prompt) - r.shared_len for r in inside) == want


def test_shared_prompts_follow_zipf():
    mix = SHARED
    t = plan(mix, SEEDS[0])
    inside = [r for r in t.requests if r.due >= mix["arrivals"]["ramp_s"]]
    counts = [sum(1 for r in inside if r.system == k) for k in range(8)]
    assert counts == sorted(counts, reverse=True) and counts[-1] > 0
