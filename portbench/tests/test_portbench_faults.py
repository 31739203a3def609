"""``correct`` comes out false when the timed path is broken underneath:
the harness's whole run, on the CPU at the tiny size, with one fault
planted in the program for each fault the cells can have (a decode step
that leaves the cache unchanged, half of a batched step's rows left out, a
token altered where it is produced); and the control, the reference in
float8 put in the program's place, comes out not correct through the
same checks. No cell runs on
more than one chip, so none can leave out an exchange between chips."""

import time

import pytest
import torch

import llama_nuts_and_bolts_tpu_torch.models.llama.model as model_mod
import llama_nuts_and_bolts_tpu_torch.models.llama.paged as paged_mod
import llama_nuts_and_bolts_tpu_torch.runtime.continuous as continuous_mod
import llama_nuts_and_bolts_tpu_torch.runtime.decode_graph as graph_mod
import llama_nuts_and_bolts_tpu_torch.runtime.paged as batcher_mod
from portbench.bench import Bench
from portbench.cell import run_cell

CPU = torch.device("cpu")


def run(root, cell, seed=2**31 + 17, control=False):
    return run_cell(Bench(root), cell, seed, 1.0, False, CPU, time.perf_counter(),
                    control=control)


def cache_left_unchanged(mp, paged: bool):
    if paged:
        mp.setattr(paged_mod, "_write_rows", lambda *a, **k: None)
    else:
        write = model_mod._write

        def decode_writes_nothing(buf, li, rows, inp):
            if inp.S_all != 1:
                write(buf, li, rows, inp)

        mp.setattr(model_mod, "_write", decode_writes_nothing)


def half_the_batch_left_out(mp):
    step = batcher_mod.paged_decode_step

    def half(*args, **kwargs):
        logits, pool = step(*args, **kwargs)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:] = logits[:logits.shape[0] - h]
        return logits, pool

    mp.setattr(batcher_mod, "paged_decode_step", half)


def token_altered(mp, paged: bool):
    if paged:
        sample = continuous_mod.sample_tokens_batched

        def altered(logits, seeds, positions, *a, **k):
            tok = sample(logits, seeds, positions, *a, **k)
            hit = torch.tensor([int(p) % 16 == 5 for p in positions], device=tok.device)
            return torch.where(hit, (tok + 1) % logits.shape[-1], tok)

        mp.setattr(continuous_mod, "sample_tokens_batched", altered)
    else:
        greedy = graph_mod.greedy
        mp.setattr(graph_mod, "greedy", lambda x: (greedy(x) + 1) % x.shape[-1])


FAULTS = [
    ("tiny.serve", "cache", lambda mp: cache_left_unchanged(mp, True)),
    ("tiny.serve", "half", half_the_batch_left_out),
    ("tiny.serve", "token", lambda mp: token_altered(mp, True)),
    ("tiny.shared", "cache", lambda mp: cache_left_unchanged(mp, True)),
    ("tiny.chat", "cache", lambda mp: cache_left_unchanged(mp, False)),
    ("tiny.chat", "token", lambda mp: token_altered(mp, False)),
]


@pytest.mark.parametrize("cell, fault, plant", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_a_planted_fault_is_not_correct(tiny_root, monkeypatch, cell, fault, plant):
    plant(monkeypatch)
    r = run(tiny_root, cell)
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["logit_gap"]["value"] > r["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.chat"])
def test_the_control_is_not_correct(tiny_root, cell):
    r = run(tiny_root, cell, control=True)
    limit = r["checks"]["logit_gap"]["limit"]
    assert r["correct"] is False, r["checks"]
    assert r["program_gap"] <= limit < r["checks"]["logit_gap"]["value"]
