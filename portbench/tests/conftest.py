"""A small benchmark beside the real one: a checkout root in a temporary
directory whose ``BENCHMARK.json`` names tiny cells, with the real
``portbench`` data (metrics, configs, mixes, limits) copied next to the
tiny files, so that a run goes through every part of the harness on the
CPU in seconds."""

import json
import os
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench.bench import Bench
from portbench.cell import run_cell

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY_CONFIG = {"source": "a test size", "dim": 512, "n_layers": 4, "n_heads": 4,
               "n_kv_heads": 1, "multiple_of": 64, "ffn_dim_multiplier": 1.0,
               "vocab_size": 2048, "norm_eps": 1e-5, "rope_theta": 10000.0,
               "use_scaled_rope": False, "max_sequence_length": 256}
TRACE = {"start_s": 0.2, "seconds": 0.4}
TINY_MIXES = {
    "tiny-serve": {"entry": "paged_batcher", "context": 256, "slots": 4,
                   "arrivals": {"loop": "open", "rate_per_s": 8.0, "ramp_s": 0.2},
                   # every prompt holds a whole block, so each admission looks
                   # the prefix cache up
                   "prompt": {"dist": "lognormal", "median": 48, "sigma": 0.4, "min": 36,
                              "max": 96},
                   "output": {"dist": "loguniform", "min": 16, "max": 48},
                   "max_total": 200, "sample": 4, "trace": TRACE},
    "tiny-chat": {"entry": "engine", "context": 256,
                  "arrivals": {"loop": "closed", "pool": 2},
                  "prompt": {"dist": "loguniform", "min": 16, "max": 64},
                  "output": {"dist": "loguniform", "min": 16, "max": 48},
                  "sample": 4, "trace": TRACE},
    "tiny-shared": {"entry": "paged_batcher", "context": 256, "slots": 4,
                    "arrivals": {"loop": "open", "rate_per_s": 8.0, "ramp_s": 0.2},
                    "shared": {"prompts": 2, "length": 64, "zipf": 1.1},
                    "prompt": {"dist": "loguniform", "min": 8, "max": 32},
                    "output": {"dist": "loguniform", "min": 16, "max": 48},
                    "sample": 4, "trace": TRACE},
}
# read on the CPU at this size over seeds 100-107 (sample of 4, ~115 tokens):
# the program's widest gap 0 to 0.0198, the float8 control's 0.1206 to 0.3063
TINY_LIMITS = {"logit_gap": {"limit": 0.05}, "tokens_compared": {"limit": 48}}


def run(root, cell, trace=False, seed=2**31 + 5, seconds=2.0):
    """One whole run of ``cell`` in the checkout at ``root``, on the CPU."""
    return run_cell(Bench(root), cell, seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter())


def make_root(tmp: Path) -> Path:
    """A checkout root with the real benchmark's data and three tiny cells."""
    root = tmp / "checkout"
    bench = root / "portbench"
    for sub in ("configs", "mixes", "limits", "metrics", "entries", "families"):
        shutil.copytree(BENCH / sub, bench / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (bench / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    spec["configs"].append({"name": "tiny", "source": "a test size",
                            "file": "portbench/configs/tiny.json", "reduced": [],
                            "why": "tests"})
    for name, mix in TINY_MIXES.items():
        (bench / "mixes" / f"{name}.json").write_text(json.dumps(mix))
        cell = "tiny." + name.split("-")[1]
        spec["workloads"].append({"name": cell, "config": "tiny", "traffic": name,
                                  "chips": 1, "why": "tests"})
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(TINY_LIMITS))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kind = "chat" if any("chat-long" in w for w in m["workloads"]) else "serve"
            m["workloads"] += (["tiny.chat"] if kind == "chat"
                               else ["tiny.serve", "tiny.shared"])
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture(scope="session", autouse=True)
def cores_shared_among_workers():
    """Each of pytest-xdist's workers takes its share of the cores: with
    every worker on all of them, the runs' windows (wall-clock seconds)
    served a few tokens or none, and their checks failed."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(threads)
