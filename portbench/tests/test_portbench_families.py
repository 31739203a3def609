"""The model family seam, on the CPU at the tiny size: a configuration names
its family (``"llama"`` where it names none), whose file gives the cell's
shapes, weights, program and plain reference.

The Llama family makes the same weights and the same reference logits as
the harness did before the seam (values pinned there); a second family is
taken by name, and its own reference decides ``correct``; a family with no
file, or a file that lacks one of its four parts, is refused."""

import hashlib
import json

import pytest
import torch

from portbench.bench import Bench
from portbench.tests.conftest import TINY_CONFIG, run
from portbench.weights import checksum

CPU = torch.device("cpu")
SEED = 2**31 + 19
# read through portbench.weights and portbench.reference before the seam:
# the tiny weights' checksum at SEED, and the first 16 hex digits of the
# sha256 of the reference's logits over two sequences, on one thread (more
# threads split its float32 sums otherwise)
PINNED_CHECKSUM = -17.837293330579996
PINNED_LOGITS = {"fp32": "61fdeef3a56c7a1c", "fp8": "3bf1689002a429d4"}

TOY = '''"""A second family for the tests: the Llama block's shapes, weights and
program, with its own reference."""
from portbench.families import llama

dims, make_weights, program = llama.dims, llama.make_weights, llama.program
PLANTED = {planted}


class Reference(llama.Reference):
    def __init__(self, weights, cfg, precision="fp32"):
        if PLANTED:                 # the first layer's w_down turned round
            weights = dict(weights, w_down=weights["w_down"].clone())
            weights["w_down"][0].neg_()
        super().__init__(weights, cfg, precision)
'''


def add_cell(root, family):
    """A configuration of the tiny sizes that names ``family``, and a cell
    ``tiny.<family>`` of it under the tiny chat mix."""
    bench = root / "portbench"
    (bench / "configs" / f"tiny-{family}.json").write_text(
        json.dumps({**TINY_CONFIG, "family": family}))
    (bench / "limits" / f"tiny.{family}.json").write_text(
        (bench / "limits" / "tiny.chat.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": f"tiny-{family}", "source": "a test size",
                            "file": f"portbench/configs/tiny-{family}.json", "reduced": [],
                            "why": "tests"})
    spec["workloads"].append({"name": f"tiny.{family}", "config": f"tiny-{family}",
                              "traffic": "tiny-chat", "chips": 1, "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return f"tiny.{family}"


@pytest.mark.parametrize("precision", ["fp32", "fp8"])
def test_the_llama_family_makes_the_weights_and_logits_pinned_before_it(tiny_root,
                                                                        precision):
    family = Bench(tiny_root).cell("tiny.chat").family
    assert family.name == "llama"
    dims = family.dims(TINY_CONFIG)
    weights = family.weights(dims, SEED, CPU)
    assert checksum(weights) == PINNED_CHECKSUM
    gen = torch.Generator().manual_seed(7)
    seqs = [torch.randint(0, dims.vocab, (n,), generator=gen).tolist() for n in (40, 23)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = family.Reference(weights, TINY_CONFIG, precision=precision).logits(seqs, [30, 20])
    finally:
        torch.set_num_threads(threads)
    assert [tuple(r.shape) for r in rows] == [(10, dims.vocab), (3, dims.vocab)]
    digest = hashlib.sha256(b"".join(r.contiguous().numpy().tobytes() for r in rows))
    assert digest.hexdigest()[:16] == PINNED_LOGITS[precision]


@pytest.mark.parametrize("planted", [False, True], ids=["sound", "planted"])
def test_a_second_family_is_taken_and_its_reference_decides(tiny_root, planted):
    (tiny_root / "portbench" / "families" / "toy.py").write_text(TOY.format(planted=planted))
    cell = add_cell(tiny_root, "toy")
    assert Bench(tiny_root).cell(cell).family.name == "toy"
    r = run(tiny_root, cell, seed=SEED)
    assert r["correct"] is not planted, r["checks"]
    gap = r["checks"]["logit_gap"]
    assert (gap["value"] > gap["limit"]) is planted


@pytest.mark.parametrize("body, says", [
    (None, "does not exist"),
    ("from portbench.families.llama import dims, make_weights, program\n", "['Reference']"),
], ids=["no-file", "no-reference"])
def test_a_family_without_its_file_or_a_part_is_refused(tiny_root, body, says):
    path = tiny_root / "portbench" / "families" / "nonesuch.py"
    if body is not None:
        path.write_text(body)
    cell = add_cell(tiny_root, "nonesuch")
    with pytest.raises((FileNotFoundError, AttributeError)) as refused:
        Bench(tiny_root).cell(cell)
    assert str(path) in str(refused.value) and says in str(refused.value)
