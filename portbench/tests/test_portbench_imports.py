"""The benchmark measures the port alone: no module it runs imports JAX,
Flax or the JAX package (top-level names compared whole, since the port's
name begins with the JAX package's), and the plain reference, each model
family's, imports nothing of the port either."""

import ast
import inspect
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.bench import Bench
from portbench.tests.conftest import BENCH, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "llama_nuts_and_bolts_tpu")
PORT = "llama_nuts_and_bolts_tpu_torch"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)
FAMILIES = sorted(p.stem for p in (BENCH / "families").glob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__", "find_spec") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_the_harness_has_the_files_it_runs():
    names = {p.name for p in SOURCES}
    assert {"run.py", "reference.py", "traffic.py", "yardstick.py"} <= names
    assert len([p for p in SOURCES if p.parent.name == "metrics"]) >= 10


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_harness_module_imports_jax(path):
    assert not set(imported(path)) & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "correct.py", "yardstick.py", "stats.py", "traffic.py"):
        assert PORT not in set(imported(BENCH / name)), name


@pytest.mark.parametrize("family", FAMILIES)
def test_a_familys_reference_imports_nothing_of_the_program(family):
    source = Path(inspect.getsourcefile(Bench(ROOT).family(family).Reference))
    assert source.is_relative_to(BENCH)
    assert PORT not in set(imported(source)), source


def test_the_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "llama_nuts_and_bolts_tpu_torch_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
