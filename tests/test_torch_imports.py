"""The PyTorch port stands alone: neither its package (``parallel/``
included) nor chip_smoke.py nor the tensor-parallel test ranks import JAX, Flax or anything of the JAX package (an AST scan, so dynamic
imports inside functions count too), every name that the port, the smoke
or the port's tests import from the port exists (chip_smoke.py's phases that
need several cards run nowhere else, so a name they import is checked here),
and its entry points default to the card with no silent CPU fallback."""

import ast
import importlib
import pathlib

import pytest
import torch

from llama_nuts_and_bolts_tpu_torch.device import DEFAULT_DEVICE, resolve_device

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "llama_nuts_and_bolts_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "llama_nuts_and_bolts_tpu")


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, node.args[0].value


def test_port_and_chip_smoke_import_nothing_of_jax():
    # tests/tp_workers.py runs the tensor-parallel ranks: they import the port only
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "tests" / "tp_workers.py"]
    assert len(files) > 30
    assert {"__init__.py", "mesh.py", "sharding.py", "kernel_shard.py", "launch.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    bad = [f"{f.relative_to(REPO)}:{line}: {mod}"
           for f in files for line, mod in imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


def port_names(path):
    """Each ``(line, module, name)`` of a ``from llama_nuts_and_bolts_tpu_torch...
    import name`` in ``path``, inside functions too."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.ImportFrom) and node.level == 0
                and node.module.split(".")[0] == "llama_nuts_and_bolts_tpu_torch"):
            for alias in node.names:
                yield node.lineno, node.module, alias.name


IMPORTING = (["chip_smoke.py", "tests/tp_workers.py"]
             + sorted(str(f.relative_to(REPO)) for f in (REPO / "tests").glob("test_torch_*.py")))


@pytest.mark.parametrize("rel", IMPORTING)
def test_every_name_imported_from_the_port_exists(rel):
    missing = []
    for line, module, name in port_names(REPO / rel):
        mod = importlib.import_module(module)
        if not hasattr(mod, name):
            try:
                importlib.import_module(f"{module}.{name}")
            except ModuleNotFoundError:
                missing.append(f"{rel}:{line}: {module}.{name}")
    assert missing == []


def test_name_check_sees_a_missing_name(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text("def f():\n    from llama_nuts_and_bolts_tpu_torch.parallel.launch "
                   "import _broadcast, broadcast\n")
    found = [(m, n) for _, m, n in port_names(src)]
    assert found == [("llama_nuts_and_bolts_tpu_torch.parallel.launch", "_broadcast"),
                     ("llama_nuts_and_bolts_tpu_torch.parallel.launch", "broadcast")]
    launch = importlib.import_module(found[0][0])
    assert not hasattr(launch, "_broadcast") and hasattr(launch, "broadcast")


def test_scanner_sees_every_import_form(tmp_path):
    src = tmp_path / "probe.py"
    src.write_text("import jax.numpy as jnp\nfrom llama_nuts_and_bolts_tpu.ops import x\n"
                   "def f():\n    import flax\n    importlib.import_module('jaxlib')\n"
                   "from llama_nuts_and_bolts_tpu_torch import ops\n")
    roots = sorted(m.split(".")[0] for _, m in imported_modules(src))
    assert roots == ["flax", "jax", "jaxlib", "llama_nuts_and_bolts_tpu",
                     "llama_nuts_and_bolts_tpu_torch"]


def test_default_device_is_cuda_and_cuda_never_falls_back():
    assert DEFAULT_DEVICE == "cuda"
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                resolve_device(dev)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_numerics_match_the_jax_package_fp32_accumulation():
    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("module", [
    "serving/__init__.py", "serving/server.py", "serving/__main__.py",
    "runtime/continuous.py", "runtime/paged.py", "runtime/block_pool.py",
    "runtime/device_loop.py", "models/llama/paged.py", "kernels/paged_attention.py",
    "ops/sampling.py"])
def test_scan_covers_the_serving_slice(module):
    """The serving slice's modules are among the scanned files, and each
    imports nothing of JAX on its own."""
    path = PORT / module
    assert path in set(PORT.rglob("*.py"))
    assert [m for _, m in imported_modules(path) if m.split(".")[0] in FORBIDDEN] == []


@pytest.mark.parametrize("module", [
    "runtime/profiling.py", "runtime/engine.py", "runtime/decode_graph.py",
    "tokenizer/native.py", "tokenizer/bpe.py", "utils/hexcodes.py",
    "utils/native_lib.py", "io/shards.py", "models/llama/loader.py",
    "models/llama/model.py", "cli/main.py"])
def test_scan_covers_the_single_device_modules(module):
    """The probe's, profiling's, the native merge's and the sharded loader's
    modules are among the scanned files, and each imports nothing of JAX on
    its own."""
    path = PORT / module
    assert path in set(PORT.rglob("*.py"))
    assert [m for _, m in imported_modules(path) if m.split(".")[0] in FORBIDDEN] == []


@pytest.mark.parametrize("module", [
    "parallel/launch.py", "parallel/sharding.py", "parallel/kernel_shard.py",
    "models/llama/paged.py", "runtime/paged.py", "runtime/continuous.py",
    "serving/server.py", "serving/__main__.py", "cli/main.py"])
def test_scan_covers_the_tp_serving_modules(module):
    """Tensor parallelism for serving -- the process model, the pool's
    shards, K6 on a rank's heads, the paged functions, both batchers in
    lockstep, the server's --tp -- is scanned, and each module imports
    nothing of JAX on its own."""
    path = PORT / module
    assert path in set(PORT.rglob("*.py"))
    assert [m for _, m in imported_modules(path) if m.split(".")[0] in FORBIDDEN] == []
