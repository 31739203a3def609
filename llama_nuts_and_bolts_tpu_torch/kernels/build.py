"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc`` for
``sm_90a`` into ``build/kernels/lib<name>.so`` at the repository root (listed
in ``.gitignore``). A library is rebuilt when its source is newer. No
PyTorch headers are compiled, so a build takes seconds; :func:`build` starts
one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_attention", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.is_file():
        return True
    return (CSRC / f"{name}.cu").stat().st_mtime > lib.stat().st_mtime


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale source, one ``nvcc`` each, all started together.
    Returns the compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) per built source; raises with the output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            if not _stale(name):
                continue
            tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp)
        reports = {}
        for name, (proc, tmp) in procs.items():
            output, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{output}")
            os.replace(tmp, library_path(name))
            reports[name] = output
        return reports
    finally:
        for proc, _tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first when stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check_launch(err: int, kernel: str) -> None:
    """Raise when a kernel's C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError_t {err}")
