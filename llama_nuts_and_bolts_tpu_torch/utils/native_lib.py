"""The repository's host-side C++ helpers (``native/*.cpp``), built at first use.

``g++`` compiles ``native/<name>.cpp`` into ``build/native/lib<name>.so`` at
the repository root (a directory ``.gitignore`` lists) when the library is
missing or older than its source, and ``ctypes`` loads it. These are host
code, not device kernels: a caller whose build fails runs its Python twin,
as the JAX package's callers do.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

REPO = Path(__file__).resolve().parents[2]


class NativeLibrary:
    """``native/<name>.cpp`` as a loaded library, built once per process.
    ``signatures`` lists ``(function, restype, argtypes)``. A failed build is
    remembered, so the compiler is asked once per process."""

    def __init__(self, name: str, signatures: Sequence[Tuple[str, object, list]]) -> None:
        self.src = REPO / "native" / f"{name}.cpp"
        self.so = REPO / "build" / "native" / f"lib{name}.so"
        self._signatures = signatures
        self._lib: Optional[ctypes.CDLL] = None
        self._failed = False
        self._lock = threading.Lock()

    def _build_and_load(self) -> ctypes.CDLL:
        so, src = self.so, self.src
        if not so.is_file() or (src.is_file() and src.stat().st_mtime > so.stat().st_mtime):
            so.parent.mkdir(parents=True, exist_ok=True)
            # built under a name of its own, then renamed: concurrent
            # processes never load a half-written library
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                            str(src), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, restype, argtypes in self._signatures:
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        return lib

    def load(self) -> Optional[ctypes.CDLL]:
        """The library, or None where it cannot be built."""
        with self._lock:
            if self._lib is None and not self._failed:
                try:
                    self._lib = self._build_and_load()
                except (OSError, subprocess.SubprocessError):
                    self._failed = True
            return self._lib
