"""Two-sink logger with an inter-call elapsed-time debug tracer.

Capability parity with the reference's logger (reference:
src/common/logging.go:11-55): a console sink for user-facing progress and an
optional debug-file sink where every line is stamped with the wall-clock
seconds elapsed since the previous debug line — the "poor man's tracer" that
narrates the forward pass. Rebuilt as a small Python class; the debug sink is
a context-free append-only file like the reference's debug.log.
"""

from __future__ import annotations

import sys
import time
from typing import IO, Optional


class Logger:
    """Console + optional debug-file logger.

    ``debug(fmt, ...)`` goes only to the debug file (if any), prefixed with the
    elapsed seconds since the previous debug call. ``info`` goes to the console
    and mirrors into the debug file.
    """

    def __init__(self, debug_path: Optional[str] = None,
                 console: Optional[IO[str]] = None) -> None:
        self._console = console
        self._debug_file: Optional[IO[str]] = None
        self._last_debug_time: Optional[float] = None
        if debug_path:
            self._debug_file = open(debug_path, "a", encoding="utf-8")

    @property
    def console(self) -> IO[str]:
        """The given console, else ``sys.stdout`` as it is now (not as it was
        when the logger was made: a replaced and closed stream is never
        written)."""
        return self._console if self._console is not None else sys.stdout

    # -- sinks ------------------------------------------------------------

    def info(self, fmt: str, *args: object) -> None:
        msg = (fmt % args) if args else fmt
        self.console.write(msg + "\n")
        self.console.flush()
        self._write_debug(msg)

    def error(self, fmt: str, *args: object) -> None:
        msg = (fmt % args) if args else fmt
        self.console.write("ERROR: " + msg + "\n")
        self.console.flush()
        self._write_debug("ERROR: " + msg)

    def debug(self, fmt: str, *args: object) -> None:
        if self._debug_file is None:
            return
        msg = (fmt % args) if args else fmt
        self._write_debug(msg)

    # -- internals --------------------------------------------------------

    def _write_debug(self, msg: str) -> None:
        if self._debug_file is None:
            return
        now = time.monotonic()
        elapsed = 0.0 if self._last_debug_time is None else now - self._last_debug_time
        self._last_debug_time = now
        stamp = time.strftime("%H:%M:%S")
        self._debug_file.write(f"[{stamp} +{elapsed:9.4f}s] {msg}\n")
        self._debug_file.flush()

    def close(self) -> None:
        if self._debug_file is not None:
            self._debug_file.close()
            self._debug_file = None


_GLOBAL_LOGGER = Logger()


def get_logger() -> Logger:
    return _GLOBAL_LOGGER


def set_logger(logger: Logger) -> Logger:
    global _GLOBAL_LOGGER
    _GLOBAL_LOGGER = logger
    return logger
