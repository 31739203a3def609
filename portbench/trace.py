"""The device trace of a bounded stretch of the window, and its reduction.

``torch.profiler`` records the CPU's operators and the card's activities
(kernels, copies, sets) between :meth:`Stretch.start` and :meth:`Stretch.stop`,
each taken at a boundary between the program's calls after a
synchronisation, so the traced device work is exactly the work those calls
queued. The reduction keeps what the per-layer metrics read: the union of
device intervals (busy time), device seconds by kernel class, the top
operations by name, and the longest idle gaps named by what the host was
doing then.
"""

from __future__ import annotations

import re
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench.record import Trace
from portbench.stats import gaps, merge

# kernel classes by name: the port's own kernels (csrc/*.cu), then cuBLAS's.
# "gemm" is the projections' bf16 products (ops/linear.py); cuBLAS's float32
# products on the SIMT cores ("gemm_fp32": ffma, f32 inputs) are the plain
# attention path's (ops/attention.py), not a projection's
PORT_KERNELS = (("K1", "flash_gqa_kernel"), ("K2", "flash_decode_kernel"),
                ("K4", "int8_dot_decode_kernel"), ("K6", "paged_split_kernel"),
                ("K8", "q4_matmul_kernel"))
GEMM = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitKreduce", re.IGNORECASE)
FP32_GEMM = re.compile(r"f32f32_f32f32|_ffma_|sgemm", re.IGNORECASE)
TOP = 10


def kernel_class(name: str) -> str:
    for cls, key in PORT_KERNELS:
        if key in name:
            return cls
    if GEMM.search(name):
        return "gemm_fp32" if FP32_GEMM.search(name) else "gemm"
    return "other"


def _is_device(ev) -> bool:
    return str(ev.device_type()).upper().endswith("CUDA")


class Stretch:
    """One profiled stretch: started once the window is ``start_s`` old,
    stopped ``seconds`` later, both at a call boundary. In a window shorter
    than the mix's (a trial run) both shrink to at most 0.4 of it."""

    def __init__(self, start_s: float, seconds: float, device: torch.device,
                 window: float) -> None:
        self.start_s = min(start_s, 0.4 * window)
        self.seconds = min(seconds, 0.4 * window)
        self.device = device
        self.prof = None
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self._offset_ns = 0

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def due(self, now: float, window_start: float) -> bool:
        return self.prof is None and now >= window_start + self.start_s

    def over(self, now: float) -> bool:
        return self.active and now >= self.t0 + self.seconds

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start in
        a process takes seconds, which would otherwise stall the window."""
        prof = self._profile()
        prof.start()
        self._sync()
        prof.stop()

    def start(self) -> None:
        self._sync()
        self.prof = self._profile()
        self.prof.start()
        # the profiler stamps events on the wall clock in ns
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def reduce(self, context: Callable[[float], str]) -> Trace:
        """The stretch's :class:`Trace`; ``context(t)`` names the
        benchmark's span at host time ``t`` (for the idle gaps)."""
        events = self.prof.profiler.kineto_results.events()
        off = self._offset_ns
        lo, hi = self.t0, self.t1
        device: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str]] = []
        outside = 0
        for ev in events:
            a = (ev.start_ns() - off) / 1e9
            b = a + ev.duration_ns() / 1e9
            if b <= lo or a >= hi:
                outside += _is_device(ev)
                continue
            (device if _is_device(ev) else host).append((max(a, lo), min(b, hi), ev.name()))
        print(f"[portbench] trace: {len(device)} device events in the stretch of "
              f"{hi - lo:.3f} s, {outside} outside it, {len(host)} host events",
              file=sys.stderr, flush=True)
        busy = merge((a, b) for a, b, _ in device)
        by_class: Dict[str, float] = {}
        by_name: Dict[str, float] = {}
        for a, b, name in device:
            cls = kernel_class(name)
            by_class[cls] = by_class.get(cls, 0.0) + (b - a)
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for a, b in idle:
            mid = (a + b) / 2
            inner = [h for h in host if h[0] <= mid <= h[1]]
            op = max(inner, key=lambda h: h[0])[2] if inner else "no operator (Python)"
            named.append((f"{context(mid)}: {op}"[:120], b - a))
        self.prof = None                     # the raw events go with it
        return Trace(t0=lo, t1=hi, busy=busy, by_class=by_class,
                     top_ops=[(n[:120], s) for n, s in top], idle_gaps=named)
