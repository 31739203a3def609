"""Order statistics and interval arithmetic that every reader shares."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) by linear interpolation between the
    closest ranks, as numpy's default."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[Interval] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(intervals: Iterable[Interval]) -> float:
    """The length of the union of ``intervals``."""
    return sum(b - a for a, b in merge(intervals))


def overlap(a: Iterable[Interval], b: Iterable[Interval]) -> float:
    """The length of (union of ``a``) intersected with (union of ``b``)."""
    xs, ys = merge(a), merge(b)
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out: List[Interval] = []
    t = lo
    for a, b in merge(intervals):
        if b <= lo or a >= hi:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out
