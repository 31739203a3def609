"""Percentiles and the union-of-intervals arithmetic the metrics share."""

import numpy as np
import pytest

from portbench.stats import covered, gaps, merge, overlap, percentile


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_is_numpys_linear(q):
    xs = np.random.default_rng(3).lognormal(size=97).tolist()
    assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_union_of_overlapping_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (8, 8)]
    assert merge(iv) == [(0, 3), (5, 7)]
    assert covered(iv) == 5


def test_overlap_counts_each_point_once():
    busy = [(0, 4), (3, 5), (9, 12)]
    spans = [(1, 2), (4, 10), (11, 20)]
    # [1,2] + [4,5] + [9,10] + [11,12]
    assert overlap(busy, spans) == pytest.approx(4)


def test_gaps_are_the_uncovered_stretches():
    assert gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert gaps([(-1, 7)], 0, 6) == []
