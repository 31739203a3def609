"""Golden-tensor comparison helpers with dtype-aware thresholds.

Capability parity with the reference's test comparators (reference:
src/ml/utils.go:25-149 and thresholds at src/common/utils.go:13-17):
tolerances scale with dtype (exact for ints, 1e-3 for fp32 values, 1e-2 for
bf16), with an optional multiplier for deep-network drift, plus the
"shortened" corner-compare mode that checks only the 6 leading/trailing
elements per dimension — letting golden data be pasted straight from
PyTorch's elided printouts.
"""

from __future__ import annotations

import numpy as np

THRESHOLD_EXACT = 0.0
THRESHOLD_F32 = 1e-3
THRESHOLD_BF16 = 1e-2

_CORNER = 3  # PyTorch prints 3 leading + 3 trailing elements per dim


def threshold_for(dtype) -> float:
    dtype = np.dtype(dtype) if not str(dtype) == "bfloat16" else dtype
    name = str(dtype)
    if name in ("bfloat16", "float16"):
        return THRESHOLD_BF16
    if name in ("float32", "float64"):
        return THRESHOLD_F32
    return THRESHOLD_EXACT


def compare_tensor(actual, expected, dtype=None, tolerance_multiplier: float = 1.0,
                   shortened: bool = False) -> None:
    """Assert ``actual ≈ expected`` under the dtype's threshold.

    ``shortened=True`` compares only the corner elements of each dimension
    (both arrays must then have matching corner layouts — i.e. the expected
    data was transcribed from an elided printout).
    """
    actual = np.asarray(actual, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    if actual.shape != expected.shape and not shortened:
        raise AssertionError(f"shape mismatch: {actual.shape} vs {expected.shape}")
    tol = threshold_for(dtype if dtype is not None else "float32")
    tol *= tolerance_multiplier
    if shortened:
        actual = _corners(actual)
        expected = _corners(expected)
        if actual.shape != expected.shape:
            raise AssertionError(
                f"corner shape mismatch: {actual.shape} vs {expected.shape}")
    if tol == 0.0:
        np.testing.assert_array_equal(actual, expected)
    else:
        np.testing.assert_allclose(actual, expected, atol=tol, rtol=tol)


def _corners(arr: np.ndarray) -> np.ndarray:
    for axis in range(arr.ndim):
        if arr.shape[axis] > 2 * _CORNER:
            head = np.take(arr, range(_CORNER), axis=axis)
            tail = np.take(arr, range(arr.shape[axis] - _CORNER, arr.shape[axis]),
                           axis=axis)
            arr = np.concatenate([head, tail], axis=axis)
    return arr
