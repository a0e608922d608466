"""Monotone binary search used for SLO-constrained rate sizing.

Semantics match the reference search (the Go reference's pkg/analyzer/utils.go:26-70):
boundary evaluation with relative tolerance, below/above-region indicators,
and a bounded bisection that freezes as soon as the target is within
tolerance. Unlike the reference, the evaluation function is passed state
explicitly (no package-global model handle, utils.go:72-73).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

TOLERANCE = 1e-6
MAX_ITERATIONS = 100

# Region indicators (reference utils.go:44-51).
BELOW_REGION = -1
IN_REGION = 0
ABOVE_REGION = 1


def within_tolerance(x: float, value: float, tolerance: float = TOLERANCE) -> bool:
    """Relative tolerance check (reference utils.go:12-20)."""
    if x == value:
        return True
    if value == 0 or tolerance < 0:
        return False
    return abs((x - value) / value) <= tolerance


@dataclass(frozen=True)
class BinarySearchResult:
    x_star: float
    indicator: int  # BELOW_REGION | IN_REGION | ABOVE_REGION


def binary_search(
    x_min: float,
    x_max: float,
    y_target: float,
    eval_fn: Callable[[float], float],
    tolerance: float = TOLERANCE,
    max_iterations: int = MAX_ITERATIONS,
    increasing: bool | None = None,
) -> BinarySearchResult:
    """Find x* in [x_min, x_max] with eval_fn(x*) ~= y_target.

    eval_fn must be monotone over the range. Raises ValueError for an invalid
    range or if eval_fn raises. Targets outside the bounded region return the
    corresponding boundary with a BELOW_REGION/ABOVE_REGION indicator
    (callers treat BELOW_REGION as infeasible, reference
    queueanalyzer.go:208-215).

    increasing: monotonicity direction when the caller knows it; default
    infers from the boundary evals. A tail probability can be ~0 at BOTH
    boundaries, which would mis-infer 'decreasing' and brand an
    always-satisfiable target infeasible (same forcing as the batched
    path, ops/batched.py _assemble_problem).
    """
    if x_min > x_max:
        raise ValueError(f"invalid range [{x_min}, {x_max}]")

    y_lo = eval_fn(x_min)
    if within_tolerance(y_lo, y_target, tolerance):
        return BinarySearchResult(x_min, IN_REGION)
    y_hi = eval_fn(x_max)
    if within_tolerance(y_hi, y_target, tolerance):
        return BinarySearchResult(x_max, IN_REGION)

    if increasing is None:
        increasing = y_lo < y_hi
    if (increasing and y_target < y_lo) or (not increasing and y_target > y_lo):
        return BinarySearchResult(x_min, BELOW_REGION)
    if (increasing and y_target > y_hi) or (not increasing and y_target < y_hi):
        return BinarySearchResult(x_max, ABOVE_REGION)

    x_star = 0.5 * (x_min + x_max)
    for _ in range(max_iterations):
        x_star = 0.5 * (x_min + x_max)
        y_star = eval_fn(x_star)
        if within_tolerance(y_star, y_target, tolerance):
            break
        if (increasing and y_target < y_star) or (not increasing and y_target > y_star):
            x_max = x_star
        else:
            x_min = x_star
    return BinarySearchResult(x_star, IN_REGION)
