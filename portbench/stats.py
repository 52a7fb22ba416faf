"""Statistics of a measured window: every tick counts, none is dropped."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of all values, nearest rank: the
    smallest value with at least q% of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return float(v[k - 1])


def rate(work: float, seconds: float) -> float:
    """Work over the whole window's wall time."""
    if seconds <= 0:
        raise ValueError("the window has no length")
    return work / seconds
