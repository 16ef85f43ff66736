"""End-to-end arithmetic over a measured window: a rate over all the work and
all the time of the window, and percentiles over all of its requests."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all `values`: the
    smallest value at or above which lie at least (100 - q)% of them."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def rate(amounts, starts, ends) -> float:
    """Sum of `amounts` over the wall time from the first start to the last
    end."""
    return sum(amounts) / (max(ends) - min(starts))

