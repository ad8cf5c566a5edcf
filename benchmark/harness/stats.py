"""Order statistics as the benchmark reports them."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q ≤ 100): the smallest
    value with at least q% of the values at or below it.  A value of
    ``inf`` (a request that failed or never came back) counts as later
    than any other."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median, as
    ``statistics.quantiles(values, n=4)`` gives the quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
