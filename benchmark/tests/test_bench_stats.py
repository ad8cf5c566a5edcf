"""Percentiles over all requests, failures infinitely late; spreads."""
import math
import statistics

from benchmark.harness.stats import percentile, spread


def test_nearest_rank_percentiles():
    xs = list(range(1, 101))
    assert percentile(xs, 50) == 50
    assert percentile(xs, 95) == 95
    assert percentile(xs, 100) == 100
    assert percentile([7.0], 95) == 7.0


def test_failures_count_as_infinitely_late():
    xs = [1.0] * 94 + [math.inf] * 6
    assert percentile(xs, 50) == 1.0
    assert percentile(xs, 95) == math.inf
    assert percentile([1.0] * 96 + [math.inf] * 4, 95) == 1.0


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 10.2, 9.9, 10.1, 10.0, 10.3]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert spread(xs) == (q3 - q1) / med
