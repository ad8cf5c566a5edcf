"""The generator gives every seed the same work in another order."""
import numpy as np

from benchmark.harness import traffic


def test_arrivals_are_deterministic_and_fill_the_window():
    a = traffic.arrivals(100.0, 10.0, seed=2**31 + 7)
    b = traffic.arrivals(100.0, 10.0, seed=2**31 + 7)
    assert np.array_equal(a, b)
    assert len(a) == 1000 and np.all(np.diff(a) > 0)
    assert abs(a[-1] - 10.0) < 1e-9


def test_seeds_share_the_gaps_in_another_order():
    a = traffic.arrivals(100.0, 10.0, seed=1)
    b = traffic.arrivals(100.0, 10.0, seed=2)
    assert not np.array_equal(a, b)
    ga = np.sort(np.diff(np.concatenate([[0.0], a])))
    gb = np.sort(np.diff(np.concatenate([[0.0], b])))
    assert np.allclose(ga, gb)


def test_poisson_gaps():
    g = traffic.gap_quantiles(20000)
    assert abs(g.mean() - 1.0) < 0.01 and abs(g.std() - 1.0) < 0.02


def test_images_and_samples_come_from_the_seed():
    assert np.array_equal(traffic.image_indices(50, 8, 3),
                          traffic.image_indices(50, 8, 3))
    s = traffic.sample(1000, 256, 9)
    assert len(set(s.tolist())) == 256 and np.array_equal(
        s, traffic.sample(1000, 256, 9))
    assert traffic.sample(3, 256, 9).tolist() == [0, 1, 2]
