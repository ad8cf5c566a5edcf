"""The one traffic generator: it reads a traffic file's parameters and
gives every seed the same amount of work in another order.

* ``client: "offline"`` — batches of ``batch`` images taken in turn from a
  pool of ``pool_batches`` seeded batches; ``ahead`` batches issued before
  the oldest is read back.
* ``client: "open_loop"`` — single images arriving as a Poisson process:
  the gaps between arrivals are the quantiles ``(i + ½) / n`` of the
  exponential law of mean ``1 / rate_per_s``, scaled so that the ``n =
  rate · seconds`` arrivals fill the window, in one shuffled order that every seed shares,
  rotated by an offset drawn from the seed.  A queue's tail depends on how
  the short gaps cluster, so every seed meets the same bursts, at other
  times of the window.  Each request takes an image of a pool of
  ``image_pool`` seeded images, the index drawn from the seed.
"""
from __future__ import annotations

import numpy as np


def gap_quantiles(n: int) -> np.ndarray:
    """The ``n`` mid quantiles of the exponential law of mean 1."""
    return -np.log1p(-(np.arange(n, dtype=np.float64) + 0.5) / n)


def arrivals(rate_per_s: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start, ascending) of the
    ``round(rate · seconds)`` requests of the window; the last is due at
    ``seconds``."""
    n = max(1, int(round(rate_per_s * seconds)))
    gaps = gap_quantiles(n)
    gaps = np.random.default_rng([n, 1]).permutation(
        gaps * (seconds / gaps.sum()))
    shift = int(np.random.default_rng([int(seed), 1]).integers(n))
    return np.cumsum(np.roll(gaps, shift))


def image_indices(n: int, pool: int, seed: int) -> np.ndarray:
    """The pool image each of ``n`` requests sends."""
    return np.random.default_rng([int(seed), 2]).integers(0, pool, n)


def sample(n: int, k: int, seed: int) -> np.ndarray:
    """``k`` of ``range(n)`` (all if fewer), drawn from the seed, sorted."""
    rng = np.random.default_rng([int(seed), 3])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))
