"""KL-divergence (entropy) calibration: the TensorRT-style threshold search
(the port's own copy of qtpu/calib/kl.py, numpy on the host).

Given a 2048-bin histogram of |activation| collected on the device
(:func:`qtpu_torch.calib.observers.hist_update`), find the clipping
threshold T whose int8 (or int4) quantization of the distribution
minimizes KL(P ‖ Q).  The search runs once per layer, after calibration,
on the host.

Algorithm (per candidate bin count ``i`` in [target, nbins]):
1. P = counts[:i], with the outlier mass sum(counts[i:]) added to P[-1].
2. Q = P merged into ``target`` coarse levels, each level's mass spread
   uniformly back over the *nonzero* fine bins it covers.
3. Score KL(P ‖ Q); the best ``i`` gives T = (i + 0.5) * bin_width.

Every candidate from 2^(bits-1) to nbins is scored, as qtpu scores them
(its ``stride=1``), so the thresholds are qtpu's.
"""
from __future__ import annotations

import numpy as np


def _kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """KL(p ‖ q) over bins where p > 0 (natural log), distributions normalized.

    Matches ``scipy.stats.entropy(p, q)`` for the inputs produced by the search
    (q > 0 wherever p > 0 by construction).
    """
    psum = p.sum()
    qsum = q.sum()
    if psum <= 0 or qsum <= 0:
        return float("inf")
    p = p / psum
    q = q / qsum
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] / q[mask])))


def _smooth(d: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Move ``eps`` mass from nonzero bins onto zero bins so KL stays finite.

    Standard trick from TensorRT-style calibrators: P can have mass in a bin
    (e.g. the outlier bin) where Q has none; smoothing both keeps KL(P‖Q)
    well-defined without materially moving the argmin.
    """
    d = d.astype(np.float64)
    n_zero = int(np.count_nonzero(d == 0))
    n_nonzero = d.size - n_zero
    if n_zero == 0 or n_nonzero == 0:
        return d
    eps1 = eps * n_zero / n_nonzero
    out = d.copy()
    out[d == 0] = eps
    out[d != 0] = d[d != 0] - eps1
    return out


def _quantize_distribution(p: np.ndarray, target: int) -> np.ndarray:
    """Merge len(p) fine bins into ``target`` levels and expand back uniformly.

    Vectorized with ``np.add.reduceat`` — called ~2k times per layer by the
    threshold scan, so the O(target) Python loop version is too slow.
    """
    n = len(p)
    edges = np.linspace(0, n, target + 1).astype(np.int64)
    starts = edges[:-1]
    nonzero = p > 0
    sums = np.add.reduceat(p, starts)
    nnz = np.add.reduceat(nonzero.astype(np.float64), starts)
    level_val = np.divide(sums, np.maximum(nnz, 1.0))
    group_of_bin = np.searchsorted(edges, np.arange(n), side="right") - 1
    return np.where(nonzero, level_val[group_of_bin], 0.0)


def kl_threshold(counts: np.ndarray, amax: float, bits: int = 8) -> float:
    """Optimal symmetric clipping threshold from an |x| histogram.

    Args:
      counts: (nbins,) histogram of |x| over [0, amax].
      amax: upper edge of the histogram range.
      bits: integer bit-width; the distribution is merged to 2^(bits-1) levels
        (positive half of the symmetric grid).

    Returns the threshold T (0 < T <= amax); callers convert it to a scale via
    ``qtpu_torch.ops.fakequant.symmetric_scale(T, bits)``.
    """
    counts = np.asarray(counts, np.float64)
    nbins = len(counts)
    total = counts.sum()
    if total <= 0 or amax <= 0:
        return float(amax) if amax > 0 else 1.0
    target = 2 ** (bits - 1)
    if nbins <= target:
        return float(amax)
    bin_width = amax / nbins

    best_kl = np.inf
    best_i = nbins
    for i in range(target, nbins + 1):
        p = counts[:i].copy()
        outliers = counts[i:].sum()
        if p.sum() == 0 and outliers == 0:
            # no |x| mass at all up to (or beyond) this candidate —
            # degenerate distribution, skip (equivalent to the previous
            # compound guard, stated directly)
            continue
        p[-1] += outliers
        q = _quantize_distribution(counts[:i], target)
        if q.sum() == 0:
            continue
        kl = _kl_divergence(_smooth(p), _smooth(q))
        if kl < best_kl:
            best_kl = kl
            best_i = i
    if not np.isfinite(best_kl):
        return float(amax)
    return float(min((best_i + 0.5) * bin_width, amax))
