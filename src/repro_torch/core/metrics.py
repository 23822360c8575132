"""Uniformity, convergence and goodness-of-fit metrics of the QMC
experiments (Figs. 7-9): numpy copies of the JAX package's metrics."""
from __future__ import annotations

import numpy as np


def star_discrepancy_1d(x: np.ndarray) -> float:
    """Exact 1-D star discrepancy in O(N log N) (Niederreiter)."""
    x = np.sort(np.asarray(x, np.float64))
    n = len(x)
    i = np.arange(1, n + 1)
    return float(np.maximum(i / n - x, x - (i - 1) / n).max())


def quadratic_error(counts: np.ndarray, p: np.ndarray) -> float:
    """Fig. 9's metric: sum_i (c_i / N - p_i)^2."""
    c = np.asarray(counts, np.float64)
    n = c.sum()
    return float(np.sum((c / n - np.asarray(p, np.float64)) ** 2))


def histogram(indices: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(np.asarray(indices, np.int64), minlength=n)[:n]


def chi2_statistic(counts: np.ndarray, p: np.ndarray) -> float:
    """Pearson chi^2 against expected N*p (guarded for tiny expectations)."""
    c = np.asarray(counts, np.float64)
    e = np.asarray(p, np.float64) * c.sum()
    mask = e > 1e-12
    return float(np.sum((c[mask] - e[mask]) ** 2 / e[mask]))


def warped_uniformity_1d(xi: np.ndarray, idx: np.ndarray, cdf: np.ndarray) -> float:
    """Star discrepancy of samples re-flattened through the true CDF.

    Mapping each sample back to (cdf[i] + its offset within the interval)
    reproduces the input uniforms for the inversion method and scrambles
    them for the Alias Method: Fig. 1's 'unwarping' argument."""
    xi = np.asarray(xi, np.float64)
    idx = np.asarray(idx, np.int64)
    lo, hi = cdf[idx], cdf[idx + 1]
    width = np.maximum(hi - lo, 1e-30)
    frac = np.clip((xi - lo) / width, 0.0, 1.0)
    flattened = lo + frac * width  # == xi for a monotone inverse
    return star_discrepancy_1d(flattened)
