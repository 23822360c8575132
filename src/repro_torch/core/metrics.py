"""Goodness-of-fit helpers (numpy copies of the JAX package's metrics)."""
from __future__ import annotations

import numpy as np


def histogram(indices: np.ndarray, n: int) -> np.ndarray:
    return np.bincount(np.asarray(indices, np.int64), minlength=n)[:n]


def chi2_statistic(counts: np.ndarray, p: np.ndarray) -> float:
    """Pearson chi^2 against expected N*p (guarded for tiny expectations)."""
    c = np.asarray(counts, np.float64)
    e = np.asarray(p, np.float64) * c.sum()
    mask = e > 1e-12
    return float(np.sum((c[mask] - e[mask]) ** 2 / e[mask]))
