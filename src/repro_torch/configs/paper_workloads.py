"""The paper's own sampling workloads (Table 1 / Fig. 12 distributions).

A numpy copy of the JAX package's module. All weights are normalized in
float64 on the host (high dynamic range overflows float32 before
normalization).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.cdf import normalize_weights


def dist_i20(n: int = 256) -> np.ndarray:
    return normalize_weights(np.arange(1, n + 1, dtype=np.float64) ** 20)


def dist_mod32(n: int = 256) -> np.ndarray:
    return normalize_weights((np.arange(n) % 32 + 1.0) ** 25)


def dist_mod64(n: int = 256) -> np.ndarray:
    return normalize_weights((np.arange(n) % 64 + 1.0) ** 35)


def dist_4spikes(n: int = 256) -> np.ndarray:
    w = np.full(n, 0.2 / (n - 4), np.float64)
    idx = np.linspace(0, n, 5, dtype=np.int64)[:-1] + n // 8
    w[idx] = 0.2
    return normalize_weights(w)


def env_map_2d(h: int = 256, w: int = 512, seed: int = 0) -> np.ndarray:
    """Synthetic HDR environment map: smooth base + bright sun spots
    (stands in for the paper's copyrighted openfootage.net image)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.3 + 0.2 * np.sin(xx / w * 2 * np.pi) * np.cos(yy / h * np.pi)
    img = base
    for _ in range(6):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        amp = 10 ** rng.uniform(1.5, 4)
        sig = rng.uniform(1.0, 6.0)
        img = img + amp * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig**2)))
    return (img / img.sum()).astype(np.float64)


TABLE1 = {
    "i^20": dist_i20,
    "(i mod 32 + 1)^25": dist_mod32,
    "(i mod 64 + 1)^35": dist_mod64,
    "4 spikes": dist_4spikes,
}
