"""Data-mixture sampling via the radix tree forest: the paper's amortized
workload, ONE static distribution (corpus weights) and many draws.

The forest over the corpus weights is built once on ``device`` (kernels
``cdf_scan`` and ``forest_delta``); every training batch then draws its
per-sequence corpus ids by Algorithm 2 (kernel ``forest_sample``) at the
points of a base-2 radical-inverse sequence with a Cranley-Patterson
rotation (or at seeded uniforms). The points are made on the host in numpy
exactly as the JAX package makes them, so on weights whose CDF is exact
(the default, dyadic) the ids equal the JAX package's id for id.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import build_forest, sample_forest
from repro_torch.core.cdf import normalize_weights, updated_weights
from repro_torch.core.lds import radical_inverse_base2
from repro_torch.core.sample import PackedForestHolder
from repro_torch.device import resolve, to_device


class MixtureSampler(PackedForestHolder):
    def __init__(self, weights, m: int | None = None, seed: int = 0,
                 sharded: bool = False, device="cuda"):
        if sharded:
            raise NotImplementedError(
                "MixtureSampler(sharded=True): the cell-partitioned forest "
                "(repro.dist.forest) is not ported yet (ROADMAP A7)")
        self.device = resolve(device)
        self._raw = np.asarray(weights, np.float64)
        self.weights = normalize_weights(self._raw)
        m = m or max(len(self.weights), 16)
        self.forest = build_forest(self.weights, m, device=self.device)
        # Cranley-Patterson rotation so different runs decorrelate while
        # keeping the sequence's low discrepancy.
        self.offset = np.float32(np.random.default_rng(seed).random())

    def update_weights(self, weights=None, *, delta=None) -> None:
        """Re-target the mixture (curriculum shifts, corpus swaps): new full
        weights, or a delta added to the current raw weights; the forest is
        rebuilt. ``sample`` stays deterministic in (step, n)."""
        self._raw, self.weights = updated_weights(self._raw, weights, delta=delta)
        self.forest = build_forest(self.weights, self.forest.m, device=self.device)

    def sample(self, step: int, n: int, qmc: bool = True) -> np.ndarray:
        """Corpus index (int32) for each of ``n`` sequences of global batch
        ``step``. Deterministic in (step, n): restart-safe."""
        start = np.uint32(step * n)
        idx = np.arange(n, dtype=np.uint32) + start
        if qmc:
            xi = (radical_inverse_base2(idx) + self.offset) % 1.0
        else:
            xi = np.random.default_rng(step).random(n)
        xi = to_device(np.asarray(xi, np.float32), self.device)
        return sample_forest(self.forest, xi, device=self.device,
                             packed=self._packed).cpu().numpy()
