"""Shared-distribution serving sampler with per-slot QMC uniform streams.

:class:`QmcStreams` is the numpy stream oracle (the exact 24-bit fixed-point
pipeline of :mod:`repro_torch.core.lds`; same seed => bit-equal points and
counters to the JAX package's). :class:`ForestSampler` builds the radix
forest once on its device and inverts the CDF at the slots' stream points
(monotone warp, so the stratification survives).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cdf import normalize_weights, updated_weights
from repro_torch.core.forest import build_forest
from repro_torch.core.lds import QMC_SCALE, qmc_bits24_np, qmc_offset_bits_np
from repro_torch.core.sample import sample_forest
from repro_torch.device import resolve


class QmcStreams:
    """Per-slot low-discrepancy uniform streams with Cranley-Patterson
    rotations (slot-hash offsets keep slots decorrelated but stratified)."""

    def __init__(self, n_slots: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.offset_bits = qmc_offset_bits_np(rng.random(n_slots))
        self.offsets = self.offset_bits.astype(np.float32) * QMC_SCALE
        self.counters = np.zeros(n_slots, np.uint32)

    def next(self, slots: np.ndarray | None = None) -> np.ndarray:
        """One stream point per requested slot occurrence. A slot repeated
        k times in one call draws its next k distinct stream points (the
        j-th occurrence, in call order, at counter+j) and its counter
        advances by k."""
        if slots is None:
            slots = np.arange(len(self.offset_bits))
        slots = np.asarray(slots)
        rank = _occurrence_rank_np(slots)
        xi = qmc_bits24_np(
            self.counters[slots] + rank, self.offset_bits[slots]
        ).astype(np.float32) * QMC_SCALE
        np.add.at(self.counters, slots, 1)
        return xi

    def snapshot(self) -> dict:
        """Exact stream state (offset bits + counters)."""
        return dict(kind="qmc_streams",
                    offset_bits=self.offset_bits.copy(),
                    counters=self.counters.copy())

    @classmethod
    def restore(cls, state: dict) -> "QmcStreams":
        s = cls.__new__(cls)
        s.offset_bits = np.asarray(state["offset_bits"], np.uint32).copy()
        s.offsets = s.offset_bits.astype(np.float32) * QMC_SCALE
        s.counters = np.asarray(state["counters"], np.uint32).copy()
        return s


def _occurrence_rank_np(slots: np.ndarray) -> np.ndarray:
    """Per-occurrence rank of each slot within one call (call order): the
    j-th occurrence of a slot gets rank j. Stable sort + searchsorted."""
    order = np.argsort(slots, kind="stable")
    sorted_slots = slots[order]
    first = np.searchsorted(sorted_slots, sorted_slots, side="left")
    rank = np.empty(len(slots), np.uint32)
    rank[order] = (np.arange(len(slots)) - first).astype(np.uint32)
    return rank


class ForestSampler:
    """Shared-distribution serving sampler: ONE static distribution (draft
    prior, data mixture, env-map row), many draws per step.

    Builds the radix forest once on ``device``; every :meth:`sample` call
    inverts the CDF at the slots' QMC stream points through the
    ``forest_sample`` kernel. :meth:`update_weights` swaps the distribution
    in place and the slot streams continue uninterrupted."""

    def __init__(self, weights, m: int | None = None, sharded: bool = False,
                 n_slots: int = 64, seed: int = 0, device="cuda"):
        if sharded:
            raise NotImplementedError(
                "sharded ForestSampler is not ported yet (ROADMAP item A7)")
        self.device = resolve(device)
        self._raw = np.asarray(weights, np.float64)
        w = normalize_weights(self._raw)
        m = m or max(len(w), 16)
        self.streams = QmcStreams(n_slots, seed)
        self.forest = build_forest(w, m, device=self.device)

    @classmethod
    def from_state(cls, forest_numpy: dict, streams_state: dict,
                   device="cuda") -> "ForestSampler":
        """A sampler over an existing forest and stream state, both plain
        numpy: the dict of ``forest_to_numpy`` (of either package) and a
        ``QmcStreams.snapshot()``. Later draws equal the source sampler's.
        The raw weights for delta updates are the forest's interval widths."""
        from repro_torch.interop import forest_from_numpy

        s = cls.__new__(cls)
        s.device = resolve(device)
        s.forest = forest_from_numpy(forest_numpy, s.device)
        s._raw = np.diff(np.asarray(forest_numpy["cdf"], np.float64))
        s.streams = QmcStreams.restore(streams_state)
        return s

    def update_weights(self, weights=None, *, delta=None) -> None:
        """In-place distribution update (new full weights, or a delta added
        to the current raw weights); slot streams keep their counters."""
        self._raw, w = updated_weights(self._raw, weights, delta=delta)
        self.forest = build_forest(w, self.forest.m, device=self.device)

    def sample(self, slots: np.ndarray) -> np.ndarray:
        xi = self.streams.next(slots)
        idx = sample_forest(self.forest, xi, device=self.device)
        return idx.cpu().numpy()
