"""The Alias Method (Walker 1974/1977, Vose build): the paper's antagonist
and the pool's O(1) serving path for PRNG tenants.

O(1) worst-case sampling through a **non-monotone** map, so QMC tenants
stay on the forest path. This module holds the single-distribution host
builds (numpy), the numpy samplers that serve as oracles, and
:func:`sample_alias` on tensors. The batched split-and-pack build and the
batched drain are kernels (:mod:`repro_torch.kernels.alias_build`,
:mod:`repro_torch.kernels.alias_sample`).

Sampling edge: a float64 uniform just below 1 rounds to ``1.0`` in
float32, so ``scaled = xi * n`` lands on ``n`` and the clipped last cell
would see ``frac == 1.0``; ``frac`` is clamped into ``[0, 1)`` so the limit
draw behaves as ``xi -> 1^-``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import to_device

# Largest float32 / float64 strictly below 1: the upper clamp for the
# within-cell fraction, so `frac < q` stays meaningful for q == 1 cells.
ALIAS_FRAC_MAX = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))
_ALIAS_FRAC_MAX64 = np.nextafter(1.0, 0.0)


class AliasTable(NamedTuple):
    q: torch.Tensor      # (n,) f32 split point within each cell
    alias: torch.Tensor  # (n,) i32 second interval of each cell


def _table(q: np.ndarray, alias: np.ndarray, device) -> AliasTable:
    return AliasTable(to_device(q.astype(np.float32), device),
                      to_device(alias.astype(np.int32), device))


def build_alias(weights: np.ndarray, device="cuda") -> AliasTable:
    """Vose's O(n) stable build (serial, as the paper notes), on the host."""
    w = np.asarray(weights, np.float64)
    n = len(w)
    p = w / w.sum() * n
    q = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        q[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    for rest in (small, large):
        while rest:
            q[rest.pop()] = 1.0
    return _table(q, alias, device)


def build_alias_parallel(weights, device="cuda") -> AliasTable:
    """Data-parallel alias construction on the host (prefix sums and
    searchsorteds, float64).

    Lights (``n*p < 1``) demand deficits on a tape (prefix D), heavies
    supply surpluses (prefix S). A light's alias is the heavy whose supply
    interval holds the start of its demand; a heavy whose supply ends inside
    a light's demand owes the remainder to the next heavy with surplus.
    Zero-surplus heavies (``n*p == 1``) owe nothing and are skipped by the
    strictly-greater searches, so exact dyadic weights pack bit for bit like
    the batched kernel."""
    w = np.asarray(weights, np.float64)
    n = len(w)
    npi = w / w.sum() * n
    light = npi < 1.0
    lights = np.where(light)[0]
    heavies = np.where(~light)[0]
    q = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    if len(lights) and len(heavies):
        D = np.cumsum(1.0 - npi[lights])          # demand prefix
        S = np.cumsum(npi[heavies] - 1.0)         # supply prefix
        total = min(D[-1], S[-1])
        starts = np.concatenate([[0.0], D[:-1]])
        k = np.clip(np.searchsorted(S, starts, side="right"), 0, len(heavies) - 1)
        q[lights] = npi[lights]
        alias[lights] = heavies[k]
        surplus = npi[heavies] - 1.0
        x = S  # supply end per heavy
        j = np.searchsorted(D, x, side="left")    # light whose interval has x
        inside = (j < len(D)) & (x < total) & (surplus > 0.0)
        Dj = D[np.clip(j, 0, len(D) - 1)]
        debt = np.clip(np.where(inside, Dj - x, 0.0), 0.0, 1.0)
        nxt = np.clip(np.searchsorted(S, x, side="right"), 0, len(heavies) - 1)
        q[heavies] = 1.0 - debt
        alias[heavies] = np.where(debt > 0, heavies[nxt], heavies)
    return _table(q, alias, device)


def sample_alias(t: AliasTable, xi: torch.Tensor) -> torch.Tensor:
    """One load of (q, alias) and one comparison a lane, in float32 on the
    table's device; non-monotone in xi."""
    n = t.q.shape[0]
    xi = xi.to(device=t.q.device, dtype=torch.float32)
    scaled = xi * float(n)
    cell = torch.clamp(scaled.to(torch.int32), 0, n - 1)
    frac = torch.clamp(scaled - cell.to(torch.float32), 0.0, float(ALIAS_FRAC_MAX))
    cl = cell.long()
    return torch.where(frac < t.q[cl], cell, t.alias[cl]).to(torch.int32)


def np_sample_alias(q: np.ndarray, alias: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """Host twin of :func:`sample_alias` in float64 (same last-cell clamp)."""
    n = len(q)
    scaled = np.asarray(xi, np.float64) * n
    cell = np.clip(scaled.astype(np.int64), 0, n - 1)
    frac = np.clip(scaled - cell, 0.0, _ALIAS_FRAC_MAX64)
    return np.where(frac < q[cell], cell, alias[cell])


def np_sample_alias_f32(q: np.ndarray, alias: np.ndarray,
                        xi: np.ndarray) -> np.ndarray:
    """Numpy oracle with the device drain's float32 arithmetic (same
    multiply, truncation and clamp), so the batched alias kernel can be
    held to it elementwise."""
    n = len(q)
    scaled = np.asarray(xi, np.float32) * np.float32(n)
    cell = np.clip(scaled.astype(np.int32), 0, n - 1)
    frac = np.clip(scaled - cell.astype(np.float32),
                   np.float32(0.0), ALIAS_FRAC_MAX)
    return np.where(frac < np.asarray(q, np.float32)[cell],
                    cell, alias[cell]).astype(np.int32)
