"""Instrumented numpy samplers with exact memory-load counting (Table 1):
a copy of the JAX package's module, reading the port's forests.

Load-accounting model (the paper's):
  * guide-table lookup ............................ 1 load
  * tagged cell (~i, single overlapping interval) . 0 further loads
  * per bisection iteration (one cdf probe) ....... 1 load
  * per radix-tree node visit (children + split
    value, interleaved as the paper suggests) ..... 1 load
``warp_cost`` aggregates per-warp maxima: the cost of 32 lock-stepped lanes
is the slowest lane (the paper's ``average_32`` column).
"""
from __future__ import annotations

import numpy as np

from .forest import RadixForest, forest_to_numpy


def np_sample_binary_counting(cdf: np.ndarray, xi: np.ndarray):
    """Plain bisection over the whole CDF; returns (i, loads)."""
    n = len(cdf) - 1
    lo = np.zeros(len(xi), np.int64)
    hi = np.full(len(xi), n - 1, np.int64)
    loads = np.zeros(len(xi), np.int64)
    while np.any(lo < hi):
        act = lo < hi
        mid = (lo + hi + 1) >> 1
        probe = cdf[np.clip(mid, 0, n)]
        ge = xi >= probe
        loads += act
        lo = np.where(act & ge, mid, lo)
        hi = np.where(act & ~ge, mid - 1, hi)
    return lo, loads


def np_sample_cutpoint_binary_counting(
    cdf: np.ndarray, cell_first: np.ndarray, table: np.ndarray, xi: np.ndarray
):
    """Cutpoint + in-cell bisection with tagged single-interval cells."""
    m = len(cell_first) - 1
    n = len(cdf) - 1
    g = np.clip(np.floor(np.asarray(xi, np.float32) * np.float32(m)).astype(np.int64), 0, m - 1)
    loads = np.ones(len(xi), np.int64)  # the guide-table load
    ref = table[g]
    tagged = ref < 0
    out = np.where(tagged, ~ref, 0).astype(np.int64)

    lo = cell_first[g].astype(np.int64)
    hi = cell_first[g + 1].astype(np.int64)
    act0 = ~tagged
    lo = np.where(act0, lo, 0)
    hi = np.where(act0, hi, 0)
    while np.any((lo < hi) & act0):
        act = (lo < hi) & act0
        mid = (lo + hi + 1) >> 1
        probe = cdf[np.clip(mid, 0, n)]
        ge = xi >= probe
        loads += act
        lo = np.where(act & ge, mid, lo)
        hi = np.where(act & ~ge, mid - 1, hi)
    out = np.where(act0, lo, out)
    return out, loads


def np_sample_forest_counting(forest: RadixForest, xi: np.ndarray):
    """Algorithm 2 with per-lane node-visit counting; returns (i, loads)."""
    fn = forest_to_numpy(forest)
    cdf, table, left, right = fn["cdf"], fn["table"], fn["left"], fn["right"]
    n, m = len(left), len(table)
    g = np.clip(np.floor(np.asarray(xi, np.float32) * np.float32(m)).astype(np.int64), 0, m - 1)
    j = table[g].astype(np.int64)
    loads = np.ones(len(xi), np.int64)  # guide-table load
    guard = 0
    while np.any(j >= 0):
        act = j >= 0
        jj = np.clip(j, 0, n - 1)
        go_left = xi < cdf[jj]
        nxt = np.where(go_left, left[jj], right[jj])
        loads += act
        j = np.where(act, nxt, j)
        guard += 1
        if guard >= 20_000:
            raise RuntimeError("unterminated traversal")
    return ~j, loads


def warp_cost(loads: np.ndarray, warp: int = 32) -> float:
    """Mean over warps of the per-warp max load count (paper's average_32)."""
    k = (len(loads) // warp) * warp
    if k == 0:
        return float(loads.max(initial=0))
    return float(np.asarray(loads[:k]).reshape(-1, warp).max(axis=1).mean())


def table1_row(loads: np.ndarray) -> dict:
    return {
        "maximum": int(loads.max(initial=0)),
        "average": float(loads.mean()),
        "average_32": warp_cost(loads, 32),
    }
