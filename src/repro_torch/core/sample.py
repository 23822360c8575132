"""Inverse-CDF samplers: the paper's Algorithm 2 and its baselines.

Every sampler takes ``device=`` (default ``"cuda"``) and computes there,
moving its inputs if they lie elsewhere. :func:`sample_forest` runs the
hand-written ``forest_sample`` kernel on the card; the other samplers are
plain PyTorch on either device.
"""
from __future__ import annotations

import torch

from repro_torch.device import to_device
from repro_torch.kernels.forest_sample import (
    PACK_MAX_N,
    PackedForest,
    forest_pack,
    forest_sample,
)

from .forest import MAX_DEPTH, RadixForest


def _guide_cell(xi: torch.Tensor, m: int) -> torch.Tensor:
    """clip(floor(xi * m), 0, m-1) in float32, as int64 indices."""
    g = torch.floor(xi * float(m)).to(torch.int32)
    return torch.clamp(g, 0, m - 1).to(torch.int64)


def _on(device, *arrays) -> list[torch.Tensor]:
    """The arrays as tensors on ``device``, floating ones as float32."""
    out = [to_device(a, device) for a in arrays]
    return [a.to(torch.float32) if a.is_floating_point() else a for a in out]


def sample_linear(cdf, xi, device="cuda") -> torch.Tensor:
    """O(n) linear scan (Sec. 2.1). For small n / reference only."""
    cdf, xi = _on(device, cdf, xi)
    # i = #{k : cdf[k+1] <= xi}
    return (cdf[1:-1][None, :] <= xi[:, None]).sum(-1).to(torch.int32)


def sample_binary(cdf, xi, device="cuda") -> torch.Tensor:
    """O(log n) bisection (Sec. 2.2)."""
    cdf, xi = _on(device, cdf, xi)
    i = torch.searchsorted(cdf[1:].contiguous(), xi, right=True)
    return torch.clamp(i, 0, cdf.shape[0] - 2).to(torch.int32)


def _bisect(cdf, xi, lo, hi, steps: int) -> torch.Tensor:
    """Find i in [lo, hi] with cdf[i] <= xi < cdf[i+1]; fixed-trip bisection."""
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    for _ in range(steps):
        mid = (lo + hi + 1) >> 1
        ge = xi >= cdf[mid]
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid - 1)
    return lo


def sample_cutpoint_binary(cdf, cell_first, xi, device="cuda") -> torch.Tensor:
    """Cutpoint Method with in-cell binary search (Sec. 2.5)."""
    cdf, cell_first, xi = _on(device, cdf, cell_first, xi)
    g = _guide_cell(xi, cell_first.shape[0] - 1)
    return _bisect(cdf, xi, cell_first[g], cell_first[g + 1], 32).to(torch.int32)


def sample_cutpoint_linear(
    cdf, cell_first, xi, max_scan: int, device="cuda"
) -> torch.Tensor:
    """Cutpoint Method with in-cell linear search (Sec. 2.5, original)."""
    cdf, cell_first, xi = _on(device, cdf, cell_first, xi)
    g = _guide_cell(xi, cell_first.shape[0] - 1)
    i = cell_first[g].to(torch.int64)
    last = cdf.shape[0] - 1
    for _ in range(max_scan):
        done = xi < cdf[torch.clamp(i + 1, 0, last)]
        i = torch.where(done, i, i + 1)
    return i.to(torch.int32)


def pack_forest(forest: RadixForest) -> PackedForest:
    """The layout the ``forest_sample`` kernel reads (``forest_pack``), on
    the forest's device: make it once per forest and pass it to every
    :func:`sample_forest` call on that forest."""
    return forest_pack(forest.cdf, forest.table, forest.left, forest.right, forest.fallback)


class PackedForestHolder:
    """Base of the samplers that hold one forest: setting ``forest`` packs
    it (``_packed``, for :func:`sample_forest`), so no draw reads the pack
    of a forest that was replaced. A forest of ``PACK_MAX_N`` or more
    intervals has no pack (``_packed`` None): the descent reads its six
    arrays."""

    @property
    def forest(self) -> RadixForest:
        return self._forest

    @forest.setter
    def forest(self, forest: RadixForest) -> None:
        self._forest = forest
        self._packed = pack_forest(forest) if forest.n < PACK_MAX_N else None


def sample_forest(
    forest: RadixForest, xi, use_fallback: bool = True, device="cuda",
    packed: PackedForest | None = None,
) -> torch.Tensor:
    """Algorithm 2: guide-table lookup, then radix-tree descent.

    Node index doubles as CDF index: descend left iff ``xi < cdf[j]``. Lanes
    in degenerate cells (``forest.fallback``) use balanced index bisection
    instead: the paper's logarithmic-worst-case guard. ``packed`` is
    :func:`pack_forest` of ``forest`` on ``device``; without it the card packs
    on the way."""
    f, (xi,) = RadixForest(*_on(device, *forest)), _on(device, xi)
    return forest_sample(
        f.cdf, f.table, f.left, f.right, f.cell_first, f.fallback, xi,
        use_fallback=use_fallback, packed=packed)


def sample_forest_with_stats(forest: RadixForest, xi, device="cuda"):
    """As :func:`sample_forest` (without the fallback pre-resolution) but
    also returns per-lane node-visit counts (loads beyond the guide-table
    load): the Table-1 instrumentation."""
    f, (xi,) = RadixForest(*_on(device, *forest)), _on(device, xi)
    n = f.n
    j = f.table[_guide_cell(xi, f.m)].to(torch.int64)
    c = torch.zeros_like(j, dtype=torch.int32)
    left, right = f.left.long(), f.right.long()
    for _ in range(MAX_DEPTH):
        active = j >= 0
        if not bool(active.any()):
            break
        jj = torch.clamp(j, 0, n - 1)
        nxt = torch.where(xi < f.cdf[jj], left[jj], right[jj])
        j = torch.where(active, nxt, j)
        c += active
    return (~j).to(torch.int32), c
