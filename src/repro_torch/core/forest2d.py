"""Simultaneous multi-row forest construction (paper Sec. 5).

"Building multiple tables and trees simultaneously, e.g. for two-dimensional
distributions, is as simple as adding yet another criterion to the extended
check in Algorithm 1": a flat entry (row r, interval j) lives in guide cell
``r*m + floor(cdf_r[j]*m)``, so a row boundary changes the cell id and
clamps the separator distance to the sentinel. One data-parallel pass builds
every row tree of an (R, W) stack of CDFs.

That pass is :func:`repro_torch.core.forest.forest_from_cdf` on the stack
(``cdf_scan`` made the CDFs, the ``forest_delta`` kernel the distances, the
sentinel at every row end), whose references are row-local;
:func:`build_forest_rows` rewrites them to the flat global references of the
JAX package's layout (:class:`RowForest`). Row ``r`` carries exactly the
arrays of an independent build over that row's CDF, fallback flags
included, so rows never interact: a dirty subset of rows rebuilds and
scatters into a stack bit-equal to a from-scratch build.

:func:`sample_forest_rows` resolves (row, uniform) lanes on the card with one
``forest_sample_batched`` launch over the row-local view of the flat forest,
comparing against the clamped lower bounds as the JAX package does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import to_device
from repro_torch.kernels.forest_sample import forest_sample_batched

from .cdf import lower_bounds
from .forest import INVALID, forest_from_cdf


class RowForest(NamedTuple):
    data: torch.Tensor        # (R*W,) f32 flat lower bounds (per-row CDFs)
    table: torch.Tensor       # (R*m,) i32
    left: torch.Tensor        # (R*W,) i32
    right: torch.Tensor       # (R*W,) i32
    cell_first: torch.Tensor  # (R*m + 1,) i32 flat first-overlap per cell
    rows: int
    width: int
    m: int
    fallback: torch.Tensor | None = None  # (R*m,) bool degenerate (row, cell)


def _shift(v: torch.Tensor, off: torch.Tensor, sign: int) -> torch.Tensor:
    """Move references by ``sign * off`` per row: a node id ``v >= 0`` by
    ``+sign*off``, a leaf ``~i`` by ``-sign*off`` (``~(i + o) = ~i - o``).
    ``INVALID`` stays as it is."""
    w = v.to(torch.int64)
    moved = torch.where(w >= 0, w + sign * off, w - sign * off)
    return torch.where(w == INVALID, w, moved).to(torch.int32)


def build_forest_rows(cdf_rows, m: int, fallback_slack: int = 2,
                      device="cuda") -> RowForest:
    """cdf_rows (R, W+1) per-row CDFs -> all R forests in one pass, in the
    flat global layout; bit-equal to the JAX package's
    ``build_forest_rows`` given the same CDF bits."""
    cdf = to_device(cdf_rows, device, torch.float32)
    R, W = cdf.shape[0], cdf.shape[1] - 1
    f = forest_from_cdf(cdf, m, fallback_slack, device=cdf.device)
    return _to_global(f, R, W, m)


def _to_global(f, R: int, W: int, m: int) -> RowForest:
    """A row-local stacked forest (fields with a leading R axis) as a
    :class:`RowForest`."""
    off = (torch.arange(R, dtype=torch.int64, device=f.cdf.device) * W)[:, None]
    cf = f.cell_first[:, :m].to(torch.int64) + off
    cell_first = F.pad(cf.reshape(-1), (0, 1), value=R * W - 1).to(torch.int32)
    return RowForest(
        data=lower_bounds(f.cdf).reshape(-1).contiguous(),
        table=_shift(f.table, off, 1).reshape(-1),
        left=_shift(f.left, off, 1).reshape(-1),
        right=_shift(f.right, off, 1).reshape(-1),
        cell_first=cell_first, rows=R, width=W, m=m,
        fallback=f.fallback.reshape(-1),
    )


def row_local(f: RowForest, cdf_rows: torch.Tensor | None = None):
    """The row-local stacked view of a :class:`RowForest`: the fields of a
    ``BatchedForest`` (cdf, table, left, right, cell_first, fallback), each
    with a leading R axis. ``cdf_rows`` is the (R, W+1) CDF stack the forest
    was built from; without it the view compares against the clamped lower
    bounds (``data`` with a 1.0 appended a row), as the JAX package's
    :func:`sample_forest_rows` does."""
    R, W, m = f.rows, f.width, f.m
    dev = f.data.device
    off = (torch.arange(R, dtype=torch.int64, device=dev) * W)[:, None]
    if cdf_rows is None:
        cdf_rows = F.pad(f.data.view(R, W), (0, 1), value=1.0)
    cell_first = F.pad(f.cell_first[:-1].view(R, m).to(torch.int64) - off, (0, 1),
                       value=W - 1).to(torch.int32)
    return (cdf_rows, _shift(f.table.view(R, m), off, -1),
            _shift(f.left.view(R, W), off, -1), _shift(f.right.view(R, W), off, -1),
            cell_first, f.fallback.view(R, m))


def sample_forest_rows(f: RowForest, row, xi) -> torch.Tensor:
    """Column within each lane's row: (rows (B,), xi (B,)) -> column ids (B,)
    int32 on the forest's device, one ``forest_sample_batched`` launch
    (``dist_id`` = row) over the row-local view. Degenerate (row, cell)
    pairs resolve by bisection, the rest by descent."""
    dev = f.data.device
    row = to_device(row, dev, torch.int32)
    xi = to_device(xi, dev, torch.float32)
    return forest_sample_batched(*row_local(f), row, xi)


def validate_forest_rows(f: RowForest) -> None:
    """Structural invariants of the flat multi-row forest; raises
    AssertionError on violation: every guide entry resolves within its row,
    and in-order traversal of a (row, cell) tree enumerates the cell's
    leaves in increasing order behind the row-clamped left-overlap leaf."""
    data = f.data.cpu().numpy()
    table = f.table.cpu().numpy()
    left = f.left.cpu().numpy()
    right = f.right.cpu().numpy()
    R, W, m = f.rows, f.width, f.m
    n = R * W
    local = np.clip(np.floor(data * np.float32(m)).astype(np.int64), 0, m - 1)
    cells = np.repeat(np.arange(R), W) * m + local

    def check(cond, what) -> None:
        if not cond:
            raise AssertionError(what)

    for c in range(R * m):
        r = c // m
        ref = int(table[c])
        leaves = np.where(cells == c)[0]
        if ref < 0:
            i = ~ref
            check(r * W <= i < (r + 1) * W, (c, i))  # never leaves the row
            cell_start = (c % m) / m
            check(data[i] <= cell_start + 1e-7 or (len(leaves) == 1 and leaves[0] == i),
                  (c, i))
            continue
        check(len(leaves) > 0, (c, "tree in an empty cell"))
        got: list[int] = []
        stack = [ref]
        while stack:  # in-order walk: left subtree first
            j = stack.pop()
            check(len(got) + len(stack) < 10_000, (c, "unterminated walk"))
            if j < 0:
                got.append(~j)
                continue
            check(0 <= j < n, (c, j))
            stack.append(int(right[j]))
            stack.append(int(left[j]))
        f0 = int(leaves[0])
        expect = [max(f0 - 1, r * W)] + list(leaves)
        check(got == expect, (c, got, expect))
        check(all(r * W <= i < (r + 1) * W for i in got), (c, got))


def np_reference_rows(cdf_rows: np.ndarray, row: np.ndarray, xi: np.ndarray):
    """searchsorted oracle per lane."""
    out = np.empty(len(xi), np.int64)
    for i, (r, u) in enumerate(zip(row, xi)):
        out[i] = np.clip(
            np.searchsorted(cdf_rows[r][1:], u, side="right"),
            0, cdf_rows.shape[1] - 2,
        )
    return out
