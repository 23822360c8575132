"""Radix tree forests over CDF intervals (Binder & Keller 2019, Sec. 3).

The unit interval is cut into ``m`` guide cells. A cell overlapped by a
single CDF interval stores ``~i`` directly in the guide table. A cell
containing several interval lower bounds stores the index of its root slot
node; the cell's radix tree hangs off that slot's right child, and the
slot's left child is the interval overlapping the cell from the left. Node
``j`` splits at ``cdf[j]``, so nodes store only two child refs (``>= 0``
internal node, ``< 0`` leaf ``~i``).

:func:`forest_from_cdf` builds the forest as the Cartesian (max-)tree over
the separator distances ``delta(k) = bits(data[k]) XOR bits(data[k+1])``
(cell crossings clamped to the sentinel), with parents found in closed form
by an all-nearest-greater-values sparse-table descent: no atomics, and the
same arrays as the JAX package's construction given the same CDF bits. On the
card the distances come from the ``forest_delta`` kernel.
:func:`build_forest_apetrei` is the numpy emulation of the paper's
Algorithm 1 kept as ground truth.

Tie-breaking matches Algorithm 1: L(k) uses strict ``>``, R(k) uses ``>=``,
and the parent is L when ``delta[L] <= delta[R]``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import to_device
from repro_torch.kernels.forest_delta import forest_delta

from .bits import DIST_SENTINEL, np_xor_distance
from .cdf import build_cdf, lower_bounds

INVALID = -(2**31)  # never a legal ref; only in untouched slots
# Radix-tree depth over distinct float32 keys is <= ~34. Tied chains are
# flagged for balanced fallback at build time, so 256 is a safety guard.
MAX_DEPTH = 256
_DEPTH_ITERS = 48  # saturating depth count; anything deeper is flagged anyway


class RadixForest(NamedTuple):
    """Guide table + radix tree forest (+ cutpoint/fallback side tables)."""

    cdf: torch.Tensor         # (n+1,) f32; interval i = [cdf[i], cdf[i+1])
    table: torch.Tensor       # (m,)  i32; >=0 node id, <0 ~interval
    left: torch.Tensor        # (n,)  i32 child refs
    right: torch.Tensor       # (n,)  i32 child refs
    cell_first: torch.Tensor  # (m+1,) i32 first interval overlapping each cell
    fallback: torch.Tensor    # (m,)  bool; degenerate cell -> balanced bisection

    @property
    def n(self) -> int:
        return self.left.shape[0]

    @property
    def m(self) -> int:
        return self.table.shape[0]


def _cells(data: torch.Tensor, m: int) -> torch.Tensor:
    """Guide cell of each lower bound (int64); float32 math as traversal."""
    c = torch.floor(data * float(m)).to(torch.int32)
    return torch.clamp(c, 0, m - 1).to(torch.int64)


def _block_max_table(d: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """T[j][s] = max d[s : s+2^j] (out of range = 0, neutral for uint)."""
    tables = [d]
    cur = d
    for j in range(levels):
        shift = 1 << j
        shifted = torch.cat(
            [cur[shift:], cur.new_zeros(min(shift, cur.shape[0]))]
        )[: cur.shape[0]]
        cur = torch.maximum(cur, shifted)
        tables.append(cur)
    return tables


def _nearest_greater(d: torch.Tensor, span: int | None = None):
    """For every separator k return (dL, L, dR, R):

    L(k): nearest l < k with d[l] >  d[k]  (virtual boundary -1, SENTINEL)
    R(k): nearest r > k with d[r] >= d[k]  (virtual boundary len, SENTINEL)

    ``span`` caps the search distance (default: the whole array). Stacked
    rows pass their row's separator count: every row boundary holds the
    sentinel, which stops every in-cell search inside its own row, so the
    sparse table needs only ``ceil(log2(span))`` levels, not the flat
    array's."""
    s = d.shape[0]
    span = s if span is None else span
    levels = max(1, int(np.ceil(np.log2(max(span, 2)))))
    T = _block_max_table(d, levels)
    k = torch.arange(s, dtype=torch.int64, device=d.device)
    top = max(s - 1, 0)

    # Left search: shrink exclusive upper bound p while block has no '> v'.
    p = k
    for j in range(levels, -1, -1):
        step = 1 << j
        idx = torch.clamp(p - step, 0, top)
        can = (p >= step) & (T[j][idx] <= d)
        p = torch.where(can, p - step, p)
    L = p - 1
    sentinel = torch.full_like(d, DIST_SENTINEL)
    dL = torch.where(L >= 0, d[torch.clamp(L, min=0)], sentinel)

    # Right search: grow start q while block has no '>= v'.
    q = k + 1
    for j in range(levels, -1, -1):
        step = 1 << j
        idx = torch.clamp(q, 0, top)
        can = (q + step <= s) & (T[j][idx] < d)
        q = torch.where(can, q + step, q)
    R = q
    dR = torch.where(R < s, d[torch.clamp(R, 0, top)], sentinel)
    return dL, L, dR, R


def _separator_distances(data: torch.Tensor, m: int) -> torch.Tensor:
    """(n-1,) XOR separator distances (int64); cell crossings clamp to the
    sentinel. The ``forest_delta`` kernel on the card, its plain version on
    the CPU."""
    return forest_delta(data, m)


def _allowed_depth(overlap: torch.Tensor) -> torch.Tensor:
    """``ceil(log2(max(overlap, 2)))`` in integers: the bit length of
    ``max(overlap, 2) - 1``. A float ``log2`` an ulp off would flip a
    fallback flag; the JAX package's float formula agrees with this for
    every overlap up to 2^21 (pinned by a test)."""
    v = (torch.clamp(overlap, min=2) - 1).to(torch.float64)  # exact below 2^53
    return torch.frexp(v).exponent.to(torch.int64)  # v = f * 2^e, f in [0.5, 1)


def _build_cell_trees(
    data: torch.Tensor,
    d: torch.Tensor,
    cells: torch.Tensor,
    *,
    m: int,
    rows: int = 1,
    fallback_slack: int = 2,
):
    """Per-cell radix trees over all guide cells of ``rows`` stacked
    distributions of equal width, in one flat pass.

    ``data`` holds the rows' lower bounds end to end, ``cells`` each leaf's
    flat cell id ``row*m + local cell`` and ``d`` the flat separator
    distances, with the sentinel at every row boundary. Trees never cross a
    boundary, so every reference written is made row-local as it is
    written (a node id or leaf index minus its row's start): row ``b`` of
    the result equals the single build of row ``b`` bit for bit.

    JAX's ``.at[idx].set(..., mode="drop")`` with index ``n`` as the drop
    slot becomes a write into an ``(n+1,)`` buffer that is sliced at the
    end. Real targets are unique by construction; only the drop slot takes
    duplicates, so CUDA's unordered scatter stays deterministic.

    Returns flat ``(left, right, table, cell_first[:m] per row, fallback)``.
    """
    n = data.shape[0]
    W = n // rows
    dev = data.device
    i64 = torch.int64
    S = DIST_SENTINEL
    i = torch.arange(n, dtype=i64, device=dev)
    row_start = i - i % W

    grid_i = torch.arange(m, dtype=torch.int32, device=dev).to(torch.float32)
    grid = grid_i / torch.full_like(grid_i, float(m))
    cell_first = torch.searchsorted(
        data.view(rows, W), grid.expand(rows, m).contiguous(), right=True) - 1
    cell_first = torch.clamp(cell_first, 0, W - 1).reshape(-1)

    counts = torch.zeros(rows * m, dtype=i64, device=dev).scatter_add_(
        0, cells, torch.ones_like(cells))
    first_leaf = torch.full((rows * m,), n, dtype=i64, device=dev).scatter_reduce_(
        0, cells, i, "amin", include_self=True)
    f_safe = torch.clamp(first_leaf, 0, n - 1)
    f_local = f_safe - row_start[f_safe]
    left_overlap = data[f_safe] > grid.repeat(rows)
    overlap = torch.where(counts > 0, counts + left_overlap.to(i64), 1)

    left = torch.full((n + 1,), INVALID, dtype=i64, device=dev)
    right = torch.full((n + 1,), INVALID, dtype=i64, device=dev)
    node_parent = torch.full((n + 1,), -1, dtype=i64, device=dev)

    def drop(mask, idx):
        return torch.where(mask, idx, n)

    if n > 1:
        dL, L, dR, R = _nearest_greater(d, span=W - 1)
        k = torch.arange(n - 1, dtype=i64, device=dev)
        in_cell = d != S
        is_root = in_cell & (dL == S) & (dR == S)
        par_is_L = dL <= dR
        parent_node = torch.where(par_is_L, L, R) + 1
        node_local = (k + 1) - row_start[1:]

        # Internal non-root separators -> child of parent separator's node.
        inner = in_cell & ~is_root
        right[drop(inner & par_is_L, parent_node)] = node_local
        left[drop(inner & ~par_is_L, parent_node)] = node_local
        node_parent[drop(inner, k + 1)] = parent_node

        # Cell roots -> right child of the cell's root slot.
        root_slot = first_leaf[cells[:-1]]
        right[drop(is_root, root_slot)] = node_local
        node_parent[drop(is_root, k + 1)] = root_slot

    # Leaves.
    sent = torch.full((n,), S, dtype=i64, device=dev)
    if n > 1:
        dl = torch.cat([sent[:1], d])
        dr = torch.cat([d, sent[:1]])
    else:
        dl = dr = sent
    lone = (dl == S) & (dr == S)
    lpar_is_left = dl <= dr
    lparent = torch.where(lpar_is_left, i, i + 1)  # sep i-1 -> node i
    leaf_ref = ~(i - row_start)
    right[drop(~lone & lpar_is_left, lparent)] = leaf_ref
    left[drop(~lone & ~lpar_is_left, lparent)] = leaf_ref
    # A lone leaf is its cell's entire tree: right child of its own slot.
    right[drop(lone, i)] = leaf_ref
    leaf_parent = torch.where(lone, i, lparent)

    # Manual left child of every root slot: the interval overlapping the
    # cell from the left (clamped at the row start). Written after the
    # leaves, which it overrides.
    manual = ~torch.clamp(f_local - 1, min=0)
    left[drop(counts > 0, f_safe)] = manual

    table = torch.where(
        counts == 0, ~cell_first, torch.where(overlap == 1, ~f_local, f_local)
    ).to(torch.int32)

    # Traversal depth per leaf -> per-cell fallback flags.
    node_parent = node_parent[:n]
    depth = torch.zeros(n, dtype=i64, device=dev)
    anc = leaf_parent
    for _ in range(_DEPTH_ITERS):
        live = anc >= 0
        depth += live
        anc = torch.where(live, node_parent[torch.clamp(anc, min=0)], anc)
    depth += 1  # the leaf resolution step itself

    cell_depth = torch.zeros(rows * m, dtype=i64, device=dev).scatter_reduce_(
        0, cells, depth, "amax", include_self=True)
    fallback = (overlap > 1) & (
        cell_depth > _allowed_depth(overlap) + fallback_slack)
    return (left[:n].to(torch.int32), right[:n].to(torch.int32), table,
            cell_first.to(torch.int32), fallback)


def forest_from_cdf(
    cdf, m: int, fallback_slack: int = 2, d: torch.Tensor | None = None,
    device="cuda",
) -> RadixForest:
    """CDF (n+1,) -> forest with ``m`` guide cells, on ``device``.

    A stack of CDFs (B, n+1) builds all B forests in one flat pass (the
    fields then carry a leading B axis); row ``b`` is bit-identical to
    ``forest_from_cdf(cdf[b], m)``. ``d`` optionally feeds precomputed
    separator distances (int64 holding uint32 values, one distribution);
    they must match :func:`_separator_distances` bitwise or the forest
    silently diverges."""
    cdf = to_device(cdf, device, torch.float32)
    stacked = cdf.reshape(-1, cdf.shape[-1])
    rows, W = stacked.shape[0], stacked.shape[1] - 1
    data = lower_bounds(stacked).reshape(-1).contiguous()
    i = torch.arange(rows * W, dtype=torch.int64, device=cdf.device)
    cells = _cells(data, m) + (i // W) * m
    if d is None:
        d = _separator_distances(data, m)
        d[W - 1::W] = DIST_SENTINEL  # row boundaries
    else:
        if rows != 1:
            raise ValueError("precomputed distances are for one distribution")
        d = d.to(device=cdf.device, dtype=torch.int64)
    left, right, table, cf, fallback = _build_cell_trees(
        data, d, cells, m=m, rows=rows, fallback_slack=fallback_slack)
    cell_first = F.pad(cf.view(rows, m), (0, 1), value=W - 1)
    f = RadixForest(stacked, table.view(rows, m), left.view(rows, W),
                    right.view(rows, W), cell_first, fallback.view(rows, m))
    if cdf.dim() == 1:
        f = RadixForest(*(x[0] for x in f))
    return f


def build_forest_from_cdf(
    cdf, m: int, fallback_slack: int = 2, device="cuda"
) -> RadixForest:
    """Massively parallel forest construction from a CDF (see module doc)."""
    return forest_from_cdf(cdf, m, fallback_slack, device=device)


def build_forest(
    weights, m: int, fallback_slack: int = 2, device="cuda"
) -> RadixForest:
    """Weights -> CDF (parallel scan) -> forest. The end-to-end build."""
    return forest_from_cdf(
        build_cdf(weights, device=device), m, fallback_slack, device=device)


# ---------------------------------------------------------------------------
# Faithful Apetrei-style emulation of the paper's Algorithm 1 (ground truth).
# ---------------------------------------------------------------------------


def build_forest_apetrei(cdf: np.ndarray, m: int) -> dict:
    """Round-synchronous numpy emulation of Algorithm 1.

    One logical thread per leaf merges bottom-up; the GPU ``atomicExch`` on
    ``otherBounds[parent]`` is emulated by posting bounds and letting the
    second arrival continue. Distances use the text's "maximum" semantics at
    cell boundaries. Returns dict(table, left, right) matching
    :func:`forest_from_cdf`.
    """
    cdf = np.asarray(cdf, np.float32)
    n = len(cdf) - 1
    data = np.minimum(cdf[:-1], np.float32(np.nextafter(np.float32(1), np.float32(0))))
    cells = np.clip(np.floor(data * np.float32(m)).astype(np.int64), 0, m - 1)

    def dist(a: int, b: int) -> int:
        """Distance between leaves a and b=a+1 (sentinel at boundaries)."""
        if a < 0 or b > n - 1 or cells[a] != cells[b]:
            return DIST_SENTINEL
        return int(np_xor_distance(data[a : a + 1], data[b : b + 1])[0])

    left = np.full(n, INVALID, np.int64)
    right = np.full(n, INVALID, np.int64)
    other = np.full(n, -1, np.int64)   # otherBounds

    # Thread state: (nodeId, lo, hi); leaves encoded ~i.
    threads = [(~i, i, i) for i in range(n)]
    while threads:
        nxt = []
        for node_id, lo, hi in threads:
            dl, dr = dist(lo - 1, lo), dist(hi, hi + 1)
            if dl == dr == DIST_SENTINEL:
                # Cell root (incl. lone leaf): right child of the cell's
                # first leaf slot. Thread terminates.
                right[lo] = node_id
                continue
            child = 0 if dl > dr else 1            # 0 = left child
            parent = hi + 1 if child == 0 else lo
            if child == 0:
                left[parent] = node_id
            else:
                right[parent] = node_id
            # atomicExch(otherBounds[parent], range[child])
            posted = lo if child == 0 else hi
            prev, other[parent] = other[parent], posted
            if prev == -1:
                continue  # first arrival dies; sibling will merge up
            nlo, nhi = (prev, hi) if child == 1 else (lo, prev)
            nxt.append((parent, nlo, nhi))
        threads = nxt

    # Manual left child per non-empty cell root slot + guide table.
    table = np.zeros(m, np.int64)
    grid = (np.arange(m, dtype=np.float32)) / np.float32(m)
    cf = np.clip(np.searchsorted(data, grid, side="right") - 1, 0, n - 1)
    for c in range(m):
        leaves = np.where(cells == c)[0]
        if len(leaves) == 0:
            table[c] = ~cf[c]
            continue
        f = int(leaves[0])
        overlap = len(leaves) + (1 if data[f] > grid[c] else 0)
        table[c] = ~f if overlap == 1 else f
        left[f] = ~max(f - 1, 0)
    return {
        "table": table.astype(np.int32),
        "left": left.astype(np.int32),
        "right": right.astype(np.int32),
    }


# ---------------------------------------------------------------------------
# Validation / analysis helpers (numpy; used by tests).
# ---------------------------------------------------------------------------


def forest_to_numpy(f: RadixForest) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in f._asdict().items()}


def validate_forest(f: RadixForest) -> None:
    """Structural invariants; raises AssertionError on violation."""
    fn = forest_to_numpy(f)
    cdf, table, left, right = fn["cdf"], fn["table"], fn["left"], fn["right"]
    n, m = len(left), len(table)
    data = cdf[:-1]
    cells = np.clip(np.floor(data * np.float32(m)).astype(np.int64), 0, m - 1)

    for c in range(m):
        ref = int(table[c])
        leaves = np.where(cells == c)[0]
        if ref < 0:
            i = ~ref
            assert 0 <= i < n
            # the single overlapping interval must cover the cell start
            assert data[i] <= (c / m) + 1e-7 or (len(leaves) == 1 and leaves[0] == i)
            continue
        # In-order traversal of the cell tree must enumerate the cell's
        # leaves in increasing order (plus the manual left-overlap leaf).
        got: list[int] = []
        depth_guard = 0

        def walk(j: int) -> None:
            nonlocal depth_guard
            depth_guard += 1
            assert depth_guard < 10_000
            if j < 0:
                got.append(~j)
                return
            assert 0 <= j < n
            walk(int(left[j]))
            walk(int(right[j]))

        walk(ref)
        f0 = int(leaves[0])
        expect = [max(f0 - 1, 0)] + list(leaves)
        assert got == expect, (c, got, expect)


def depth_stats(f: RadixForest) -> dict:
    """Per-cell traversal depth statistics (node visits to reach a leaf)."""
    fn = forest_to_numpy(f)
    table, left, right = fn["table"], fn["left"], fn["right"]
    n, m = len(left), len(table)
    depths = np.zeros(n, np.int64)

    for c in range(m):
        ref = int(table[c])
        if ref < 0:
            continue
        stack = [(ref, 1)]
        while stack:
            j, dep = stack.pop()
            if j < 0:
                depths[~j] = max(depths[~j], dep)
                continue
            stack.append((int(left[j]), dep + 1))
            stack.append((int(right[j]), dep + 1))
    return {
        "max_depth": int(depths.max(initial=0)),
        "mean_depth": float(depths.mean()) if n else 0.0,
        "depths": depths,
    }
