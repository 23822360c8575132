"""Cell-partitioned sharded radix-tree forests over ``torch.distributed``:
the port of the JAX package's ``dist/forest.py``.

The paper's guide cells make every per-cell radix tree independent: a
separator that crosses a cell boundary is clamped to the sentinel distance,
so no tree edge crosses a cell. This module partitions the ``m`` guide
cells contiguously over the ranks of a process group, which takes the
place of JAX's mesh axis: the shard count is the group's world size, and
rank ``d`` builds and serves shard ``d``. The backend follows the device:
``nccl`` for CUDA tensors, ``gloo`` only when the caller asks for the CPU;
a group of the other backend raises.

* **Windowed builds.** Leaves are sorted by value and cells are contiguous
  in leaf space, so a contiguous cell range owns a contiguous leaf range.
  Each rank builds the trees of its own cells over exactly its owned leaves
  (``core.forest._build_cell_trees`` over a window, references global), and
  stores them in a window of ``capacity`` slots starting at
  ``window_start`` (the owned leaves' first index, clamped so the window
  fits in ``[0, n)``; ``capacity`` is the largest owned count rounded up
  to ``_CAPACITY_GRANULE``); the window's other slots are ``INVALID``.
  The plan (cell bounds -> leaf windows -> capacity) is made on the host
  from the device's own cell ids, identically on every rank.
* **Partitions.** Equal-width ``cell_partition`` is the default (``D | m``);
  ``rebalance=True`` balances cells by leaf occupancy
  (``occupancy_partition``); ``partition=`` pins explicit bounds.
* **Exact exchange.** Every collective moves bits, never sums that round:
  each rank's window rows and its cells' table rows are ``all_gather``-ed,
  so every rank holds the whole :class:`ShardedForest` (the windows of all
  shards and the replicated tables), and :func:`gather_forest` is a local
  scatter-max that is bit-identical to ``core.build_forest``.
* **Distributed CDF.** :func:`build_cdf_sharded` scans each rank's rows of
  the fixed ``SCAN_CHUNKS`` grid with the ``cdf_scan`` kernel in raw mode,
  ``all_gather``-s the row totals and re-derives the serial carry chain on
  every rank: bit-identical to ``core.cdf.build_cdf``.
* **Owner-routed drain.** :func:`sample_sharded` gives each rank ``B/D``
  lanes of the batch, buckets them by owning shard (stable sort, a static
  bucket capacity planned on the host), exchanges the buckets with one
  ``all_to_all_single``, descends only its owned draws over its window
  (the loop ends on its own deepest lane) and routes the interval ids back
  with a second ``all_to_all_single``; the ranks' answers are then
  ``all_gather``-ed into the whole batch. ``routed=False`` keeps the
  reference oracle: every rank descends the whole batch over its owned
  lanes and an ``all_reduce`` combines them exactly (one owner a lane, the
  other ranks add zeros). Both equal ``core.sample.sample_forest``
  elementwise. As in JAX, the descent is plain tensor code, not the
  ``forest_sample`` kernel.
* **Delta updates.** :func:`update_forest_sharded` rescans the CDF on the
  same grid, takes the new separator distances and the changed-leaf mask
  from the ``forest_delta_update`` kernel, rebuilds only the ranks whose
  owned leaves moved (the others keep their rows byte for byte), keeps a
  larger window capacity while the new plan fits (hysteresis), and equals
  a from-scratch sharded build over the same partition and capacity.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.cdf import (
    SCAN_CHUNKS,
    _raw_row_scan,
    chunk_bounds,
    finalize_cdf,
    lower_bounds,
    scan_chunk_rows,
)
from repro_torch.core.forest import INVALID, MAX_DEPTH, RadixForest, _build_cell_trees, _cells
from repro_torch.core.sample import _bisect, sample_forest
from repro_torch.device import resolve, to_device
from repro_torch.kernels.forest_delta import forest_delta, forest_delta_update

# Window capacities round up to this granule: small occupancy drift between
# delta updates keeps the window, and the per-rank window still shrinks
# about linearly with the shard count.
_CAPACITY_GRANULE = 64
# Routed-drain bucket capacities round up to this granule.
_BUCKET_GRANULE = 16


class ShardedForest(NamedTuple):
    """Guide table + forest, cell-partitioned over ``n_shards`` ranks.

    ``left``/``right`` are (D, C) windowed node arrays: row ``d`` holds the
    global slot range ``[window_start[d], window_start[d] + C)`` of shard
    ``d``, unowned slots ``INVALID``; stored references are global.
    ``table``/``fallback``/``cell_first``/``cdf`` are the whole forest's.
    ``cell_bounds`` is the contiguous cell partition (shard ``d`` owns
    cells ``[cell_bounds[d], cell_bounds[d+1])``); ``window_count`` is the
    number of owned leaves of each shard. Every rank holds every field."""

    cdf: torch.Tensor           # (n+1,) f32
    table: torch.Tensor         # (m,)  i32
    left: torch.Tensor          # (D, C) i32 windowed child refs
    right: torch.Tensor         # (D, C) i32 windowed child refs
    cell_first: torch.Tensor    # (m+1,) i32
    fallback: torch.Tensor      # (m,)  bool
    cell_bounds: torch.Tensor   # (D+1,) i32 cell partition bounds
    window_start: torch.Tensor  # (D,)  i32 global leaf offset of each window
    window_count: torch.Tensor  # (D,)  i32 owned leaves per shard

    @property
    def n(self) -> int:
        return self.cdf.shape[0] - 1

    @property
    def m(self) -> int:
        return self.table.shape[0]

    @property
    def n_shards(self) -> int:
        return self.left.shape[0]

    @property
    def capacity(self) -> int:
        """Per-shard leaf-window size (the local build problem)."""
        return self.left.shape[1]


def _world(group, device: torch.device) -> tuple[int, int]:
    """(shard count, this rank's shard) of ``group``; checks that the
    group's backend serves ``device`` and that the count divides the scan
    grid."""
    if not dist.is_initialized():
        raise RuntimeError(
            "repro_torch.dist.forest needs an initialized torch.distributed "
            "process group (backend 'nccl' for CUDA tensors, 'gloo' on the CPU)")
    backend = dist.get_backend(group)
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(
            f"device {device} needs a {want!r} process group, this one is {backend!r}")
    D = dist.get_world_size(group)
    if SCAN_CHUNKS % D:
        raise ValueError(f"shard count {D} must divide SCAN_CHUNKS={SCAN_CHUNKS}")
    return D, dist.get_rank(group)


def _all_gather(t: torch.Tensor, D: int, group) -> torch.Tensor:
    """(D, *t.shape): every rank's ``t``, in rank order (bits, no sums)."""
    out = [torch.empty_like(t) for _ in range(D)]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def default_mesh(axis: str = "data", device="cuda"):
    """1-D ``DeviceMesh`` named ``axis`` over every rank of the initialized
    default process group (JAX's mesh over every local device); its
    ``get_group()`` is the ``group=`` of this module's functions."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve(device)
    if not dist.is_initialized():
        raise RuntimeError("default_mesh needs an initialized torch.distributed process group")
    return init_device_mesh(dev.type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def cell_partition(m: int, n_shards: int) -> np.ndarray:
    """Equal-width shard bounds in cell space: shard d owns [b[d], b[d+1])."""
    if m % n_shards:
        raise ValueError(f"m={m} must divide over {n_shards} shards")
    return np.arange(n_shards + 1, dtype=np.int64) * (m // n_shards)


def occupancy_partition(cell_counts, n_shards: int) -> np.ndarray:
    """Contiguous cell-aligned bounds minimizing the max per-shard leaf load.

    Binary-search the smallest capacity for which a greedy left-to-right
    fill needs at most ``n_shards`` segments, then emit the greedy cuts at
    that capacity. Deterministic; trailing shards may own empty cell
    ranges; one giant cell forces its whole load onto one shard."""
    counts = np.asarray(cell_counts, np.int64)
    if counts.ndim != 1 or counts.size == 0:
        raise ValueError("cell_counts must be a non-empty 1-D array")
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    m = counts.shape[0]
    cum = np.concatenate([[0], np.cumsum(counts)])
    total = int(cum[-1])

    def cuts(cap: int) -> list[int]:
        """Greedy segment ends: each shard takes the longest prefix <= cap."""
        out, b = [], 0
        for _ in range(n_shards):
            if b < m:
                b = int(np.searchsorted(cum, cum[b] + cap, side="right")) - 1
            out.append(b)
        return out

    lo = max(int(counts.max(initial=0)), -(-total // n_shards), 1)
    hi = max(total, lo)
    while lo < hi:
        mid = (lo + hi) // 2
        if cuts(mid)[-1] >= m:
            hi = mid
        else:
            lo = mid + 1
    return np.asarray([0] + cuts(lo), np.int64)


def resolve_partition(m: int, n_shards: int, partition=None, rebalance: bool = False,
                      cell_counts=None) -> np.ndarray:
    """Cell bounds for a build: explicit > occupancy-balanced > equal-width."""
    if partition is not None:
        b = np.asarray(partition, np.int64)
        if b.shape != (n_shards + 1,) or b[0] != 0 or b[-1] != m or np.any(np.diff(b) < 0):
            raise ValueError(
                f"partition must be a nondecreasing (n_shards+1,) bounds "
                f"array from 0 to m={m}, got {b!r}")
        return b
    if rebalance:
        return occupancy_partition(cell_counts, n_shards)
    return cell_partition(m, n_shards)


def _round_capacity(max_count: int, n: int) -> int:
    c = -(-max(int(max_count), 1) // _CAPACITY_GRANULE) * _CAPACITY_GRANULE
    return min(c, n)


def _plan_windows(cells_np: np.ndarray, bounds: np.ndarray, n: int):
    """Per-shard leaf windows for a cell partition: ``(starts, counts,
    capacity)``, the first owned leaf, the owned leaf count and the window
    capacity. ``cells_np`` is nondecreasing, so each shard's owned leaves
    are ``[starts[d], starts[d] + counts[d])``."""
    starts = np.searchsorted(cells_np, bounds[:-1], side="left").astype(np.int64)
    ends = np.searchsorted(cells_np, bounds[1:], side="left").astype(np.int64)
    counts = ends - starts
    return starts, counts, _round_capacity(counts.max(initial=1), n)


def _scan_sharded(w: torch.Tensor, D: int, idx: int, group) -> torch.Tensor:
    """(n,) weights -> (n+1,) cdf: this rank's rows of the scan grid, the
    exchanged row totals, the serial carry re-derived on every rank. The
    same scans and adds as ``core.cdf.chunked_cumsum``, so the same bits."""
    n = w.shape[0]
    Cl = SCAN_CHUNKS // D
    mine = slice(idx * Cl, (idx + 1) * Cl)
    local = _raw_row_scan(scan_chunk_rows(w)[mine].contiguous())           # (Cl, L)
    totals = _all_gather(local[:, -1], D, group).reshape(1, SCAN_CHUNKS)
    carry = F.pad(_raw_row_scan(totals)[0, :-1], (1, 0))                     # exclusive
    out = local + carry[mine, None]
    return finalize_cdf(_all_gather(out, D, group).reshape(-1)[:n])


def build_cdf_sharded(weights, group=None, device="cuda") -> torch.Tensor:
    """Distributed CDF build over ``group``: local chunk-row scans and an
    exact exchange of the row totals. Returns the (n+1,) cdf on every rank,
    bit-identical to ``core.cdf.build_cdf(weights)``."""
    dev = resolve(device)
    D, idx = _world(group, dev)
    return _scan_sharded(to_device(weights, dev, torch.float32), D, idx, group)


def _window_rows(cdf, bounds, starts, counts, w_start: int, idx: int, *, m: int, cap: int,
                 m_cap: int, fallback_slack: int, d_full=None):
    """Shard ``idx``'s build: its (cap,) window rows of ``left``/``right``
    and its cells' (m_cap,) rows of table, cell_first and fallback (int32,
    padded past its cell count)."""
    dev = cdf.device
    n = cdf.shape[0] - 1
    s, c = int(starts[idx]), int(counts[idx])
    lo, hi = int(bounds[idx]), int(bounds[idx + 1])
    left = torch.full((cap,), INVALID, dtype=torch.int32, device=dev)
    right = torch.full((cap,), INVALID, dtype=torch.int32, device=dev)
    cells = torch.zeros((3, m_cap), dtype=torch.int32, device=dev)
    if hi == lo:
        return left, right, cells
    if c == 0:
        # no owned leaf: each owned cell lies inside the interval of leaf s-1
        cf = max(min(s - 1, n - 1), 0)
        cells[0, :hi - lo] = ~cf
        cells[1, :hi - lo] = cf
        return left, right, cells
    data = lower_bounds(cdf)[s:s + c]
    d = forest_delta(data, m) if d_full is None else d_full[s:s + c - 1]
    wl, wr, tbl, cf, fb = _build_cell_trees(
        data, d.to(torch.int64), _cells(data, m) - lo, m=m, fallback_slack=fallback_slack,
        cell_lo=lo, m_cells=hi - lo, node_offset=s, n_total=n)
    off = s - w_start
    left[off:off + c] = wl
    right[off:off + c] = wr
    cells[0, :hi - lo] = tbl
    cells[1, :hi - lo] = cf
    cells[2, :hi - lo] = fb.to(torch.int32)
    return left, right, cells


def _assemble(cdf, rows, bounds, w_starts, counts, *, m: int, D: int, group) -> ShardedForest:
    """Exchange every rank's rows (``_window_rows``) and assemble the whole
    :class:`ShardedForest` on every rank."""
    left, right, cells = rows
    dev = cdf.device
    n = cdf.shape[0] - 1
    left_all = _all_gather(left, D, group)
    right_all = _all_gather(right, D, group)
    cells_all = _all_gather(cells, D, group)                        # (D, 3, m_cap)
    per_cell = torch.cat([cells_all[r, :, :int(bounds[r + 1] - bounds[r])] for r in range(D)], 1)
    i32 = torch.int32
    return ShardedForest(
        cdf, per_cell[0].contiguous(), left_all, right_all,
        F.pad(per_cell[1], (0, 1), value=n - 1), per_cell[2] > 0,
        torch.as_tensor(bounds, dtype=i32, device=dev),
        torch.as_tensor(w_starts, dtype=i32, device=dev),
        torch.as_tensor(counts, dtype=i32, device=dev))


def build_forest_from_cdf_sharded(
    cdf, m: int, group=None, fallback_slack: int = 2, partition=None,
    rebalance: bool = False, d_full: torch.Tensor | None = None,
    cells_np: np.ndarray | None = None, capacity: int | None = None, device="cuda",
) -> ShardedForest:
    """Windowed shard-local forest build over a CDF every rank holds.

    The plan (cell occupancy -> partition -> leaf windows -> capacity) is
    made on the host from the device's cell ids; each rank then builds its
    window and the ranks exchange rows. :func:`gather_forest` of the result
    is bit-identical to ``core.build_forest_from_cdf(cdf, m)``.
    ``d_full``/``cells_np`` feed distances and cell ids already computed
    (the delta path; they must equal the device's own). ``capacity`` pins
    the window size instead of the planned one (it must hold every shard's
    owned leaves)."""
    dev = resolve(device)
    D, idx = _world(group, dev)
    cdf = to_device(cdf, dev, torch.float32)
    n = cdf.shape[0] - 1
    if cells_np is None:
        cells_np = _cells(lower_bounds(cdf), m).cpu().numpy()
    bounds = resolve_partition(
        m, D, partition=partition, rebalance=rebalance,
        cell_counts=(np.bincount(cells_np, minlength=m)
                     if partition is None and rebalance else None))
    starts, counts, cap = _plan_windows(cells_np, bounds, n)
    if capacity is not None:
        if capacity < counts.max(initial=1):
            raise ValueError(
                f"capacity={capacity} below the plan's max owned leaf count "
                f"{int(counts.max(initial=1))}")
        cap = min(int(capacity), n)
    w_starts = np.clip(starts, 0, n - cap)
    m_cap = _round_capacity(np.diff(bounds).max(initial=1), m)
    rows = _window_rows(cdf, bounds, starts, counts, int(w_starts[idx]), idx, m=m, cap=cap,
                        m_cap=m_cap, fallback_slack=fallback_slack, d_full=d_full)
    return _assemble(cdf, rows, bounds, w_starts, counts, m=m, D=D, group=group)


def build_forest_sharded(
    weights, m: int, group=None, fallback_slack: int = 2,
    partition=None, rebalance: bool = False, capacity: int | None = None,
    device="cuda",
) -> ShardedForest:
    """Distributed scan -> windowed per-shard cell-range tree build. Each
    rank derives the whole CDF from the distributed scan, then builds only
    its own cells' trees over its own leaves, node ids global.
    :func:`gather_forest` of the result is bit-identical to
    ``core.build_forest``."""
    dev = resolve(device)
    D, idx = _world(group, dev)
    cdf = _scan_sharded(to_device(weights, dev, torch.float32), D, idx, group)
    return build_forest_from_cdf_sharded(
        cdf, m, group=group, fallback_slack=fallback_slack, partition=partition,
        rebalance=rebalance, capacity=capacity, device=dev)


def build_forest_sharded_auto(weights, m: int, group=None, fallback_slack: int = 2,
                              rebalance: bool = False, device="cuda") -> ShardedForest:
    """Caller-friendly build: ``m`` rounded up to the next multiple of the
    shard count (the equal partition needs D | m)."""
    dev = resolve(device)
    D, _ = _world(group, dev)
    m = -(-m // D) * D
    return build_forest_sharded(weights, m, group=group, fallback_slack=fallback_slack,
                                rebalance=rebalance, device=dev)


def update_forest_sharded(
    forest: ShardedForest, weights=None, *, weights_delta=None, base_weights=None,
    group=None, fallback_slack: int = 2, with_stats: bool = False,
    device="cuda",
):
    """Delta update: rebuild only the shards whose owned leaves changed.

    ``weights`` is the full new weight vector (or pass ``weights_delta`` +
    ``base_weights`` and their float32 sum is formed here). The CDF is
    rescanned on the fixed grid; the new separator distances and the
    changed-leaf mask come from the ``forest_delta_update`` kernel. Shards
    whose owned leaves carry no changed bit keep their rows byte for byte;
    a delta that changes no CDF bit rebuilds nothing.

    Capacity hysteresis: the fresh plan's capacity is adopted only when it
    grows past the current window; while the new plan fits, the old
    (possibly larger) capacity is kept. The result is bit-identical to
    ``build_forest_sharded(weights, m, partition=forest.cell_bounds,
    capacity=<the kept capacity>)``.

    With ``with_stats=True`` also returns a dict: ``dirty_shards``,
    ``dirty_chunks`` (scan-grid rows holding changed CDF entries),
    ``plan_changed`` (leaf windows moved: full windowed rebuild),
    ``rebuilt``, ``rebuilt_windows`` (window builds the ranks ran),
    ``capacity`` and ``capacity_kept``."""
    dev = resolve(device)
    D, idx = _world(group, dev)
    if forest.n_shards != D:
        raise ValueError(f"forest has {forest.n_shards} shards but the group has {D}")
    if weights is None:
        if weights_delta is None or base_weights is None:
            raise ValueError("pass weights, or both weights_delta and base_weights")
        weights = (to_device(base_weights, dev, torch.float32)
                   + to_device(weights_delta, dev, torch.float32))
    w = to_device(weights, dev, torch.float32)
    n, m = forest.n, forest.m
    if w.shape[0] != n:
        raise ValueError(
            f"delta update keeps n fixed: forest has {n} intervals, got {w.shape[0]} weights")
    new_cdf = _scan_sharded(w, D, idx, group)
    changed_cdf = np.flatnonzero(
        (new_cdf[1:].view(torch.int32) != forest.cdf[1:].view(torch.int32)).cpu().numpy())
    dirty_chunks = int(np.unique(
        np.searchsorted(chunk_bounds(n), changed_cdf, side="right") - 1).size)
    if changed_cdf.size == 0:
        stats = dict(dirty_shards=0, dirty_chunks=0, plan_changed=False, rebuilt=False,
                     rebuilt_windows=0, capacity=forest.capacity, capacity_kept=False)
        out = forest._replace(cdf=new_cdf)  # same bits; fresh buffer
        return (out, stats) if with_stats else out

    bounds = forest.cell_bounds.cpu().numpy().astype(np.int64)
    new_data = lower_bounds(new_cdf)
    d_new, leaf_changed = forest_delta_update(lower_bounds(forest.cdf), new_data, m)
    cells_np = _cells(new_data, m).cpu().numpy()
    starts, counts, fresh_cap = _plan_windows(cells_np, bounds, n)
    # hysteresis: keep the window while the new plan still fits
    cap = forest.capacity if fresh_cap <= forest.capacity else fresh_cap
    w_starts = np.clip(starts, 0, n - cap)
    plan_same = (cap == forest.capacity
                 and np.array_equal(w_starts, forest.window_start.cpu().numpy())
                 and np.array_equal(counts, forest.window_count.cpu().numpy()))
    lc = leaf_changed.cpu().numpy()
    dirty = np.array([bool(lc[s:s + c].any()) for s, c in zip(starts, counts)])
    if plan_same:
        m_cap = _round_capacity(np.diff(bounds).max(initial=1), m)
        if dirty[idx]:
            rows = _window_rows(new_cdf, bounds, starts, counts, int(w_starts[idx]), idx, m=m,
                                cap=cap, m_cap=m_cap, fallback_slack=fallback_slack,
                                d_full=d_new)
        else:  # a clean shard's rows are a function of its unchanged leaves
            lo, hi = int(bounds[idx]), int(bounds[idx + 1])
            cells = torch.zeros((3, m_cap), dtype=torch.int32, device=dev)
            cells[0, :hi - lo] = forest.table[lo:hi]
            cells[1, :hi - lo] = forest.cell_first[lo:hi]
            cells[2, :hi - lo] = forest.fallback[lo:hi].to(torch.int32)
            rows = (forest.left[idx], forest.right[idx], cells)
        out = _assemble(new_cdf, rows, bounds, w_starts, counts, m=m, D=D, group=group)
    else:
        out = build_forest_from_cdf_sharded(
            new_cdf, m, group=group, fallback_slack=fallback_slack, partition=bounds,
            d_full=d_new, cells_np=cells_np, capacity=cap, device=dev)
    stats = dict(
        dirty_shards=int(dirty.sum()) if plan_same else D,
        dirty_chunks=dirty_chunks, plan_changed=not plan_same, rebuilt=True,
        rebuilt_windows=int(dirty.sum()) if plan_same else D,
        capacity=cap, capacity_kept=cap > fresh_cap)
    return (out, stats) if with_stats else out


def gather_forest(forest: ShardedForest) -> RadixForest:
    """The per-shard windows combined into one ``RadixForest`` (a local
    operation: every rank holds every window). Slot ownership is disjoint
    and ``INVALID`` is the int32 minimum, so scatter-maxing every window at
    its global offset is the exact union of the builds."""
    D, cap = forest.left.shape
    n = forest.n
    dev = forest.left.device
    idx = (forest.window_start[:, None].to(torch.int64)
           + torch.arange(cap, dtype=torch.int64, device=dev)[None, :]).reshape(-1)

    def union(rows):
        full = torch.full((n,), INVALID, dtype=torch.int32, device=dev)
        return full.scatter_reduce_(0, idx, rows.reshape(-1), "amax")

    return RadixForest(forest.cdf, forest.table, union(forest.left), union(forest.right),
                       forest.cell_first, forest.fallback)


def _round_bucket(count: int, limit: int) -> int:
    """Static per-(source, owner) bucket capacity: the observed max count
    rounded up to the bucket granule, never above the lanes a rank holds."""
    k = -(-max(int(count), 1) // _BUCKET_GRANULE) * _BUCKET_GRANULE
    return max(min(k, limit), 1)


def _owners(xi: torch.Tensor, bounds: torch.Tensor, m: int) -> torch.Tensor:
    """Owning shard of each uniform: its guide cell against the partition
    bounds (right-sided, so empty shards own nothing)."""
    g = torch.clamp(torch.floor(xi * float(m)).to(torch.int32), 0, m - 1)
    b = bounds.to(torch.int32).contiguous()
    return torch.clamp(torch.searchsorted(b, g, right=True) - 1, 0, b.shape[0] - 2)


def _drain_plan(forest: ShardedForest, xi: torch.Tensor, D: int):
    """The routed drain's plan, the same on every rank: pad the batch to D
    lanes a rank (sentinel -1.0), count draws per (source, owner), round
    the max to the bucket capacity. Returns ``(plan, xi_padded)``."""
    B = xi.shape[0]
    if B == 0:
        raise ValueError("cannot drain an empty batch")
    lanes = -(-B // D)
    xi_p = F.pad(xi, (0, lanes * D - B), value=-1.0)
    owners = _owners(xi_p, forest.cell_bounds, forest.m).to(torch.int64).reshape(D, lanes)
    counts = torch.zeros((D, D), dtype=torch.int64, device=xi.device).scatter_add_(
        1, owners, torch.ones_like(owners)).cpu().numpy()
    K = _round_bucket(counts.max(initial=1), lanes)
    plan = dict(batch=B, padded_batch=lanes * D, lanes_per_shard=lanes,
                bucket_capacity=K, descent_lanes=D * K, send_counts=counts)
    return plan, xi_p


def drain_plan(forest: ShardedForest, xi, group=None, device="cuda") -> dict:
    """The routed drain's bucket plan for a batch: ``lanes_per_shard`` (the
    lanes each rank holds), ``bucket_capacity`` (per (source, owner)
    bucket), ``descent_lanes`` (lanes each rank's descent runs over: about
    B/D for balanced owners, against the whole batch on the oracle path)
    and ``send_counts`` (D, D)."""
    dev = resolve(device)
    D, _ = _world(group, dev)
    return _drain_plan(forest, to_device(xi, dev, torch.float32), D)[0]


def _window_descent(forest: ShardedForest, idx: int, x: torch.Tensor, live: torch.Tensor,
                    use_fallback: bool) -> torch.Tensor:
    """Algorithm 2 over shard ``idx``'s window for the lanes ``live`` owns
    (the others resolve to ~0 at once): guide lookup, the balanced
    bisection of flagged cells, then the descent, global node id minus the
    window start being the window slot. The loop ends when this shard's
    deepest lane is done. Returns interval ids (int64)."""
    m, n, cap = forest.m, forest.n, forest.capacity
    start = int(forest.window_start[idx])
    left, right = forest.left[idx].to(torch.int64), forest.right[idx].to(torch.int64)
    g = torch.clamp(torch.floor(x * float(m)).to(torch.int32), 0, m - 1).to(torch.int64)
    j = torch.where(live, forest.table[g].to(torch.int64), -1)
    if use_fallback:
        flagged = live & forest.fallback[g] & (j >= 0)
        bal = _bisect(forest.cdf, x, forest.cell_first[g], forest.cell_first[g + 1], 32)
        j = torch.where(flagged, ~bal, j)
    for _ in range(MAX_DEPTH):
        active = j >= 0
        if not bool(active.any()):
            break
        jw = torch.clamp(j - start, 0, cap - 1)
        go_left = x < forest.cdf[torch.clamp(j, 0, n - 1)]
        j = torch.where(active, torch.where(go_left, left[jw], right[jw]), j)
    return ~j


def sample_sharded(
    forest: ShardedForest, xi, group=None, use_fallback: bool = True, routed: bool = True,
    on_mismatch: str = "raise", with_stats: bool = False, device="cuda",
):
    """Algorithm 2 over the sharded forest: the owner-routed bulk drain.

    ``xi`` is the whole batch, the same on every rank; every rank returns
    the whole batch's (B,) int32 interval ids, elementwise identical to
    ``core.sample.sample_forest`` on the gathered forest.

    ``routed=True``: rank d takes lanes ``[d*B/D, (d+1)*B/D)``, stably sorts
    them by owning shard into capacity-padded buckets, one
    ``all_to_all_single`` exchanges the buckets, the owner descends only
    its owned draws over its window, a second ``all_to_all_single`` plus
    the inverse sort permutation routes the ids back, and an
    ``all_gather`` assembles the batch. ``routed=False`` is the reference
    oracle: every rank descends the whole batch over its owned lanes and
    one ``all_reduce`` combines them (one owner a lane; exact).

    ``on_mismatch`` picks the behavior when the forest's shard count is not
    the group's size (a restore onto fewer or more ranks): ``"raise"``
    (default) or ``"degrade"``: gather the forest (exact) and resolve the
    batch with the single-device ``sample_forest``, flagged
    ``degraded=True`` in the stats dict that ``with_stats=True`` adds."""
    if on_mismatch not in ("raise", "degrade"):
        raise ValueError(f"on_mismatch must be 'raise' or 'degrade', got {on_mismatch!r}")
    dev = resolve(device)
    D, idx = _world(group, dev)
    stats = dict(degraded=False, n_shards=forest.n_shards, mesh_devices=D)
    x = to_device(xi, dev, torch.float32)
    if forest.n_shards != D:
        if on_mismatch == "raise":
            raise ValueError(f"forest has {forest.n_shards} shards but the group has {D}")
        out = sample_forest(gather_forest(forest), x, use_fallback=use_fallback, device=dev)
        stats["degraded"] = True
        return (out, stats) if with_stats else out
    if not routed:
        g = torch.clamp(torch.floor(x * float(forest.m)).to(torch.int32), 0, forest.m - 1)
        owned = (g >= forest.cell_bounds[idx]) & (g < forest.cell_bounds[idx + 1])
        ids = _window_descent(forest, idx, x, owned, use_fallback)
        out = torch.where(owned, ids, 0).to(torch.int32)
        dist.all_reduce(out, group=group)
        return (out, stats) if with_stats else out
    plan, xi_p = _drain_plan(forest, x, D)
    lanes, K = plan["lanes_per_shard"], plan["bucket_capacity"]
    xl = xi_p[idx * lanes:(idx + 1) * lanes]
    # Bucket my lanes by owner: the stable sort keeps equal-owner draws in
    # batch order, and (owner, rank in bucket) is the slot the owner answers
    # at, so the round trip carries no index payload.
    owner = _owners(xl, forest.cell_bounds, forest.m).to(torch.int64)
    order = torch.sort(owner, stable=True).indices
    so, sx = owner[order], xl[order]
    seg = torch.searchsorted(so, torch.arange(D, dtype=torch.int64, device=dev))
    rank = torch.arange(lanes, dtype=torch.int64, device=dev) - seg[so]
    send = torch.full((D, K), -1.0, dtype=torch.float32, device=dev)
    send[so, rank] = sx
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    rx = recv.reshape(-1)
    ids = _window_descent(forest, idx, rx, rx >= 0.0, use_fallback).to(torch.int32)
    back = torch.empty((D, K), dtype=torch.int32, device=dev)
    dist.all_to_all_single(back, ids.reshape(D, K).contiguous(), group=group)
    mine = torch.empty(lanes, dtype=torch.int32, device=dev)
    mine[order] = back[so, rank]
    out = _all_gather(mine, D, group).reshape(-1)[:plan["batch"]]
    return (out, stats) if with_stats else out
