"""Size-class arenas with a per-tenant sampling method: many variable-n
tenants in a few stacked tables on the card, two drain paths.

The multi-tenant serving problem: thousands of clients each own a small
categorical of a different size, churning (insert / re-weight / evict) at
request rate. :class:`ForestPool` pads tenants into power-of-two size
classes, so every tenant of a class shares one stacked table, built and
drained by the same kernels however many tenants come and go. Each tenant
also declares how it is sampled:

* ``method="forest"``: the monotone radix-forest map
  (:class:`~repro_torch.pool.batched.BatchedForest` stacks). It keeps QMC
  stratification; the default.
* ``method="alias"``: packed Walker/Vose tables
  (:class:`~repro_torch.pool.batched.BatchedAlias` stacks) built by the
  split-and-pack kernel. O(1) a draw, but a non-monotone map: for PRNG
  tenants.

Both arena kinds share one slot machine (:class:`_Arena`): ``insert``
hands out a :class:`Handle` (size class, row, true ``n``, version,
method); rows are recycled through a free list and every recycle bumps the
row's version, so a stale handle raises
:class:`~repro_torch.robust.errors.StaleHandleError`. ``update_weights``
re-targets a tenant in place: forest rows skip the rebuild when the new CDF
has the same bits and otherwise rebuild from the distances of the
``forest_delta_update`` kernel; alias rows skip on unchanged padded weight
bits and otherwise re-pack. ``evict`` clears the freed row's state.
Zero padding is sound on both paths: padded intervals have zero width and
padded alias cells are ``q == 0`` lights that are never an alias target.

Every weight row entering the pool passes the admission ``policy``
(``reject`` | ``clamp`` | ``quarantine`` | ``off``,
:mod:`repro_torch.robust.validate`).

Host bookkeeping (free lists, versions, raw weights) stays numpy; the
stacks live on ``device`` (default ``"cuda"``; ``"cpu"`` runs the plain
versions of the kernels). Admission waves build each (method, size class)
group with one batched launch (forest groups in waves of at most
``WAVE_LEAF_CAP`` leaves, which bounds the flat build's memory), and sync
once per wave for the fallback flags. A drain copies its lanes to the
device once, launches one kernel for its forest groups and one for its alias
groups, each clipping its lanes' results in place, and makes one
device-to-host copy at the end. Snapshots are
plain numpy dicts in the JAX package's layout, so :meth:`ForestPool.restore`
takes a snapshot of either package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.alias import AliasTable
from repro_torch.core.cdf import build_cdf, lower_bounds, normalize_weights
from repro_torch.core.forest import RadixForest, forest_from_cdf
from repro_torch.device import resolve, to_device
from repro_torch.kernels import ops
from repro_torch.robust.errors import QuarantinedError, StaleHandleError
from repro_torch.robust.validate import check_policy, sanitize_weights

from .batched import BatchedAlias, BatchedForest, build_forest_batched

METHODS = ("forest", "alias")
# Leaves per flat forest build of an admission wave. The build's sparse
# table holds log2(class size) + 1 int64 copies of the wave's distances, so
# 2^22 leaves cost at most about 0.6 GB of them.
WAVE_LEAF_CAP = 1 << 22


class Handle(NamedTuple):
    """Stable tenant reference: which class/row, how big, which lifetime,
    and which sampling method its row lives under."""

    size_class: int  # padded n (power of two): the class key
    row: int         # row in the class's stacked arrays
    n: int           # true (unpadded) distribution size
    version: int     # row lifetime counter; mismatch => stale handle
    method: str = "forest"  # "forest" (monotone) | "alias" (O(1), PRNG-only)


def _pow2_at_least(x: int, floor: int) -> int:
    p = max(int(floor), 1)
    while p < x:
        p <<= 1
    return p


class _Arena:
    """The shared size-class slot machine: pow2-padded rows, free-list
    recycling, per-row version counters, raw-weight shadow copies. Payload
    storage is the subclass's business via :meth:`_grow_payload`."""

    def __init__(self, size: int, init_rows: int, device: torch.device):
        self.size = size
        self.rows = init_rows
        self.device = device
        self.n_true = np.zeros(init_rows, np.int64)
        self.versions = np.zeros(init_rows, np.int64)
        self.free: list[int] = list(range(init_rows - 1, -1, -1))
        self.raw: dict[int, np.ndarray] = {}  # row -> float64 raw weights
        self.builds = 0
        self.grows = 0

    @property
    def occupied(self) -> int:
        return self.rows - len(self.free)

    def _grow_payload(self, extra: int) -> None:
        raise NotImplementedError

    def grow(self) -> None:
        extra = self.rows
        self.free.extend(range(self.rows + extra - 1, self.rows - 1, -1))
        self._grow_payload(extra)
        self.n_true = np.concatenate([self.n_true, np.zeros(extra, np.int64)])
        self.versions = np.concatenate([self.versions, np.zeros(extra, np.int64)])
        self.rows += extra
        self.grows += 1

    def take_row(self) -> int:
        if not self.free:
            self.grow()
        return self.free.pop()


class _SizeClass(_Arena):
    """One stacked forest arena: all tenants padded to ``size`` leaves."""

    def __init__(self, size: int, m: int, init_rows: int, device: torch.device):
        super().__init__(size, init_rows, device)
        self.m = m
        self.forest: BatchedForest | None = None  # allocated on first build
        self.degenerate_rows: set[int] = set()  # rows with flagged cells
        self.delta_rebuilds = 0
        self.delta_skips = 0

    def _grow_payload(self, extra: int) -> None:
        if self.forest is not None:
            pad = _zeros_forest(extra, self.size, self.m, self.device)
            self.forest = BatchedForest(
                *(torch.cat([a, b]) for a, b in zip(self.forest, pad)))


class AliasArena(_Arena):
    """One stacked packed-alias arena: the PRNG fast path's payload.
    ``rebuilds``/``skips`` count :meth:`ForestPool.update_weights` work."""

    def __init__(self, size: int, init_rows: int, device: torch.device):
        super().__init__(size, init_rows, device)
        self.table: BatchedAlias | None = None  # allocated on first build
        self.rebuilds = 0
        self.skips = 0

    def _grow_payload(self, extra: int) -> None:
        if self.table is not None:
            pad = _zeros_alias(extra, self.size, self.device)
            self.table = BatchedAlias(
                *(torch.cat([a, b]) for a, b in zip(self.table, pad)))


def _zeros_forest(rows: int, n: int, m: int, device) -> BatchedForest:
    """Placeholder stack for never-occupied rows (no draw routes to a row
    without a live handle, so content only needs valid shapes/dtypes)."""
    shapes = ((n + 1, torch.float32), (m, torch.int32), (n, torch.int32),
              (n, torch.int32), (m + 1, torch.int32), (m, torch.bool))
    return BatchedForest(*(torch.zeros((rows, w), dtype=dt, device=device)
                           for w, dt in shapes))


def _zeros_alias(rows: int, n: int, device) -> BatchedAlias:
    """Placeholder/cleared alias rows: ``q == 0`` with alias 0, inert even
    if read."""
    return BatchedAlias(
        q=torch.zeros((rows, n), dtype=torch.float32, device=device),
        alias=torch.zeros((rows, n), dtype=torch.int32, device=device))


class ForestPool:
    """A batched two-method sampling pool over power-of-two size-class
    arenas: radix forests for stream-sensitive (QMC) tenants, packed alias
    tables for bulk PRNG tenants, selected per tenant at admission.

    ``min_class`` floors the smallest padded size; ``m`` pins one guide
    resolution for every forest class (default: ``m = size`` per class);
    ``init_rows`` is the starting arena height, doubled on demand;
    ``policy`` the weight admission; ``device`` where the stacks live."""

    def __init__(self, min_class: int = 8, m: int | None = None,
                 init_rows: int = 4, policy: str = "reject", device="cuda"):
        if min_class < 1 or (min_class & (min_class - 1)):
            raise ValueError("min_class must be a positive power of two")
        self.min_class = min_class
        self._m = m
        self.init_rows = max(int(init_rows), 1)
        self.policy = check_policy(policy)
        self.device = resolve(device)
        self.classes: dict[int, _SizeClass] = {}
        self.alias_classes: dict[int, AliasArena] = {}
        # (method, size_class, row, version) of handles admitted under the
        # quarantine policy: serving a uniform placeholder.
        self.quarantined: set[tuple[str, int, int, int]] = set()

    # ------------------------------------------------------------- plumbing

    def _class_for(self, n: int, method: str = "forest") -> _Arena:
        if method not in METHODS:
            raise ValueError(f"unknown sampling method {method!r}; "
                             f"expected one of {METHODS}")
        size = _pow2_at_least(n, self.min_class)
        if method == "alias":
            ar = self.alias_classes.get(size)
            if ar is None:
                ar = self.alias_classes[size] = AliasArena(
                    size, self.init_rows, self.device)
            return ar
        sc = self.classes.get(size)
        if sc is None:
            sc = self.classes[size] = _SizeClass(
                size, self._m or size, self.init_rows, self.device)
        return sc

    def _check(self, h: Handle) -> _Arena:
        table = self.alias_classes if h.method == "alias" else self.classes
        sc = table.get(h.size_class)
        if sc is None or h.row not in sc.raw or sc.versions[h.row] != h.version:
            raise StaleHandleError(f"stale or evicted handle: {h}")
        return sc

    @staticmethod
    def _qkey(h: Handle) -> tuple[str, int, int, int]:
        return (h.method, h.size_class, h.row, h.version)

    def is_quarantined(self, handle: Handle) -> bool:
        """True if the (live) handle was admitted under ``quarantine`` and
        has not since been cleared by a clean ``update_weights``."""
        self._check(handle)
        return self._qkey(handle) in self.quarantined

    @staticmethod
    def _pad(w: np.ndarray, size: int) -> np.ndarray:
        return np.pad(w.astype(np.float32), (0, size - len(w)))

    def _rows(self, rows: list[int]) -> torch.Tensor:
        return torch.as_tensor(rows, dtype=torch.int64).to(self.device)

    def _write_rows(self, sc: _SizeClass, rows: list[int], built) -> None:
        if sc.forest is None:
            sc.forest = _zeros_forest(sc.rows, sc.size, sc.m, self.device)
        idx = self._rows(rows)
        for a, b in zip(sc.forest, built):
            a.index_copy_(0, idx, b)

    def _write_alias_rows(self, ar: AliasArena, rows: list[int], built) -> None:
        if ar.table is None:
            ar.table = _zeros_alias(ar.rows, ar.size, self.device)
        idx = self._rows(rows)
        for a, b in zip(ar.table, built):
            a.index_copy_(0, idx, b)

    # ------------------------------------------------------------ lifecycle

    def insert(self, weights, method: str = "forest") -> Handle:
        """Admit one tenant; see :meth:`insert_many` for the fused path."""
        return self.insert_many([weights], method=method)[0]

    def insert_many(self, weights_list, method="forest") -> list[Handle]:
        """Admit a group of tenants, building each (method, size class)
        group in one batched launch (forest groups in waves of at most
        ``WAVE_LEAF_CAP`` leaves). ``method`` is one method for the whole
        wave or a per-tenant sequence. Every row passes the admission
        policy first: under ``reject`` a bad row raises before any arena
        row is taken."""
        sanitized = [sanitize_weights(w, self.policy) for w in weights_list]
        raws = [r for r, _ in sanitized]
        methods = [method] * len(raws) if isinstance(method, str) else list(method)
        if len(methods) != len(raws):
            raise ValueError("method list must align with weights_list")
        norms = [normalize_weights(r) for r in raws]
        handles: list[Handle | None] = [None] * len(raws)
        by_group: dict[tuple[str, int], list[int]] = {}
        for i, w in enumerate(norms):
            ar = self._class_for(len(w), methods[i])
            by_group.setdefault((methods[i], ar.size), []).append(i)
        for (meth, size), idxs in by_group.items():
            ar = self._class_for(size, meth)
            rows = [ar.take_row() for _ in idxs]
            stack = np.stack([self._pad(norms[i], size) for i in idxs])
            flagged = np.zeros(len(idxs), bool)
            if meth == "alias":
                q, a = ops.alias_build_batched(to_device(stack, self.device))
                self._write_alias_rows(ar, rows, (q, a))
            else:
                per_wave = max(1, WAVE_LEAF_CAP // size)
                flags = []
                for s in range(0, len(idxs), per_wave):
                    built = build_forest_batched(
                        stack[s:s + per_wave], ar.m, device=self.device)
                    self._write_rows(ar, rows[s:s + per_wave], built)
                    flags.append(built.fallback.any(dim=1))
                # one sync per admission wave keeps the drain path sync-free
                flagged = torch.cat(flags).cpu().numpy()
            ar.builds += len(idxs)
            for i, row, flag in zip(idxs, rows, flagged):
                ar.n_true[row] = len(norms[i])
                ar.raw[row] = raws[i]
                if flag:
                    ar.degenerate_rows.add(row)
                handles[i] = Handle(size, row, len(norms[i]),
                                    int(ar.versions[row]), meth)
                if sanitized[i][1]:
                    self.quarantined.add(self._qkey(handles[i]))
        return handles  # type: ignore[return-value]

    def update_weights(self, handle: Handle, weights=None, *, delta=None) -> None:
        """In-place re-target of one tenant (full weights or a delta on the
        raw weights). Forest rows skip the rebuild when the new CDF has the
        same bits (one host sync); otherwise ``forest_delta_update`` gives
        the new separator distances and the row is rebuilt from them. Alias
        rows skip on unchanged padded float32 weight bits and otherwise
        re-pack the one row. The handle stays valid. The new raw row passes
        the admission policy; a clean update clears a quarantine flag."""
        sc = self._check(handle)
        if (weights is None) == (delta is None):
            raise ValueError("pass exactly one of weights or delta")
        for name, arr in (("weights", weights), ("delta", delta)):
            if arr is not None and np.asarray(arr).shape != (handle.n,):
                raise ValueError(
                    f"update keeps n fixed: handle has n={handle.n}, got "
                    f"{name} of shape {np.asarray(arr).shape} (scalars and "
                    f"padded-size arrays would silently broadcast)")
        old_raw = sc.raw[handle.row]
        if weights is None:
            proposed = np.asarray(old_raw, np.float64) + np.asarray(delta, np.float64)
        else:
            proposed = np.asarray(weights, np.float64)
        # reject raises here, before the shadow copy or any arena row moves
        raw, quarantine = sanitize_weights(proposed, self.policy)
        w = normalize_weights(raw)
        if quarantine:
            self.quarantined.add(self._qkey(handle))
        else:
            self.quarantined.discard(self._qkey(handle))
        sc.raw[handle.row] = raw
        if handle.method == "alias":
            new_row = self._pad(w, sc.size)
            old_row = self._pad(normalize_weights(old_raw), sc.size)
            if np.array_equal(new_row.view(np.uint32), old_row.view(np.uint32)):
                sc.skips += 1
                return
            q, a = ops.alias_build_batched(to_device(new_row[None], self.device))
            self._write_alias_rows(sc, [handle.row], (q, a))
            sc.rebuilds += 1
            return
        new_cdf = build_cdf(self._pad(w, sc.size), device=self.device)
        old_cdf = sc.forest.cdf[handle.row]
        # Skip keyed on raw CDF bits: the clamped lower bounds alone could
        # hide a move inside the last-ulp-below-1 region.
        if torch.equal(old_cdf.view(torch.int32), new_cdf.view(torch.int32)):
            sc.delta_skips += 1
            return
        d_new, _ = ops.forest_delta_update(
            lower_bounds(old_cdf).contiguous(), lower_bounds(new_cdf).contiguous(), sc.m)
        built = forest_from_cdf(new_cdf, sc.m, d=d_new, device=self.device)
        self._write_rows(sc, [handle.row], [a[None] for a in built])
        if bool(built.fallback.any()):
            sc.degenerate_rows.add(handle.row)
        else:
            sc.degenerate_rows.discard(handle.row)
        sc.delta_rebuilds += 1

    def evict(self, handle: Handle) -> None:
        """Release the tenant's row to its arena's free list. The version
        bump invalidates every outstanding handle to the row; forest rows
        drop their fallback flags, alias rows zero their packed table."""
        sc = self._check(handle)
        self.quarantined.discard(self._qkey(handle))
        sc.versions[handle.row] += 1
        sc.n_true[handle.row] = 0
        sc.raw.pop(handle.row, None)
        sc.free.append(handle.row)
        if handle.method == "alias":
            if sc.table is not None:
                sc.table.q[handle.row] = 0.0
                sc.table.alias[handle.row] = 0
            return
        if handle.row in sc.degenerate_rows:
            sc.degenerate_rows.discard(handle.row)
            sc.forest.fallback[handle.row] = False

    # ---------------------------------------------------------- persistence

    def snapshot(self) -> dict:
        """Full serving state as plain numpy nested dicts, in the JAX
        package's layout: every arena payload, free list, version counter,
        raw-weight shadow and quarantine flag."""

        def common(ar: _Arena) -> dict:
            return dict(
                size=ar.size, rows=ar.rows,
                n_true=ar.n_true.copy(), versions=ar.versions.copy(),
                free=list(ar.free),
                raw={int(r): np.asarray(v) for r, v in ar.raw.items()},
                builds=ar.builds, grows=ar.grows,
            )

        def host(stack):
            return None if stack is None else [x.cpu().numpy() for x in stack]

        classes = {}
        for size, sc in self.classes.items():
            d = common(sc)
            d.update(m=sc.m, degenerate_rows=set(sc.degenerate_rows),
                     delta_rebuilds=sc.delta_rebuilds,
                     delta_skips=sc.delta_skips, forest=host(sc.forest))
            classes[int(size)] = d
        alias_classes = {}
        for size, ar in self.alias_classes.items():
            d = common(ar)
            d.update(rebuilds=ar.rebuilds, skips=ar.skips, table=host(ar.table))
            alias_classes[int(size)] = d
        return dict(
            kind="forest_pool",
            policy=self.policy, min_class=self.min_class, m=self._m,
            init_rows=self.init_rows,
            quarantined=set(self.quarantined),
            classes=classes, alias_classes=alias_classes,
        )

    @classmethod
    def restore(cls, state: dict, device="cuda") -> "ForestPool":
        """Rebuild a pool on ``device`` from a snapshot of either package
        (live, or round-tripped through a checkpoint: sets may come back as
        lists). Handles issued by the snapshotted pool stay valid and later
        drains on the same handles and uniforms or slots are identical."""
        if state.get("kind") != "forest_pool":
            raise ValueError(f"not a ForestPool snapshot: {state.get('kind')!r}")
        pool = cls(min_class=state["min_class"], m=state["m"],
                   init_rows=state["init_rows"], policy=state["policy"],
                   device=device)
        pool.quarantined = {(str(k[0]), int(k[1]), int(k[2]), int(k[3]))
                            for k in state["quarantined"]}
        dev = pool.device

        def load_common(ar: _Arena, d: dict) -> None:
            ar.rows = int(d["rows"])
            ar.n_true = np.asarray(d["n_true"], np.int64).copy()
            ar.versions = np.asarray(d["versions"], np.int64).copy()
            ar.free = [int(r) for r in d["free"]]
            ar.raw = {int(r): np.asarray(v, np.float64) for r, v in d["raw"].items()}
            ar.builds, ar.grows = int(d["builds"]), int(d["grows"])

        def stack(arrays, kind):
            if arrays is None:
                return None
            return kind(*(to_device(np.ascontiguousarray(x), dev) for x in arrays))

        for size, d in state["classes"].items():
            sc = _SizeClass(int(d["size"]), int(d["m"]), 1, dev)
            load_common(sc, d)
            sc.degenerate_rows = {int(r) for r in d["degenerate_rows"]}
            sc.delta_rebuilds = int(d["delta_rebuilds"])
            sc.delta_skips = int(d["delta_skips"])
            sc.forest = stack(d["forest"], BatchedForest)
            pool.classes[int(size)] = sc
        for size, d in state["alias_classes"].items():
            ar = AliasArena(int(d["size"]), 1, dev)
            load_common(ar, d)
            ar.rebuilds, ar.skips = int(d["rebuilds"]), int(d["skips"])
            ar.table = stack(d["table"], BatchedAlias)
            pool.alias_classes[int(size)] = ar
        return pool

    # ------------------------------------------------------------- sampling

    def _drain_plan(self, handles):
        """Validate handles and number the drain's (method, size class)
        groups, forest groups first. Returns the forest sizes, the alias
        sizes (alias group ``i`` has number ``len(forest) + i``) and the
        per-lane ``(group, row, clip bound n - 1)`` int32 arrays on the
        device, from one host-to-device copy."""
        for h in set(handles):  # validate each distinct handle once
            self._check(h)
        ids: dict[tuple[str, int], int] = {}
        Q = len(handles)
        gid = np.fromiter((ids.setdefault((h.method, h.size_class), len(ids))
                           for h in handles), np.int32, Q)
        keys = sorted(ids, key=lambda k: k[0] != "forest")  # stable: first seen
        renumber = np.empty(len(ids), np.int32)
        renumber[[ids[k] for k in keys]] = np.arange(len(keys), dtype=np.int32)
        # rows padded to an even length keep each array 8-byte aligned
        lanes = np.zeros((3, (Q + 1) & ~1), np.int32)
        lanes[0, :Q] = renumber[gid]
        lanes[1, :Q] = np.fromiter((h.row for h in handles), np.int32, Q)
        lanes[2, :Q] = np.fromiter((h.n - 1 for h in handles), np.int32, Q)
        dev = to_device(lanes, self.device)[:, :Q]
        forest = [size for meth, size in keys if meth == "forest"]
        alias = [size for meth, size in keys if meth == "alias"]
        return forest, alias, (dev[0], dev[1], dev[2])

    def _guard_group(self, meth: str, size: int, rows: torch.Tensor) -> None:
        """Drain-time invariant screen (``guard=True``): the rows a group
        touches must hold a finite monotone [0, 1] CDF (forest) or a valid
        split/target table (alias). One host sync per group."""
        ridx = torch.unique(rows[rows >= 0]).long()
        if ridx.numel() == 0:
            return
        if meth == "alias":
            t = self.alias_classes[size].table
            q, a = t.q[ridx], t.alias[ridx]
            ok = (torch.isfinite(q).all() & (q >= 0.0).all() & (q <= 1.0).all()
                  & (a >= 0).all() & (a < size).all())
        else:
            cdf = self.classes[size].forest.cdf[ridx]
            ok = (torch.isfinite(cdf).all() & (torch.diff(cdf, dim=1) >= 0.0).all()
                  & (cdf[:, 0] == 0.0).all() & (cdf[:, -1] == 1.0).all())
        if not bool(ok):
            raise ValueError(f"guard: corrupted {meth} row(s) in size class {size}")

    def _drain(self, handles, guard: bool, coalesce: bool, alias_xi: torch.Tensor,
               **forest_inputs) -> np.ndarray:
        """The drain's launches: the guard screen group by group, then one
        forest launch over every forest group (at ``forest_inputs``: ``xi``,
        or ``counter`` and ``offset_bits``) and one alias launch over every
        alias group (at ``alias_xi``), each writing its lanes' clipped
        results in place; then the one device-to-host copy."""
        forest, alias, lanes = self._drain_plan(handles)
        gid, rows, _hi = lanes
        if guard:
            for g, (meth, size) in enumerate([("forest", s) for s in forest]
                                             + [("alias", s) for s in alias]):
                self._guard_group(meth, size, rows[gid == g])
        out = torch.empty(len(handles), dtype=torch.int32, device=self.device)
        if forest:
            ops.forest_sample_grouped([self.classes[s].forest for s in forest], lanes, out,
                                      coalesce=coalesce, **forest_inputs)
        if alias:
            ops.alias_sample_grouped([self.alias_classes[s].table for s in alias], lanes,
                                     out, alias_xi, g0=len(forest), coalesce=coalesce)
        return out.cpu().numpy()

    def sample(self, handles, xi, coalesce: bool = False,
               guard: bool = False) -> np.ndarray:
        """Bulk mixed-batch drain from host uniforms: draw q resolves
        ``xi[q]`` in ``handles[q]``'s distribution, with one
        ``forest_sample_batched`` launch over every forest size class and
        one ``alias_sample_batched`` launch over every alias size class
        (each for up to 32 classes), and one device-to-host copy. Results
        are clipped to each tenant's true range in the kernels. The drain
        does not sort its lanes by default: at its shape a tile of lanes
        shares almost no row, and the in-kernel sort costs more than it
        saves (``coalesce=True`` gives the same draws). Returns (Q,)
        int32."""
        xi = np.asarray(xi, np.float32)
        if len(handles) != len(xi):
            raise ValueError("handles and xi must align elementwise")
        xi_d = to_device(xi, self.device)
        return self._drain(handles, guard, coalesce, xi_d, xi=xi_d)

    def sample_streams(self, handles, slots, streams, coalesce: bool = False,
                       return_xi: bool = False, guard: bool = False):
        """The stream-aware bulk drain: draw q resolves ``slots[q]``'s next
        QMC stream point in ``handles[q]``'s distribution, the stream side
        on the card. ``streams`` follows the ``DeviceQmcStreams`` protocol:
        ``draw(slots)`` ranks duplicate slots, advances the counters on the
        device and returns the per-lane ``(counter, offset_bits, xi)``.
        Forest lanes take one ``forest_sample_batched_streams`` launch over
        every forest size class that recomputes the points in the kernel;
        alias lanes (legal, but they forfeit the stratification) take the
        pre-pass points through one ``alias_sample_batched`` launch. With
        ``return_xi`` also returns the (Q,) float32 points drawn."""
        slots = np.asarray(slots)
        if len(handles) != len(slots):
            raise ValueError("handles and slots must align elementwise")
        ctr, off, xi = streams.draw(slots)
        out = self._drain(handles, guard, coalesce, xi, counter=ctr, offset_bits=off)
        if return_xi:
            return out, xi.cpu().numpy()
        return out

    # ---------------------------------------------------------- inspection

    def forest_row(self, handle: Handle) -> RadixForest:
        """The tenant's padded forest as a single-distribution view."""
        if handle.method != "forest":
            raise ValueError(f"handle method is {handle.method!r}; use alias_row")
        return self._check(handle).forest.row(handle.row)

    def alias_row(self, handle: Handle) -> AliasTable:
        """The tenant's padded packed alias table as a single-distribution
        view."""
        if handle.method != "alias":
            raise ValueError(f"handle method is {handle.method!r}; use forest_row")
        return self._check(handle).table.row(handle.row)

    def weights(self, handle: Handle) -> np.ndarray:
        """Normalized float32 weights currently served for the tenant.
        Quarantined handles refuse (:class:`QuarantinedError`)."""
        sc = self._check(handle)
        if self._qkey(handle) in self.quarantined:
            raise QuarantinedError(
                f"handle is quarantined (serving uniform placeholder): {handle}")
        return normalize_weights(sc.raw[handle.row])

    def stats(self) -> dict:
        """Per-class occupancy/build counters and the pool's tenant count
        (``classes`` is the forest side, ``alias_classes`` the alias side)."""
        per = {
            size: dict(m=sc.m, rows=sc.rows, occupied=sc.occupied,
                       free=len(sc.free), builds=sc.builds,
                       delta_rebuilds=sc.delta_rebuilds,
                       delta_skips=sc.delta_skips, grows=sc.grows)
            for size, sc in sorted(self.classes.items())
        }
        aper = {
            size: dict(rows=ar.rows, occupied=ar.occupied, free=len(ar.free),
                       builds=ar.builds, rebuilds=ar.rebuilds, skips=ar.skips,
                       grows=ar.grows)
            for size, ar in sorted(self.alias_classes.items())
        }
        return dict(
            classes=per, alias_classes=aper,
            tenants=sum(sc.occupied for sc in self.classes.values())
            + sum(ar.occupied for ar in self.alias_classes.values()),
            policy=self.policy, quarantined=len(self.quarantined),
        )
