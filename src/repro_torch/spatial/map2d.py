"""Piecewise-constant 2-D serving: environment and density maps as a row
marginal forest plus power-of-two size-class stacks of conditional rows.

The paper's target application (Sec. 5) samples a 2-D piecewise-constant
distribution, an HDR environment map, as a product: a *marginal* over rows
(one CDF of the row masses) and one *conditional* per row (that row's
texels). :class:`Map2DSampler` serves that decomposition in bulk on one
card:

* **Marginal**: one :class:`~repro_torch.core.forest.RadixForest` over the
  H row masses, packed once per forest for the ``forest_sample`` kernel
  (B1) through :class:`~repro_torch.core.sample.PackedForestHolder`.
* **Conditionals**: the H rows grouped into power-of-two width classes
  (texel weights zero-padded to the class width), each class one CDF stack
  (``cdf_scan``, B3), one :func:`~repro_torch.core.forest2d.build_forest_rows`
  pass (B2 for the distances) and
  :func:`~repro_torch.pool.batched.batched_from_row_forest`.

:meth:`Map2DSampler.sample_map` descends the marginal at ``u`` (B1), gathers
each lane's class slot and width on the device, and resolves every
conditional draw at ``v`` in one grouped ``forest_sample_batched`` launch
(B5) over the classes, clipped to the row's true width in the kernel. A
map of one class makes no host synchronization between the four steps;
a map of several makes one, to report the classes its draws touched.
Zero-mass rows are never selected: their marginal intervals have zero
width, which no uniform in [0, 1) can hit.

:meth:`Map2DSampler.update_map` re-targets a sparse set of rows in O(dirty
rows): per touched class, rows whose new CDF bits are unchanged skip, the
dirty rows rebuild in one ``build_forest_rows`` pass and are scattered into
the class stack, bit-equal to a from-scratch build because rows of the flat
builder never interact. The marginal rebuilds from the distances of the
``forest_delta_update`` kernel (B4), unless its CDF bits did not move.

The port of the JAX package's ``spatial/map2d.py``, unsharded: the sharded
marginal waits for ``dist.forest`` (ROADMAP A4).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cdf import build_cdf, lower_bounds, normalize_weights
from repro_torch.core.forest import forest_from_cdf
from repro_torch.core.forest2d import build_forest_rows
from repro_torch.core.sample import PackedForestHolder, sample_forest
from repro_torch.device import resolve, to_device
from repro_torch.kernels import ops
from repro_torch.pool.arena import _pow2_at_least
from repro_torch.pool.batched import BatchedForest, batched_from_row_forest
from repro_torch.robust.validate import check_policy, sanitize_weights


class _CondClass:
    """One conditional size class: every map row of padded width ``width``
    stacked into one :class:`BatchedForest` (slot ``s`` holds map row
    ``row_ids[s]``), whose ``cdf`` rows are the update's skip key, and the
    degenerate flag read once a build (for ``stats``)."""

    def __init__(self, width: int, row_ids: list[int], forest: BatchedForest):
        self.width = width           # padded texel count = per-row guide m
        self.row_ids = row_ids       # slot -> map row
        self.forest = forest
        self.degenerate = bool(forest.fallback.any())
        self.rebuilds = 0            # update_map: rows actually rebuilt
        self.skips = 0               # update_map: bit-unchanged rows


def _class_forest(cdf_rows: torch.Tensor, wc: int, fallback_slack: int) -> BatchedForest:
    rf = build_forest_rows(cdf_rows, m=wc, fallback_slack=fallback_slack,
                           device=cdf_rows.device)
    return batched_from_row_forest(rf, cdf_rows)


class Map2DSampler(PackedForestHolder):
    """Bulk 2-D piecewise-constant sampling over an environment or density
    map, on ``device``.

    ``img`` is a 2-D array (H, W) or a ragged list of 1-D weight rows (each
    row lands in its power-of-two size class, floored at ``min_class``).
    Weights must be non-negative with positive total mass; a row may be
    all-zero and is then exactly unselectable. ``m_marginal`` sets the
    marginal's guide cells (default: one a row). ``policy`` is the
    admission policy of :mod:`repro_torch.robust` (``reject`` | ``clamp`` |
    ``quarantine`` | ``off``); an all-zero row is not a violation here.
    ``coalesce`` sorts each block's lanes in the descent kernel (the draws
    are the same either way). ``forest`` (from the base class) is the
    marginal."""

    def __init__(self, img, *, m_marginal: int | None = None, min_class: int = 8,
                 sharded: bool = False, coalesce: bool = True, fallback_slack: int = 2,
                 policy: str = "reject", device="cuda"):
        if sharded:
            raise NotImplementedError(
                "sharded Map2DSampler is not ported yet (ROADMAP A4)")
        if min_class < 1 or (min_class & (min_class - 1)):
            raise ValueError("min_class must be a positive power of two")
        self.device = resolve(device)
        self.policy = check_policy(policy)
        rows = [np.asarray(r, np.float64) for r in img]
        if not rows:
            raise ValueError("map must have at least one row")
        self.rows_raw = [sanitize_weights(w, policy, allow_zero_total=True)[0] for w in rows]
        self.H = len(rows)
        self.widths = np.asarray([len(w) for w in self.rows_raw], np.int64)
        self.row_offsets = np.concatenate([[0], np.cumsum(self.widths)]).astype(np.int64)
        self.row_mass = np.asarray([w.sum() for w in self.rows_raw], np.float64)
        self.min_class = min_class
        self.fallback_slack = fallback_slack
        self.coalesce = coalesce
        self.last_drain: dict | None = None

        # marginal over row masses (zero-mass rows: zero-width intervals)
        self.m_marginal = int(m_marginal) if m_marginal else self.H
        self.forest = forest_from_cdf(
            build_cdf(normalize_weights(self.row_mass), device=self.device),
            self.m_marginal, fallback_slack, device=self.device)

        # conditionals: one CDF stack and one row-forest pass a class
        self.classes: dict[int, _CondClass] = {}
        self._class_of = np.empty(self.H, np.int64)  # row -> class width
        self._slot_of = np.empty(self.H, np.int64)   # row -> slot in class
        by_class: dict[int, list[int]] = {}
        for r in range(self.H):
            by_class.setdefault(_pow2_at_least(int(self.widths[r]), min_class), []).append(r)
        group_of = np.empty(self.H, np.int64)
        for g, (wc, rids) in enumerate(sorted(by_class.items())):
            cdf_rows = build_cdf(np.stack([self._padded_cond(r, wc) for r in rids]),
                                 device=self.device)
            self.classes[wc] = _CondClass(wc, rids, _class_forest(cdf_rows, wc, fallback_slack))
            self._class_of[rids] = wc
            self._slot_of[rids] = np.arange(len(rids))
            group_of[rids] = g
        # per-row lane tables of the drain: group, slot, clip bound; flat ids
        lanes = np.stack([group_of, self._slot_of, self.widths - 1]).astype(np.int32)
        self._group_t, self._slot_t, self._hi_t = to_device(lanes, self.device)
        self._offsets_t = to_device(self.row_offsets, self.device)

    # ------------------------------------------------------------- plumbing

    def _padded_cond(self, r: int, wc: int) -> np.ndarray:
        """Row ``r``'s conditional weights, normalized and zero-padded to the
        class width. A zero-mass row gets a uniform placeholder: the
        marginal never selects it, but its slot needs a distribution."""
        w = self.rows_raw[r]
        if self.row_mass[r] <= 0:
            w = np.ones(len(w), np.float64)
        w32 = normalize_weights(w)
        return np.pad(w32, (0, wc - len(w32)))

    def flat_index(self, rows, cols):
        """(row, col) pairs -> flat texel ids over the ragged map layout: an
        int64 tensor on the device for tensors, numpy otherwise."""
        if isinstance(rows, torch.Tensor):
            return self._offsets_t[rows.long()] + cols.long()
        return self.row_offsets[np.asarray(rows)] + np.asarray(cols)

    # ------------------------------------------------------------- sampling

    def _uv(self, points2d):
        if isinstance(points2d, tuple):
            u, v = points2d
        else:
            pts = to_device(points2d, self.device, torch.float32)
            if pts.dim() != 2 or pts.shape[1] != 2:
                raise ValueError("points2d must have shape (B, 2)")
            u, v = pts[:, 0], pts[:, 1]
        return (to_device(u, self.device, torch.float32).contiguous(),
                to_device(v, self.device, torch.float32).contiguous())

    def sample_map(self, points2d):
        """Bulk 2-D drain: ``points2d`` (B, 2) uniforms or a ``(u, v)`` pair
        (numpy or tensors) -> ``(row, col, u, v)``, int32/int32/float32/
        float32 tensors on the device. ``u`` descends the row marginal, ``v``
        the selected rows' conditionals in one grouped launch over the size
        classes (``self.last_drain`` records it). Elementwise equal to the
        per-row ``build_forest`` + ``sample_forest`` reference over the
        padded rows."""
        u, v = self._uv(points2d)
        row = sample_forest(self.forest, u, device=self.device, packed=self._packed)
        r = row.long()
        fused = len(self.classes) == 1
        lanes = (None if fused else self._group_t[r], self._slot_t[r], self._hi_t[r])
        col = torch.empty_like(row)
        forests = [c.forest for c in self.classes.values()]
        ops.forest_sample_grouped(forests, lanes, col, xi=v, coalesce=self.coalesce)
        if fused:
            touched = [next(iter(self.classes))]
        else:  # the one host synchronization of a drain over several classes
            widths = list(self.classes)
            touched = [widths[g] for g in torch.unique(lanes[0]).tolist()]
        self.last_drain = dict(
            launches=-(-len(forests) // 32), fused=fused, classes=touched,
            marginal="fused" if fused else "direct")
        return row, col, u, v

    # -------------------------------------------------------------- updates

    def update_map(self, delta_rows: dict, *, delta: bool = False) -> dict:
        """Re-target a sparse set of rows: ``delta_rows`` maps row -> new raw
        weights (or an additive delta with ``delta=True``); widths stay
        fixed. Per touched class, rows whose new CDF bits are unchanged
        skip; the dirty rows rebuild in one ``build_forest_rows`` pass and
        scatter into the class stack, bit-equal to a from-scratch
        :class:`Map2DSampler` over the new map. The marginal rebuilds from
        ``forest_delta_update``'s distances unless its CDF bits are
        unchanged. Returns ``rebuilt_rows``, ``skipped_rows``,
        ``cond_launches`` (row-forest passes) and ``marginal_rebuilt``."""
        by_class: dict[int, list[int]] = {}
        for r, w in delta_rows.items():
            r = int(r)
            if not 0 <= r < self.H:
                raise ValueError(f"row {r} out of range")
            w = np.asarray(w, np.float64)
            if w.shape != (int(self.widths[r]),):
                raise ValueError(
                    f"update keeps widths fixed: row {r} has width "
                    f"{int(self.widths[r])}, got shape {w.shape}")
            raw = self.rows_raw[r] + w if delta else w
            # the construction's admission policy, before any state moves
            raw = sanitize_weights(raw, self.policy, allow_zero_total=True)[0]
            self.rows_raw[r] = raw
            self.row_mass[r] = raw.sum()
            by_class.setdefault(int(self._class_of[r]), []).append(r)

        stats = dict(rebuilt_rows=0, skipped_rows=0, cond_launches=0,
                     marginal_rebuilt=False)
        for wc, rids in sorted(by_class.items()):
            cls = self.classes[wc]
            slots = to_device(self._slot_of[rids], self.device)
            new_cdf = build_cdf(np.stack([self._padded_cond(r, wc) for r in rids]),
                                device=self.device)
            moved = (cls.forest.cdf[slots].view(torch.int32)
                     != new_cdf.view(torch.int32)).any(dim=1)
            dirty = torch.nonzero(moved).flatten()
            n_dirty = int(dirty.numel())
            stats["skipped_rows"] += len(rids) - n_dirty
            cls.skips += len(rids) - n_dirty
            if n_dirty == 0:
                continue
            built = _class_forest(new_cdf[dirty], wc, self.fallback_slack)
            idx = slots[dirty]
            for a, b in zip(cls.forest, built):
                a[idx] = b
            cls.degenerate = bool(cls.forest.fallback.any())
            cls.rebuilds += n_dirty
            stats["rebuilt_rows"] += n_dirty
            stats["cond_launches"] += 1

        new_cdf = build_cdf(normalize_weights(self.row_mass), device=self.device)
        old_cdf = self.forest.cdf
        if torch.equal(old_cdf.view(torch.int32), new_cdf.view(torch.int32)):
            return stats
        d_new, _ = ops.forest_delta_update(lower_bounds(old_cdf), lower_bounds(new_cdf),
                                           self.m_marginal)
        self.forest = forest_from_cdf(new_cdf, self.m_marginal, self.fallback_slack,
                                      d=d_new, device=self.device)
        stats["marginal_rebuilt"] = True
        return stats

    # ---------------------------------------------------------- inspection

    def stats(self) -> dict:
        """Per-class shape and update counters and the marginal's size."""
        return dict(
            H=self.H,
            m_marginal=self.m_marginal,
            sharded=False,
            policy=self.policy,
            classes={
                wc: dict(rows=len(c.row_ids), rebuilds=c.rebuilds,
                         skips=c.skips, degenerate=c.degenerate)
                for wc, c in sorted(self.classes.items())
            },
        )
