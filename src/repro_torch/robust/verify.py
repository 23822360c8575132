"""Structural self-checks for forests, alias tables and pool arenas: the
port of the JAX package's ``robust/verify.py``, with its invariants, its
messages and ``raise_on_error``.

- ``verify_forest``: the CDF is a finite monotone partition of [0, 1] with
  exact endpoints; ``cell_first`` is nondecreasing and in range; child
  refs are in range; with ``weights``, the CDF's bits equal
  ``build_cdf(weights)``'s.
- ``verify_alias``: split points ``q`` in [0, 1], alias targets in range,
  and with ``weights`` mass conservation: the implied mass of each cell
  ``q_i + sum_{j: alias_j == i} (1 - q_j)`` matches ``n`` times its
  normalized weight within ``16 * eps32 * n``, the rounding scale of
  float32 tapes that sum ``n`` cell masses. The JAX package applies that
  bound to probabilities (the masses over ``n``), which makes it ``n``
  times looser: at 65536 cells it passes tables whose cells have lost
  almost a whole cell's mass (ROADMAP C6). The port applies it to the
  masses, so it flags those tables; on its own tables the worst error is
  about ``eps32 * n`` (ROADMAP C6), and on exact (dyadic) rows both
  packages' verdicts agree.
- ``verify_pool``: free-list / version / shadow-copy consistency of every
  arena (no leaked or double-freed rows); with ``deep``, the forest and
  alias checks of every occupied row against its raw-weight shadow.

``verify_forest``/``verify_alias`` check one table on the host, as JAX
does. ``verify_pool`` checks the arenas where they live: per size class,
one gather of the occupied rows, one batched ``build_cdf`` over their
stacked padded weights (a row's bits are the same alone and in a stack)
and every invariant as one tensor expression over the rows, then one copy
of the per-row verdicts to the host. Its messages equal those of the
single-table checks row by row.

The CDF bit check is exact, so it holds a forest to the CDF that
*this package's* ``build_cdf`` computes. The port's scan sums in another
order than XLA's (ROADMAP C2): a pool built by the JAX package and
restored here can report ``cdf bits do not match build_cdf(weights)`` on
rows whose weights are not dyadic, though nothing is corrupt; on dyadic
rows, where both sums are exact, the two packages agree.

Each check returns a list of violation strings (empty = healthy); pass
``raise_on_error=True`` to turn violations into a ``ValueError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cdf import build_cdf, normalize_weights

__all__ = ["verify_forest", "verify_alias", "verify_pool"]

_EPS32 = float(np.finfo(np.float32).eps)


def _fail(errors: list[str], raise_on_error: bool):
    if errors and raise_on_error:
        raise ValueError("; ".join(errors))
    return errors


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def verify_forest(forest, weights=None, *, raise_on_error: bool = False):
    """Check one (padded) forest's structural invariants.

    ``forest`` is a :class:`~repro_torch.core.forest.RadixForest` (or any
    object with ``cdf``/``left``/``right``/``cell_first`` fields, tensors
    or arrays). With ``weights`` (the padded, normalized float32 row the
    forest was built from) the CDF is also checked bit for bit against
    ``build_cdf(weights)``, computed on the forest's device."""
    errors: list[str] = []
    cdf = _host(forest.cdf).astype(np.float32)
    n = cdf.shape[0] - 1
    if not np.isfinite(cdf).all():
        errors.append("cdf has non-finite entries")
    else:
        if cdf[0] != 0.0:
            errors.append(f"cdf[0] = {cdf[0]!r}, want exactly 0.0")
        if cdf[-1] != 1.0:
            errors.append(f"cdf[-1] = {cdf[-1]!r}, want exactly 1.0")
        if (np.diff(cdf) < 0).any():
            errors.append("cdf not monotone nondecreasing")
    cf = _host(forest.cell_first).astype(np.int64)
    if (np.diff(cf) < 0).any():
        errors.append("cell_first not nondecreasing (cells overlap)")
    if cf.size and (cf[0] < 0 or cf[-1] > n):
        errors.append(f"cell_first out of range [0, {n}]")
    for name in ("left", "right"):
        ch = _host(getattr(forest, name)).astype(np.int64)
        # >= 0: internal node id; < 0: ~interval leaf ref.
        leaf = np.where(ch < 0, ~ch, 0)
        node = np.where(ch >= 0, ch, 0)
        if (leaf >= n).any() or (node >= n).any():
            errors.append(f"{name} child refs out of range for n={n}")
    if weights is not None and not errors:
        want = build_cdf(np.asarray(weights, np.float32), device=_device_of(forest.cdf))
        want = want.cpu().numpy()
        if want.shape != cdf.shape or not np.array_equal(
            want.view(np.uint32), cdf.view(np.uint32)
        ):
            errors.append("cdf bits do not match build_cdf(weights)")
    return _fail(errors, raise_on_error)


def verify_alias(table, weights=None, *, raise_on_error: bool = False):
    """Check one (padded) packed alias table; with ``weights`` (the padded
    normalized row) also check each cell's implied mass against ``n``
    times its weight, within ``16 * eps32 * n``."""
    errors: list[str] = []
    q = _host(table.q).astype(np.float64)
    alias = _host(table.alias).astype(np.int64)
    n = q.shape[0]
    if not np.isfinite(q).all() or (q < 0.0).any() or (q > 1.0).any():
        errors.append("alias split points q outside [0, 1]")
    if (alias < 0).any() or (alias >= n).any():
        errors.append(f"alias targets out of range [0, {n})")
    if weights is not None and not errors:
        w = np.asarray(weights, np.float64)
        # implied mass: own kept fraction + every donation received
        mass = q + np.bincount(alias, weights=1.0 - q, minlength=n)
        tol = 16.0 * _EPS32 * max(n, 1)
        err = np.abs(mass - n * w / max(w.sum(), 1e-300)).max()
        if err > tol:
            errors.append(
                f"alias table does not conserve mass (max err {err:.3e} > {tol:.3e})")
    return _fail(errors, raise_on_error)


def _forest_rows(forest, rows: list[int], padded: np.ndarray) -> list[list[str]]:
    """:func:`verify_forest`'s verdict on arena rows ``rows`` of a stacked
    forest against their padded normalized weights ``padded`` (R, size),
    computed on the arena's device for all rows at once."""
    dev = forest.cdf.device
    idx = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    cdf = forest.cdf[idx]
    n = cdf.shape[1] - 1
    cf = forest.cell_first[idx].to(torch.int64)

    def refs_out(ch):
        ch = ch.to(torch.int64)
        leaf = torch.where(ch < 0, ~ch, 0)
        node = torch.where(ch >= 0, ch, 0)
        return ((leaf >= n) | (node >= n)).any(1)

    want = build_cdf(torch.from_numpy(np.ascontiguousarray(padded, np.float32)).to(dev),
                     device=dev)
    flags = torch.stack([
        ~torch.isfinite(cdf).all(1), cdf[:, 0] != 0.0, cdf[:, -1] != 1.0,
        (torch.diff(cdf, dim=1) < 0).any(1), (torch.diff(cf, dim=1) < 0).any(1),
        (cf[:, 0] < 0) | (cf[:, -1] > n), refs_out(forest.left[idx]),
        refs_out(forest.right[idx]),
        (want.view(torch.int32) != cdf.view(torch.int32)).any(1),
    ], 1).cpu().numpy()
    ends = torch.stack([cdf[:, 0], cdf[:, -1]], 1).cpu().numpy()
    out = []
    for r in range(len(rows)):
        (nonfinite, first, last, mono, cf_mono, cf_range, left, right, bits) = flags[r]
        e = []
        if nonfinite:
            e.append("cdf has non-finite entries")
        else:
            if first:
                e.append(f"cdf[0] = {ends[r, 0]!r}, want exactly 0.0")
            if last:
                e.append(f"cdf[-1] = {ends[r, 1]!r}, want exactly 1.0")
            if mono:
                e.append("cdf not monotone nondecreasing")
        if cf_mono:
            e.append("cell_first not nondecreasing (cells overlap)")
        if cf_range:
            e.append(f"cell_first out of range [0, {n}]")
        if left:
            e.append(f"left child refs out of range for n={n}")
        if right:
            e.append(f"right child refs out of range for n={n}")
        if bits and not e:
            e.append("cdf bits do not match build_cdf(weights)")
        out.append(e)
    return out


def _alias_rows(table, rows: list[int], padded: np.ndarray) -> list[list[str]]:
    """:func:`verify_alias`'s verdict on arena rows ``rows`` of a stacked
    alias table, on the arena's device for all rows at once (float64)."""
    dev = table.q.device
    idx = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    q = table.q[idx].to(torch.float64)
    alias = table.alias[idx].to(torch.int64)
    n = q.shape[1]
    bad_q = ~torch.isfinite(q).all(1) | (q < 0.0).any(1) | (q > 1.0).any(1)
    bad_a = (alias < 0).any(1) | (alias >= n).any(1)
    w = torch.from_numpy(np.asarray(padded, np.float64)).to(dev)
    mass = q + torch.zeros_like(q).scatter_add_(1, alias.clamp(0, n - 1), 1.0 - q)
    err = (mass - n * w / w.sum(1, keepdim=True).clamp(min=1e-300)).abs().amax(1)
    tol = 16.0 * _EPS32 * max(n, 1)
    flags = torch.stack([bad_q, bad_a], 1).cpu().numpy()
    err = err.cpu().numpy()
    out = []
    for r in range(len(rows)):
        e = []
        if flags[r, 0]:
            e.append("alias split points q outside [0, 1]")
        if flags[r, 1]:
            e.append(f"alias targets out of range [0, {n})")
        if not e and err[r] > tol:
            e.append(f"alias table does not conserve mass (max err {err[r]:.3e} > {tol:.3e})")
        out.append(e)
    return out


def _verify_arena(kind: str, size: int, ar, errors: list[str]) -> None:
    free = list(ar.free)
    if len(set(free)) != len(free):
        errors.append(f"{kind}[{size}]: duplicate rows in free list")
    occupied = set(ar.raw.keys())
    allr = set(range(ar.rows))
    if not set(free).issubset(allr) or not occupied.issubset(allr):
        errors.append(f"{kind}[{size}]: row index out of range")
    if set(free) & occupied:
        errors.append(f"{kind}[{size}]: free rows also occupied")
    if (set(free) | occupied) != allr:
        errors.append(f"{kind}[{size}]: leaked rows (neither free nor occupied)")
    for row in occupied:
        nt = int(ar.n_true[row])
        if not (0 < nt <= ar.size):
            errors.append(f"{kind}[{size}] row {row}: bad n_true {nt}")
        if len(ar.raw[row]) != nt:
            errors.append(f"{kind}[{size}] row {row}: raw shadow length mismatch")
    if (np.asarray(ar.versions) < 0).any():
        errors.append(f"{kind}[{size}]: negative version counter")


def _padded(ar, rows: list[int]) -> np.ndarray:
    """(R, size) float32: each row's normalized raw shadow, zero-padded."""
    out = np.zeros((len(rows), ar.size), np.float32)
    for i, row in enumerate(rows):
        w = normalize_weights(ar.raw[row])
        out[i, :len(w)] = w
    return out


def verify_pool(pool, *, deep: bool = True, raise_on_error: bool = False):
    """Check every arena of a :class:`~repro_torch.pool.ForestPool`.

    Always checks the slot machine (free list / version / shadow-copy
    consistency); with ``deep`` also re-derives each occupied row's padded
    normalized weights from the raw shadow and runs the forest / alias
    checks against them, batched per size class on the pool's device."""
    errors: list[str] = []
    for size, sc in sorted(pool.classes.items()):
        _verify_arena("forest", size, sc, errors)
        if not deep or sc.forest is None or not sc.raw:
            continue
        rows = sorted(sc.raw)
        for row, errs in zip(rows, _forest_rows(sc.forest, rows, _padded(sc, rows))):
            errors += [f"forest[{size}] row {row}: {e}" for e in errs]
    for size, ar in sorted(pool.alias_classes.items()):
        _verify_arena("alias", size, ar, errors)
        if not deep or ar.table is None or not ar.raw:
            continue
        rows = sorted(ar.raw)
        for row, errs in zip(rows, _alias_rows(ar.table, rows, _padded(ar, rows))):
            errors += [f"alias[{size}] row {row}: {e}" for e in errs]
    return _fail(errors, raise_on_error)
