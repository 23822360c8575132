"""Batched construction and sampling: B distributions per launch.

:class:`BatchedForest` stacks B radix forests of one (n, m) shape class
row-major and :class:`BatchedAlias` B packed alias tables; every reference
in a row is row-local, so row ``b`` is exactly the single-distribution
structure of distribution ``b``. The batched builds run every row in one
pass: the forest build as one flat ``forest_from_cdf`` over the stacked
CDFs (row boundaries carry the sentinel distance), the alias build as one
``alias_build_batched`` call. The drains resolve a mixed ``(dist_id,
uniform)`` batch with one kernel launch each.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.alias import AliasTable
from repro_torch.core.cdf import build_cdf
from repro_torch.core.forest import RadixForest, forest_from_cdf
from repro_torch.device import to_device
from repro_torch.kernels import ops


class BatchedAlias(NamedTuple):
    """B stacked packed alias tables over a shared size class (8 bytes a
    cell). Row ``b`` is the :class:`AliasTable` of distribution ``b``."""

    q: torch.Tensor      # (B, n) f32 split point within each cell
    alias: torch.Tensor  # (B, n) i32 second interval of each cell

    @property
    def batch(self) -> int:
        return self.q.shape[0]

    @property
    def n(self) -> int:
        return self.q.shape[1]

    def row(self, b: int) -> AliasTable:
        return AliasTable(self.q[b], self.alias[b])


class BatchedForest(NamedTuple):
    """B stacked radix forests over a shared (n, m) shape class, with
    row-local references: row ``b`` is the :class:`RadixForest` of
    distribution ``b``."""

    cdf: torch.Tensor         # (B, n+1) f32
    table: torch.Tensor       # (B, m)   i32
    left: torch.Tensor        # (B, n)   i32
    right: torch.Tensor       # (B, n)   i32
    cell_first: torch.Tensor  # (B, m+1) i32
    fallback: torch.Tensor    # (B, m)   bool

    @property
    def batch(self) -> int:
        return self.left.shape[0]

    @property
    def n(self) -> int:
        return self.left.shape[1]

    @property
    def m(self) -> int:
        return self.table.shape[1]

    def row(self, b: int) -> RadixForest:
        return RadixForest(*(x[b] for x in self))


def build_forest_batched_from_cdf(
    cdf, m: int, fallback_slack: int = 2, device="cuda"
) -> BatchedForest:
    """(B, n+1) stacked CDFs -> B forests in one flat pass; row ``b`` is
    bit-identical to ``forest_from_cdf(cdf[b], m)``."""
    cdf = to_device(cdf, device, torch.float32)
    return BatchedForest(*forest_from_cdf(cdf.reshape(-1, cdf.shape[-1]), m,
                                          fallback_slack, device=device))


def build_forest_batched(
    weights, m: int, fallback_slack: int = 2, device="cuda"
) -> BatchedForest:
    """(B, n) weights -> B forests: one batched CDF scan (each row's bits
    equal its own ``build_cdf``) and one flat forest pass; row ``b`` is
    bit-identical to ``build_forest(weights[b], m)``."""
    w = to_device(weights, device, torch.float32)
    return build_forest_batched_from_cdf(build_cdf(w, device=device), m,
                                         fallback_slack, device=device)


def batched_from_row_forest(rows, cdf_rows) -> BatchedForest:
    """A flat :class:`repro_torch.core.forest2d.RowForest` as a
    :class:`BatchedForest`: the one-pass multi-row build feeding the batched
    descent. The flat layout's global references become row-local by a
    per-row offset (``v - r*W`` for a node id, ``v + r*W`` for a leaf
    ``~i``). ``cdf_rows`` must be the (R, W+1) CDF stack the forest was built
    from: the descent compares against the unclamped CDF, as a single build
    does. Row ``r`` is bit-equal to ``forest_from_cdf(cdf_rows[r], m)``,
    fallback flags included."""
    from repro_torch.core.forest2d import row_local

    cdf = to_device(cdf_rows, rows.data.device, torch.float32)
    return BatchedForest(*row_local(rows, cdf))


def sample_forest_batched(forest: BatchedForest, dist_id, xi,
                          coalesce: bool = True) -> torch.Tensor:
    """Draw ``q`` resolves ``xi[q]`` in distribution ``dist_id[q]``'s tree,
    one launch for the whole batch."""
    dev = forest.cdf.device
    return ops.forest_sample_batched(
        forest, to_device(dist_id, dev, torch.int32),
        to_device(xi, dev, torch.float32), coalesce=coalesce)


def build_alias_batched(weights, device="cuda") -> BatchedAlias:
    """(B, n) weights -> B packed alias tables in one call."""
    return BatchedAlias(*ops.alias_build_batched(
        to_device(weights, device, torch.float32)))


def sample_alias_batched(table: BatchedAlias, dist_id, xi,
                         coalesce: bool = True) -> torch.Tensor:
    """Draw ``q`` resolves ``xi[q]`` in distribution ``dist_id[q]``'s packed
    table: O(1) a lane, one launch for the whole batch."""
    dev = table.q.device
    return ops.alias_sample_batched(
        table, to_device(dist_id, dev, torch.int32),
        to_device(xi, dev, torch.float32), coalesce=coalesce)
