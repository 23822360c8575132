"""Batched sampling pool for multi-tenant serving: batched construction
(radix forests and packed alias tables), size-class arenas on the card, and
bulk mixed-batch drains, with the sampling method (monotone forest or O(1)
alias) a per-tenant attribute. Kernels on this path: ``cdf_scan`` and
``forest_delta`` (batched build), ``forest_delta_update`` (updates),
``alias_build_batched`` (alias admission and updates),
``forest_sample_batched``, ``forest_sample_batched_streams`` and
``alias_sample_batched`` (drains)."""
from .arena import AliasArena, ForestPool, Handle
from .batched import (
    BatchedAlias,
    BatchedForest,
    batched_from_row_forest,
    build_alias_batched,
    build_forest_batched,
    build_forest_batched_from_cdf,
    sample_alias_batched,
    sample_forest_batched,
)

__all__ = [
    "AliasArena",
    "BatchedAlias",
    "BatchedForest",
    "ForestPool",
    "Handle",
    "batched_from_row_forest",
    "build_alias_batched",
    "build_forest_batched",
    "build_forest_batched_from_cdf",
    "sample_alias_batched",
    "sample_forest_batched",
]
