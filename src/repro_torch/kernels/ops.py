"""Kernel entry points over the port's data structures.

Each wrapper dispatches on its tensors' device: CPU tensors run the plain
PyTorch version, CUDA tensors launch the hand-written kernel or raise. The
batched entry points take any object with the stacked fields
(``BatchedForest``: cdf, table, left, right, cell_first, fallback;
``BatchedAlias``: q, alias), so the kernel layer never imports the pool
layer. The batched descent always receives the side tables, so no host
round trip asks whether any row flagged a cell.
"""
from __future__ import annotations

import torch

from repro_torch.core.forest import RadixForest

from .alias_build import alias_build_batched as _alias_build_batched
from .alias_sample import alias_sample_batched as _alias_sample_batched
from .alias_sample import alias_sample_grouped as _alias_sample_grouped
from .cdf_scan import cdf_scan
from .flash_attention import flash_attention as _flash_attention
from .forest_delta import forest_delta as _forest_delta
from .forest_delta import forest_delta_update as _forest_delta_update
from .forest_sample import forest_sample as _forest_sample
from .forest_sample import forest_sample_batched as _forest_sample_batched
from .forest_sample import (
    forest_sample_batched_streams as _forest_sample_batched_streams,
)
from .forest_sample import forest_sample_grouped as _forest_sample_grouped
from .sample_tiled import sample_rows as _sample_rows


def fused_cdf(x: torch.Tensor, softmax: bool = True) -> torch.Tensor:
    """(B, V) logits/weights -> (B, V) inclusive CDF rows."""
    return cdf_scan(x, softmax=softmax)


def sample_rows(cdf_rows: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Per-row inverse CDF: (B, V) x (B, k) -> (B, k) int32 indices."""
    return _sample_rows(cdf_rows, xi)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Online-softmax attention, forward only: q (B, Sq, H, hd), k/v
    (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's dtype (GQA ``h // (H/KV)``)."""
    return _flash_attention(q, k, v, causal=causal)


def forest_sample(forest: RadixForest, xi: torch.Tensor) -> torch.Tensor:
    """Shared-distribution Algorithm 2 over a batch of uniforms, with the
    forest's degenerate-cell pre-resolution always on."""
    return _forest_sample(
        forest.cdf, forest.table, forest.left, forest.right,
        forest.cell_first, forest.fallback, xi,
    )


def forest_delta(data: torch.Tensor, m: int) -> torch.Tensor:
    """Separator distances for forest construction."""
    return _forest_delta(data, m)


def forest_delta_update(data_old: torch.Tensor, data_new: torch.Tensor, m: int):
    """New separator distances + changed-leaf-bits mask for a weight update."""
    return _forest_delta_update(data_old, data_new, m)


def _stack(forest):
    return (forest.cdf, forest.table, forest.left, forest.right,
            forest.cell_first, forest.fallback)


def forest_sample_batched(forest, dist_id: torch.Tensor, xi: torch.Tensor,
                          coalesce: bool = True) -> torch.Tensor:
    """Mixed-batch Algorithm 2 over B stacked forests (one launch). Lanes
    with ``dist_id < 0`` are sentinels resolved to 0; ``coalesce`` toggles
    the kernel's in-tile sort (elementwise identical either way)."""
    return _forest_sample_batched(*_stack(forest), dist_id, xi, coalesce=coalesce)


def forest_sample_batched_streams(forest, dist_id: torch.Tensor,
                                  counter: torch.Tensor, offset_bits: torch.Tensor,
                                  coalesce: bool = True):
    """Stream-aware mixed-batch drain: QMC state in, ``(idx, xi)`` out."""
    return _forest_sample_batched_streams(
        *_stack(forest), dist_id, counter, offset_bits, coalesce=coalesce)


def alias_build_batched(weights: torch.Tensor):
    """Batched split-and-pack alias construction: (B, n) stacked weights ->
    packed ``(q, alias)`` (B, n) stacks, one call."""
    return _alias_build_batched(weights)


def alias_sample_batched(table, dist_id: torch.Tensor, xi: torch.Tensor,
                         coalesce: bool = True) -> torch.Tensor:
    """Mixed-batch O(1) alias drain over B stacked tables (one launch)."""
    return _alias_sample_batched(table.q, table.alias, dist_id, xi, coalesce=coalesce)


def forest_sample_grouped(forests, lanes, out: torch.Tensor, *, xi=None, counter=None,
                          offset_bits=None, g0: int = 0, coalesce: bool = True) -> None:
    """The forest lanes of a drain over several size classes: ``lanes`` is
    ``(gid, row, hi)``, (Q,) int32 each; lane ``q`` of group ``gid[q] - g0``
    descends row ``row[q]`` of ``forests[gid[q] - g0]`` at ``xi[q]`` (or at
    its QMC point) and ``min(idx, hi[q])`` goes to ``out[q]``. One launch for
    every 32 groups."""
    _forest_sample_grouped([_stack(f) for f in forests], *lanes, out, xi=xi,
                           counter=counter, offset_bits=offset_bits, g0=g0,
                           coalesce=coalesce)


def alias_sample_grouped(tables, lanes, out: torch.Tensor, xi: torch.Tensor,
                         g0: int = 0, coalesce: bool = True) -> None:
    """The alias lanes of a drain over several size classes, as
    :func:`forest_sample_grouped` over packed ``(q, alias)`` tables."""
    _alias_sample_grouped([(t.q, t.alias) for t in tables], *lanes, out, xi, g0=g0,
                          coalesce=coalesce)
