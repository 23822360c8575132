"""Batched split-and-pack alias construction: B packed tables in one call.

For a CUDA tensor this launches the hand-written kernel
``csrc/alias_build.cu``; for a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.ref_alias_build_batched`. The kernel cuts
each row into tiles of 2048 cells, one block a tile, and builds in four
launches (tile sums, tile records, tapes from carries summed in tile
order, searches in windows of the tapes) with no look-back and no float
atomics, so a row's table depends on the row and ``n`` alone; a row of up
to one tile is one block in one launch.

Both carry the demand and supply tapes in float64 (the per-cell terms stay
float32, as in the JAX core): float32 tapes misroute whole cells on rows of
65536. The kernel sums in another order than ``torch.cumsum``, so the two
agree bit for bit where every partial sum is exact (dyadic weights, where
both also equal :func:`repro_torch.core.alias.build_alias_parallel` and the
JAX core); on other rows both tables are valid (``0 <= q <= 1``,
``0 <= alias < n``) and conserve each cell's mass ``n*p`` to float32
rounding, the row's normalization residue included (the float32 ``n*p``
sum to ``n`` within a few ulps of ``n``).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import ref_alias_build_batched


def alias_build_batched(weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, n) float32 weights -> packed ``(q, alias)`` (B, n) float32 / int32.
    Rows without both light and heavy cells come back as identity tables."""
    if weights.dim() != 2 or weights.dtype != torch.float32:
        raise ValueError("alias_build_batched: weights must be a 2-D float32 tensor")
    if not weights.is_cuda:
        return ref_alias_build_batched(weights)
    B, n = weights.shape
    q = torch.empty((B, n), dtype=torch.float32, device=weights.device)
    alias = torch.empty((B, n), dtype=torch.int32, device=weights.device)
    if B == 0 or n == 0:
        return q, alias
    w = weights.contiguous()
    lib = _build.library()
    per_row = lib.rt_alias_scratch_words(n)
    scratch = (torch.empty(B * per_row, dtype=torch.float64, device=w.device)
               if per_row else None)
    err = lib.rt_alias_build(
        w.data_ptr(), q.data_ptr(), alias.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, n, _build.stream_of(w))
    _build.check(err, "alias_build_batched")
    alias_build_batched.launches += 1
    return q, alias


alias_build_batched.launches = 0
