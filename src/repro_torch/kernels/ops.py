"""Kernel entry points over the port's data structures.

Each wrapper dispatches on its tensors' device: CPU tensors run the plain
PyTorch version, CUDA tensors launch the hand-written kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.core.forest import RadixForest

from .cdf_scan import cdf_scan
from .forest_delta import forest_delta as _forest_delta
from .forest_sample import forest_sample as _forest_sample


def fused_cdf(x: torch.Tensor, softmax: bool = True) -> torch.Tensor:
    """(B, V) logits/weights -> (B, V) inclusive CDF rows."""
    return cdf_scan(x, softmax=softmax)


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
