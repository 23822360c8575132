"""Carry state across from the JAX package, through plain numpy.

The JAX side (``repro.core.forest_to_numpy``, ``QmcStreams.snapshot()``,
``ForestPool.snapshot()``, the samplers' ``snapshot()``) produces numpy
dicts; these functions turn them into the port's objects, so
``repro_torch`` itself never imports ``repro``. The samplers and streams
take such dicts directly in their own ``restore``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.forest import RadixForest
from repro_torch.device import to_device
from repro_torch.pool.arena import ForestPool, Handle

_FIELDS = {
    "cdf": torch.float32,
    "table": torch.int32,
    "left": torch.int32,
    "right": torch.int32,
    "cell_first": torch.int32,
    "fallback": torch.bool,
}


def forest_from_numpy(d: dict, device="cuda") -> RadixForest:
    """The dict of ``forest_to_numpy`` -> a port :class:`RadixForest` on
    ``device`` (same field names, dtypes and values)."""
    return RadixForest(**{
        k: to_device(np.ascontiguousarray(d[k]), device, dtype)
        for k, dtype in _FIELDS.items()
    })


def pool_from_snapshot(state: dict, device="cuda") -> ForestPool:
    """A ``ForestPool.snapshot()`` dict (of either package, as is) -> a port
    :class:`ForestPool` on ``device`` whose drains equal the source's."""
    return ForestPool.restore(state, device=device)


def handle_from_numpy(h) -> Handle:
    """A JAX ``Handle`` (a 5-field tuple: size class, row, n, version,
    method) -> the port's :class:`Handle`."""
    size_class, row, n, version, method = h
    return Handle(int(size_class), int(row), int(n), int(version), str(method))
