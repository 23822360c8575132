"""Serving-state snapshots on disk, over :mod:`repro_torch.ckpt`.

Every serving component owns an exact state pair: ``ForestPool``, the four
QMC stream classes, ``PooledForestSampler``, ``SpatialSampler``,
``TokenSampler`` and ``ServeEngine`` each have ``snapshot()`` and a
``restore`` classmethod, and each restore takes the JAX package's dicts as
well as the port's. This module bundles named components into one blob and
commits it through :func:`repro_torch.ckpt.save_state` (tmp directory,
fsync, rename: a crash mid-save never corrupts the latest snapshot):

    save_serving("/ckpt/serve", step, pool=pool, streams=streams)
    ...
    states, step = load_serving("/ckpt/serve")
    pool = ForestPool.restore(states["pool"], device="cuda")

A serving process restored this way draws the same as the one that saved,
drain for drain, with the same stream counters. The directory format is
the JAX package's, so a bundle saved by either package loads in the other.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any

from repro_torch.ckpt import load_state, save_state

__all__ = ["save_serving", "load_serving"]


def save_serving(path: str | os.PathLike, step: int, **components: Any) -> Path:
    """Snapshot each component (anything with a ``snapshot()`` method, an
    already-snapshotted dict, or None) and atomically commit the named
    bundle; returns the committed directory."""
    blob = {}
    for name, comp in components.items():
        if comp is None or isinstance(comp, dict):
            blob[name] = comp
        elif hasattr(comp, "snapshot"):
            blob[name] = comp.snapshot()
        else:
            raise TypeError(f"component {name!r} has no snapshot() and is not a dict")
    return save_state(path, blob, step)


def load_serving(path: str | os.PathLike, step: int | None = None):
    """Load a :func:`save_serving` bundle of either package; returns
    ``(states, step)``. Each entry is the component's state dict: hand it
    to the matching class's ``restore``."""
    return load_state(path, step)
