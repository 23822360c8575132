"""Scoped sharding hints: ZeRO-3 gather-on-use and sequence-sharded
residuals, the port of the JAX package's ``dist/hints.py``.

``repro_torch.models.model`` calls :func:`gather_params` / :func:`act_seq`
unconditionally, at the JAX model's places (each period's parameters and
residual, each encoder layer's parameters, the head's weight, each period
of prefill and decode). The contract:

* **Outside** a :func:`sharding_hints` context both functions return their
  argument unchanged: the very same object, so hint-free execution is the
  execution of a model that never heard of this module.
* **Inside** the context they redistribute DTensors (the JAX functions
  insert ``with_sharding_constraint``s; the port has no tracer, so the
  redistribution happens where the call is): ``gather_params`` moves each
  DTensor parameter leaf to its policy placements *minus the FSDP axes*
  (parameters stay TP-sharded but are gathered across the ZeRO-3 axes at
  the point of use; the backward reduce-scatters their gradients);
  ``act_seq`` moves the (B, S, D) residual stream to the sequence sharded
  over ``Policy.sp``. The specs and the sanitizing are JAX's
  (:mod:`repro_torch.dist.sharding`). A plain (non-DTensor) leaf is left as
  it is, as JAX leaves a tree alone when no mesh is in scope.

The JAX ``Hints`` carries a ``mesh`` to resolve the ambient ``with mesh:``
at trace time; here every DTensor carries its own ``device_mesh``, which is
the mesh every redistribution uses, so the port's ``Hints`` has no mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from .sharding import Policy, _entry, _leaf_spec, _sanitize, mesh_shape, placements, port_spec

_CURRENT: "Hints | None" = None


@dataclasses.dataclass(frozen=True)
class Hints:
    """What to redistribute under ``sharding_hints``."""

    policy: Policy
    gather_weights: bool = False
    seq_shard: bool = False


@contextlib.contextmanager
def sharding_hints(hints: Hints):
    """Activate ``hints`` for every model run inside the block."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, hints
    try:
        yield hints
    finally:
        _CURRENT = prev


def current_hints() -> Hints | None:
    return _CURRENT


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _gathered(p, pol: Policy):
    """``p`` redistributed to its placements under ``pol`` (FSDP dropped);
    a leaf without a JAX leaf record, or not a DTensor, unchanged."""
    leaf = getattr(p, "jax_leaf", None)
    if leaf is None or not _is_dtensor(p):
        return p
    mesh = p.device_mesh
    spec = _leaf_spec(leaf.path, leaf.shape, pol, mesh_shape(mesh))
    return p.redistribute(mesh, placements(port_spec(leaf, spec), mesh))


def _module_with(mod: torch.nn.Module, fn) -> torch.nn.Module:
    """A shallow copy of ``mod`` (and of its submodules) whose parameters
    are ``fn(parameter)``, held as plain attributes: the module's code reads
    them as before, and the original module is untouched."""
    clone = object.__new__(type(mod))
    clone.__dict__.update(mod.__dict__)
    clone.__dict__["_parameters"] = {}
    clone.__dict__["_modules"] = {k: _module_with(m, fn) for k, m in mod._modules.items()}
    for k, p in mod._parameters.items():
        clone.__dict__[k] = None if p is None else fn(p)
    return clone


def gather_params(tree: Any) -> Any:
    """ZeRO-3 gather-on-use over a module (a period, an encoder layer) or a
    ``{name: parameter}`` dict. Identity (the same object) without active
    hints."""
    h = _CURRENT
    if h is None or not h.gather_weights:
        return tree
    pol = dataclasses.replace(h.policy, fsdp=())

    def fn(p):
        return _gathered(p, pol)

    if isinstance(tree, torch.nn.Module):
        return _module_with(tree, fn)
    return {k: fn(v) for k, v in tree.items()}


def act_seq(x: Any) -> Any:
    """Sequence-sharded residual. Identity without active hints, and for a
    tensor that is not a DTensor."""
    h = _CURRENT
    if h is None or not h.seq_shard or not _is_dtensor(x):
        return x
    mesh = x.device_mesh
    pol = h.policy
    dp = None if pol.shard_seq and not pol.dp else _entry(pol.dp)
    spec = (dp, _entry(pol.sp)) + (None,) * (x.dim() - 2)
    s = _sanitize(spec[: x.dim()], tuple(x.shape), mesh_shape(mesh))
    return x.redistribute(mesh, placements(s, mesh))
