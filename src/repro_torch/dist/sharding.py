"""Sharding policy and placement rules for the LM's parameters, batches and
decode caches: the port of the JAX package's ``dist/sharding.py``, with
DTensor placements over a ``DeviceMesh`` in place of GSPMD's
``NamedSharding``.

``Policy`` names which mesh axes carry which kind of parallelism:

* ``dp``   — data parallelism (the batch dim of activations).
* ``fsdp`` — ZeRO-3 style parameter/optimizer sharding axes. Parameters are
  stored sharded along these axes; the ``gather_params`` hint
  (:mod:`repro_torch.dist.hints`) re-gathers them at use.
* ``tp``   — tensor parallelism: heads / ff / vocab dims. ``None`` disables
  TP; a tuple (e.g. ``("data", "model")``) gives 2-D weight-stationary TP.
* ``shard_seq`` / ``sp`` — sequence sharding of activations / KV caches
  along ``sp``.

The rules (``_core_spec``, ``_sanitize`` and the presets) are JAX's, copied:
a spec entry that does not divide its dim, or reuses an axis, is dropped
(replicated). They are applied to the JAX path and shape of each port
parameter (``models.layout.leaf_map``), with the period axis of a stacked
leaf prepended and never sharded, so a "JAX-form spec" here is exactly what
``repro.dist.sharding.param_specs`` gives for that leaf. The JAX-form spec is
then carried through the leaf's layout transform onto the port's unstacked
``(out, in)`` tensor (``"in"``: JAX (in, *out) -> port (prod(out), in);
``"out"``: (*in, D) -> (D, prod(in)); ``"flat"``; ``"same"``): sharding a
flattened group in contiguous blocks equals sharding its leading dim, so
JAX ``wq`` (D, H, hd) with spec (f, t, None) becomes the port's (H*hd, D)
with ``t`` on dim 0 and ``f`` on dim 1. A port spec becomes one placement per
mesh dim: ``Shard(d)`` where the entry of port dim ``d`` names that mesh
axis, else ``Replicate()``; an entry naming several axes shards one tensor
dim over each of them, in mesh order (as a tuple entry of JAX's does when
its axes are in mesh order, which every preset's are).

A mesh is a ``DeviceMesh`` with named dims, or, for the spec functions, a
``{axis name: size}`` dict (so a 512-device layout can be checked without
512 processes).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import TYPE_CHECKING, Any

import torch

if TYPE_CHECKING:   # the models package imports this module
    from repro_torch.models.config import ModelConfig

Axes = tuple[str, ...]

# Parameter leaves that stay replicated everywhere: norm scales, tiny bias /
# gate vectors, SSM scalars-per-channel (JAX's list).
_REPLICATED_NAMES = frozenset(
    {"scale", "bias", "if_bias", "dt_bias", "d_skip", "a_log", "conv", "len"}
)
_MLP_KEY = re.compile(r"^m\d+$")
# Large-model thresholds (total params) for the recommended presets.
_TRAIN_TP_THRESHOLD = 16e9
_DECODE_2D_THRESHOLD = 100e9


def axis_names(mesh) -> Axes:
    """The named axes of a ``DeviceMesh``, a ``{name: size}`` dict, or any
    object with ``axis_names``."""
    if isinstance(mesh, dict):
        return tuple(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a mesh (a dict is returned as is)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(axis_names(mesh), (int(s) for s in mesh.shape)))


@dataclasses.dataclass(frozen=True)
class Policy:
    """Axis assignment for one (arch, shape, mesh) cell.

    Fields are mesh axis names: ``dp``/``fsdp`` are tuples, ``tp``/``sp``
    are a single axis name, a tuple (multi-axis TP), or ``None``.
    """

    dp: Axes = ()
    tp: str | Axes | None = None
    fsdp: Axes = ()
    shard_seq: bool = False
    sp: str | Axes | None = None

    @classmethod
    def for_mesh(cls, mesh, kind: str = "train") -> "Policy":
        """Default policy: TP over the ``model`` axis (when present), DP over
        everything else, FSDP==DP for training, no FSDP for serving kinds."""
        axes = axis_names(mesh)
        model = "model" if "model" in axes else None
        rest = tuple(a for a in axes if a != model)
        return cls(dp=rest, tp=model, fsdp=rest if kind == "train" else (),
                   shard_seq=False, sp=model)

    @classmethod
    def recommended(cls, cfg: ModelConfig, mesh, mode: str) -> "Policy":
        """The JAX package's presets keyed on model scale and mode: train or
        prefill under 16e9 parameters pure DP/FSDP over every axis, above it
        TP over ``model`` and FSDP over the rest; decode under 100e9 1-D TP
        over ``model``, above it 2-D TP over every axis with a
        sequence-sharded KV cache."""
        axes = axis_names(mesh)
        model = "model" if "model" in axes else axes[-1]
        rest = tuple(a for a in axes if a != model)
        total, _ = cfg.param_count()
        if mode in ("train", "prefill"):
            if total < _TRAIN_TP_THRESHOLD:
                return cls(dp=axes, tp=None, fsdp=axes, shard_seq=False, sp=model)
            return cls(dp=rest, tp=model, fsdp=rest, shard_seq=False, sp=model)
        if total < _DECODE_2D_THRESHOLD:
            return cls(dp=rest, tp=model, fsdp=(), shard_seq=False, sp=model)
        return cls(dp=(), tp=axes, fsdp=(), shard_seq=True, sp=model)


# --------------------------------------------------------------------- rules


def _axes_of(entry) -> Axes:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _entry(entry):
    """Normalize a spec entry: drop empty tuples, unwrap singletons."""
    axes = _axes_of(entry)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _sanitize(spec: tuple, shape: tuple[int, ...], mesh_shape: dict) -> tuple:
    """Drop spec entries that do not divide their dim or reuse an axis."""
    used: set[str] = set()
    out = []
    for dim, entry in zip(shape, spec):
        axes = tuple(a for a in _axes_of(entry) if a not in used)
        size = math.prod(mesh_shape[a] for a in axes) if axes else 1
        if not axes or size <= 1 or dim % size != 0:
            out.append(None)
            continue
        used.update(axes)
        out.append(_entry(axes))
    return tuple(out)


def _core_spec(path_names: tuple[str, ...], name: str, ndim: int, pol: Policy):
    """Spec entries for one *unstacked* JAX parameter leaf.

    ``path_names`` is the full dict path (so MoE ``wo`` (E,F,D) can be told
    apart from attention ``wo`` (H,hd,D) by its ``m<i>`` parent).
    """
    t = _entry(pol.tp)
    f = _entry(pol.fsdp)
    if name in _REPLICATED_NAMES or ndim <= 1:
        return (None,) * ndim
    if name == "embed":                       # (V, D): vocab->tp, d->fsdp
        return (t, f)
    if name == "lm_head":                     # (D, V)
        return (f, t)
    in_mlp = any(_MLP_KEY.match(p) for p in path_names) or "mlp" in path_names \
        or "shared" in path_names
    if in_mlp:
        if name == "router":                  # (D, E)
            return (f, None)
        if ndim == 3:                         # MoE experts (E, D, F)/(E, F, D)
            return (t, f, None) if name in ("wi", "wg") else (t, None, f)
        return (f, t) if name in ("wi", "wg") else (t, f)
    # attention / ssm / xlstm blocks
    if name in ("wq", "wk", "wv"):
        return (f, t, None) if ndim == 3 else (f, t)
    if name == "wo":                          # (H, hd, D)
        return (t, None, f)
    if name in ("bq", "bk", "bv"):            # (H, hd)
        return (t, None)
    if name in ("up", "wx", "in_proj", "wi", "wg"):   # (D, inner)
        return (f, t)
    if name in ("down", "out_proj"):          # (inner, D)
        return (t, f)
    if name == "r":                           # slstm recurrent (H, hd, 4hd)
        return (t, None, None)
    if name in ("wif", "x_proj"):             # (inner, small)
        return (f, None)
    return (None,) * ndim


def _leaf_spec(names: tuple[str, ...], shape: tuple[int, ...], pol: Policy,
               mesh_shape: dict) -> tuple:
    """The JAX-form spec of the leaf at JAX path ``names`` with JAX shape
    ``shape`` (stacked leaves under ``layers``/``encoder`` carry their
    leading period axis, which never shards)."""
    name = names[-1] if names else ""
    is_stacked = bool(names) and names[0] in ("layers", "encoder")
    core = len(shape) - 1 if is_stacked else len(shape)
    spec = _core_spec(names, name, core, pol)
    if is_stacked:
        spec = (None,) + tuple(spec)
    return _sanitize(spec, shape, mesh_shape)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A port parameter's JAX leaf: its path, its layout transform
    (``models.layout.leaf_map``'s kind) and its JAX shape (stacked leaves
    with the leading period/encoder-layer axis)."""

    path: tuple
    kind: str
    shape: tuple


def leaves(cfg: ModelConfig) -> dict[str, Leaf]:
    """``{port parameter name: Leaf}`` for every parameter of ``cfg``."""
    from repro_torch.models.layout import leaf_map, stacked

    out = {}
    for path, name, kind, shape in leaf_map(cfg):
        n = stacked(cfg, path)
        if n is None:
            out[name] = Leaf(tuple(path), kind, tuple(shape))
            continue
        for p in range(n):
            out[name.format(p=p)] = Leaf(tuple(path), kind, (n,) + tuple(shape))
    return out


def _merge(entries: tuple):
    """One port-dim entry for a flattened group of JAX dims: only the
    group's leading dim may be sharded (contiguous blocks of the flattened
    dim are then blocks of that dim)."""
    if any(e is not None for e in entries[1:]):
        raise ValueError(f"spec {entries} shards a trailing dim of a flattened group")
    return entries[0] if entries else None


def port_spec(leaf: Leaf, spec: tuple) -> tuple:
    """A JAX-form spec carried onto the port's unstacked tensor of ``leaf``
    (one entry per port dim)."""
    core = spec[1:] if leaf.path[0] in ("layers", "encoder") else spec
    if leaf.kind == "in":
        return (_merge(core[1:]), core[0])
    if leaf.kind == "out":
        return (core[-1], _merge(core[:-1]))
    if leaf.kind == "flat":
        return (_merge(core),)
    return tuple(core)


def placements(spec: tuple, mesh) -> list:
    """One placement per mesh dim for a spec whose entry ``d`` names the
    mesh axes of tensor dim ``d``: ``Shard(d)`` on each axis it names, in
    mesh order, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"entry {entry!r} is not in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def param_specs(cfg: ModelConfig, pol: Policy, mesh_shape: dict) -> dict[str, tuple]:
    """``{port parameter name: JAX-form spec}``: for a stacked leaf, the
    spec of the whole JAX leaf (period axis first), which is what the JAX
    package's ``param_specs`` gives at that leaf's path."""
    return {name: _leaf_spec(lf.path, lf.shape, pol, mesh_shape)
            for name, lf in leaves(cfg).items()}


def param_placements(model, mesh, pol: Policy) -> dict[str, list]:
    """``{port parameter name: placements}`` of ``model``'s parameters
    under ``pol`` on ``mesh``."""
    shape = mesh_shape(mesh)
    lv = leaves(model.cfg)
    return {name: placements(port_spec(lv[name], _leaf_spec(lv[name].path, lv[name].shape,
                                                            pol, shape)), mesh)
            for name, _ in model.named_parameters()}


@torch.no_grad()
def distribute_params(model, mesh, pol: Policy):
    """Swap every parameter of ``model`` for a DTensor parameter placed by
    ``pol`` on ``mesh`` (``distribute_tensor``; every rank must hold the
    same values, as after a seeded init). ``requires_grad`` is kept; the
    optimizer's moments made by ``init_opt`` then shard as the parameters.
    Each new parameter carries its JAX leaf (``jax_leaf``) for the
    ``gather_params`` hint; the model records ``(mesh, pol)`` as
    ``dist_state``, which :func:`place_batch` reads. Returns ``model``."""
    from torch.distributed.tensor import distribute_tensor

    pls = param_placements(model, mesh, pol)
    lv = leaves(model.cfg)
    for name, p in list(model.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        d = torch.nn.Parameter(distribute_tensor(p.detach(), mesh, pls[name]),
                               requires_grad=p.requires_grad)
        d.jax_leaf = lv[name]
        setattr(mod, attr, d)
    model.dist_state = (mesh, pol)
    return model


# ------------------------------------------------------------ batch / cache


def _dp_entry(pol: Policy):
    return _entry(pol.dp)


def batch_specs(cfg: ModelConfig, pol: Policy, keys=None) -> dict[str, tuple]:
    """Spec per batch tensor (train / prefill batches): the batch dim
    shards over ``dp``; with ``shard_seq`` the sequence dim over ``sp``.
    ``keys`` defaults to the config's batch keys."""
    dp = _dp_entry(pol)
    sp = _entry(pol.sp) if pol.shard_seq else None
    rank = {"tokens": 2, "labels": 2, "embeds": 3, "frames": 3}
    if keys is None:
        keys = (["embeds"] if cfg.frontend == "embed" else ["tokens"]) + (
            ["frames"] if cfg.encoder_layers else []) + ["labels"]
    out = {}
    for k in keys:
        r = rank.get(k, 2)
        spec = (dp, sp) + (None,) * (r - 2)
        out[k] = spec[:r]
    return out


def batch_placements(t: torch.Tensor, key: str, cfg: ModelConfig, mesh, pol: Policy) -> list:
    """Placements of batch tensor ``key`` (sanitized on its shape)."""
    spec = batch_specs(cfg, pol, [key])[key]
    return placements(_sanitize(spec, tuple(t.shape), mesh_shape(mesh)), mesh)


def place_batch(model, t: torch.Tensor, key: str) -> torch.Tensor:
    """Batch tensor ``t`` (plain and the same on every rank, or a DTensor
    already placed, as a step's sharded inputs are; ``key`` one of
    ``batch_specs``' keys) as a DTensor placed by the policy when ``model``
    is distributed (:func:`distribute_params`), else as is. The model
    passes every tensor that meets a parameter through here (batches,
    labels, positions): a plain tensor mixed into a DTensor op raises, and
    an implicit replication is thread-local while CUDA's backward runs on
    another thread."""
    st = getattr(model, "dist_state", None)
    if st is None:
        return t
    from torch.distributed.tensor import DTensor

    from .local import replicate

    mesh, pol = st
    if not isinstance(t, DTensor):
        t = replicate(t, mesh)
    pl = batch_placements(t, key, model.cfg, mesh, pol)
    return t if list(t.placements) == pl else t.redistribute(mesh, pl)


def cache_spec_tree(cfg: ModelConfig, cache: Any, pol: Policy, mesh) -> Any:
    """Spec tree (the structure of ``models.init_cache``'s dict) of a decode
    cache. Leaves carry a leading period axis that never shards. The batch
    dim shards over ``dp``; attention K/V additionally shard the sequence
    dim over ``sp`` when ``shard_seq`` and the KV-head dim over ``tp``;
    recurrent states shard their channel dim over ``tp``."""
    shape = mesh_shape(mesh)
    dp = None if pol.shard_seq else _dp_entry(pol)
    t = _entry(pol.tp)
    sp = _entry(pol.sp) if pol.shard_seq else None

    def leaf(name, x):
        nd = x.dim()
        if name == "len" or nd <= 1:
            return ()
        if name in ("k", "v") and nd == 5:       # (periods, B, S, KV, hd)
            spec = (None, dp, sp, t, None)
        elif nd >= 3:                            # recurrent state (periods, B, C, ...)
            spec = (None, dp, t) + (None,) * (nd - 3)
        else:                                    # (periods, B)
            spec = (None, dp)
        return _sanitize(spec, tuple(x.shape), shape)

    return {b: {n: leaf(n, x) for n, x in c.items()} for b, c in cache.items()}


def distribute_cache(cfg: ModelConfig, cache: dict, mesh, pol: Policy) -> dict:
    """The decode cache as DTensors placed by :func:`cache_spec_tree`
    (every rank holds the same values)."""
    from torch.distributed.tensor import distribute_tensor

    specs = cache_spec_tree(cfg, cache, pol, mesh)
    return {b: {n: distribute_tensor(x, mesh, placements(specs[b][n], mesh))
                for n, x in c.items()} for b, c in cache.items()}


def zeros_cache(cfg: ModelConfig, cache: dict, mesh, pol: Policy, device) -> dict:
    """A zero cache of ``cache``'s structure, shapes and dtypes (``meta``
    leaves will do) as DTensors placed by :func:`cache_spec_tree` on
    ``device``, each rank allocating only its own shard."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    def zeros(x, spec):
        pl = placements(spec, mesh)
        local, _ = compute_local_shape_and_global_offset(x.shape, mesh, pl)
        return DTensor.from_local(torch.zeros(local, dtype=x.dtype, device=device), mesh, pl,
                                  run_check=False, shape=x.shape, stride=x.stride())

    specs = cache_spec_tree(cfg, cache, pol, mesh)
    return {b: {n: zeros(x, specs[b][n]) for n, x in c.items()} for b, c in cache.items()}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a restored checkpoint leaf goes: ``distribute_tensor(leaf,
    mesh, placements)`` (the port's counterpart of JAX's ``NamedSharding``;
    a leaf of the trees ``ckpt.restore(shardings=)`` takes)."""

    mesh: Any
    placements: tuple


def jax_tree_shardings(cfg: ModelConfig, mesh, pol: Policy) -> dict:
    """A :class:`NamedSharding` for every leaf of the JAX parameter pytree
    (stacked leaves whole, in their JAX dims): the ``shardings=`` tree that
    restores a checkpoint in JAX's layout sharded by ``pol``."""
    tree: dict = {}
    shape = mesh_shape(mesh)
    from repro_torch.models.layout import leaf_map, stacked

    for path, _name, _kind, jshape in leaf_map(cfg):
        n = stacked(cfg, path)
        full = tuple(jshape) if n is None else (n,) + tuple(jshape)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = NamedSharding(mesh, tuple(placements(
            _leaf_spec(tuple(path), full, pol, shape), mesh)))
    return tree
