"""Roofline analysis of a dry-run step on ``meta`` tensors (no card needed),
the port of the JAX package's ``launch/roofline.py`` with H100 SXM
constants in place of TPU v5e's.

Terms (the JAX package's formulas):
    t_compute = FLOPs_global / (chips * 989e12)     [dense bf16 peak]
    t_mem     = HBM_bytes_global / (chips * 3.35e12)
    t_coll    = sum over collectives of bytes / (rate of the slowest link
                its group crosses): NVLink 450e9 a direction a GPU inside
                a node (the mesh's ``model`` axis), InfiniBand 50e9 a GPU
                (one 400 Gb/s NDR port) across nodes (``data``, ``pod``)

(NVIDIA H100 datasheet; DGX H100 topology.) The two link rates are the
card's counterpart of the JAX package's one ``LINK_BW``.

The port has no compiled HLO. :class:`StepTrace` records what the traced
step dispatches instead, per rank: each collective (``_c10d_functional``
ops and the ``c10d`` ops ``torch.distributed`` calls issue) with its result
bytes, group size, the mesh dims its group spans and the module path, the
step's FLOPs (``torch.utils.flop_counter``'s formulas on the rank's local
ops) and the peak of the bytes it allocates. :func:`parse_collectives`
turns the records into the JAX package's ``{kind: {count, operand_bytes,
result_bytes, wire_bytes}}`` with its five formulas; a record at depth
``d`` is multiplied by ``prod(trip_hints[:d])`` as JAX multiplies a while
body. As in JAX, the analytic FLOPs and bytes (``launch/analytic.py``) set
``t_compute`` and ``t_mem``.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _leaves

PEAK_FLOPS = 989e12     # dense bf16 / GPU (H100 SXM)
HBM_BW = 3.35e12        # bytes/s / GPU
NVLINK_BW = 450e9       # bytes/s / GPU, one direction
IB_BW = 50e9            # bytes/s / GPU, one 400 Gb/s NDR port
LINK_BW = {"nvlink": NVLINK_BW, "ib": IB_BW}
NODE_AXES = frozenset({"model"})   # mesh axes inside one NVLink node

_COLL_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
# JAX's dtype names, for the records' shapes
_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.int32: "s32",
    torch.float32: "f32", torch.int64: "s64", torch.float64: "f64",
}


@dataclasses.dataclass(frozen=True)
class Collective:
    """One dispatched collective: ``kind`` (one of JAX's five), the result's
    dtype (JAX's name) and per-rank shape, the group's size and mesh dims,
    the module path (JAX's ``op_name``), and its while depth: the record
    counts ``weight * prod(trip_hints[:depth])`` times."""

    kind: str
    dtype: str
    shape: tuple
    group_size: int
    dims: tuple
    path: str = ""
    depth: int = 0
    weight: int = 1

    @property
    def result_bytes(self) -> int:
        return math.prod(self.shape) * _itemsize(self.dtype)

    @property
    def link(self) -> str:
        return "nvlink" if set(self.dims) <= NODE_AXES else "ib"

    def mult(self, trip_hints: tuple[int, ...] = ()) -> float:
        m = float(self.weight)
        for d in range(self.depth):
            m *= trip_hints[d] if d < len(trip_hints) else 1
        return m


def _itemsize(name: str) -> int:
    for dt, n in _DTYPE_NAMES.items():
        if n == name:
            return dt.itemsize
    raise ValueError(f"unknown dtype {name!r}")


def _bytes(c: Collective) -> tuple[float, float, float]:
    """(operand, result, wire) bytes of one op, JAX's formulas."""
    R, G = c.result_bytes, max(c.group_size, 1)
    if c.kind == "all-reduce":
        return R, R, 2.0 * R * (G - 1) / G
    if c.kind == "all-gather":
        return R / G, R, R * (G - 1) / G
    if c.kind == "reduce-scatter":
        return R * G, R, float(R) * (G - 1)
    if c.kind == "all-to-all":
        return R, R, R * (G - 1) / G
    return R, R, float(R)   # collective-permute


def parse_collectives(records, trip_hints: tuple[int, ...] = ()) -> dict[str, dict[str, float]]:
    """Per-kind byte totals of the traced (per-rank) collectives. Operand
    bytes come from the result bytes R and group size G:
      all-reduce: op=R            wire=2*R*(G-1)/G
      all-gather: op=R/G          wire=R*(G-1)/G
      reduce-scatter: op=R*G      wire=R*(G-1)
      all-to-all: op=R            wire=R*(G-1)/G
      collective-permute: op=R    wire=R
    ``count`` counts records; bytes are multiplied by each record's
    :meth:`Collective.mult`."""
    out: dict[str, dict[str, float]] = {
        k: {"count": 0, "operand_bytes": 0.0, "result_bytes": 0.0, "wire_bytes": 0.0}
        for k in _COLL_KINDS
    }
    for c in records:
        op, res, wire = _bytes(c)
        m = c.mult(trip_hints)
        rec = out[c.kind]
        rec["count"] += 1
        rec["operand_bytes"] += op * m
        rec["result_bytes"] += res * m
        rec["wire_bytes"] += wire * m
    return out


def link_bytes(records, trip_hints: tuple[int, ...] = ()) -> dict[str, dict[str, float]]:
    """Per-rank operand and wire bytes by the slowest link each group
    crosses (``"nvlink"`` inside a node, ``"ib"`` across nodes)."""
    out = {k: {"operand_bytes": 0.0, "wire_bytes": 0.0} for k in LINK_BW}
    for c in records:
        op, _, wire = _bytes(c)
        m = c.mult(trip_hints)
        out[c.link]["operand_bytes"] += op * m
        out[c.link]["wire_bytes"] += wire * m
    return out


# ---------------------------------------------------------------- tracing

# _c10d_functional (and DTensor's _dtensor) op name -> (kind, group_name
# argument index)
_FUNCTIONAL = {
    "all_reduce": ("all-reduce", 2), "all_reduce_": ("all-reduce", 2),
    "all_reduce_coalesced": ("all-reduce", 2), "all_reduce_coalesced_": ("all-reduce", 2),
    "all_gather_into_tensor": ("all-gather", 2), "all_gather_into_tensor_out": ("all-gather", 2),
    "all_gather_into_tensor_coalesced": ("all-gather", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 3),
    "all_to_all_single": ("all-to-all", 3),
    "shard_dim_alltoall": ("all-to-all", 3),   # _dtensor: DTensor's Shard(i) -> Shard(j)
}
# c10d op name (what torch.distributed's calls dispatch) -> kind; the group
# is the argument that is a ProcessGroup
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}


def mesh_groups(mesh) -> dict[str, tuple[tuple, int]]:
    """``{group name: (mesh dims, size)}`` of each mesh dim's group and of
    the world group (every dim)."""
    import torch.distributed as dist

    names = tuple(mesh.mesh_dim_names)
    out = {mesh.get_group(d).group_name: ((d,), mesh.size(i)) for i, d in enumerate(names)}
    out.setdefault(dist.group.WORLD.group_name, (names, dist.get_world_size()))
    return out


class StepTrace(TorchDispatchMode):
    """A dispatch mode that sees a step's per-rank ops: an op on DTensors is
    handed to DTensor (``NotImplemented``), whose local ops and collectives
    come back here. Records :class:`Collective`\\ s (``records``), the
    local FLOPs (``flops``, ``torch.utils.flop_counter``'s formulas) and the
    peak of the bytes the step allocates (``peak_bytes``: storages made by
    an op while the mode is on, freed when the storage dies; ``known``
    storages, the step's inputs, are never counted). Module paths are
    named from ``model``'s root where it is given."""

    def __init__(self, mesh, known=(), model=None):
        super().__init__()
        from torch.utils.module_tracker import ModuleTracker

        self.groups = mesh_groups(mesh)
        self.all_dims = tuple(mesh.mesh_dim_names)
        self.records: list[Collective] = []
        self.flops = 0
        self.live = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._info: dict = {}
        self._known = {_storage_key(t) for t in known}
        self._modules = ModuleTracker()
        if model is not None:   # paths from the model's root ("LM.layers.1.m0")
            for name, m in model.named_modules():
                self._modules._known_modules[m] = ".".join(filter(None, ("LM", name)))

    def __enter__(self):
        self._modules.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._modules.__exit__(*exc)
        return out

    def _path(self) -> str:
        parents = [p for p in self._modules.parents if p != "Global"]
        return max(parents, key=lambda p: (p.count("."), p)) if parents else ""

    def _group(self, arg) -> tuple[tuple, int]:
        """(mesh dims, size) of a collective's group, a name or a
        ProcessGroup; a group that is no mesh dim's is taken to span every
        dim."""
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        # a c10d op carries the group boxed as a TorchScript object
        pg = _resolve_process_group(arg) if isinstance(arg, str) else \
            arg if isinstance(arg, dist.ProcessGroup) else dist.ProcessGroup.unbox(arg)
        return self.groups.get(pg.group_name, (self.all_dims, pg.size()))

    def _learn(self, func) -> tuple:
        """(decomposes, FLOP formula or None, collective (kind, group
        argument or None for c10d's) or None) of an op, once."""
        from torch.utils.flop_counter import flop_registry

        packet, ns = func._overloadpacket, func.namespace
        name = func._schema.name.split("::")[-1]
        coll = (_FUNCTIONAL[name] if ns in ("_c10d_functional", "_dtensor") and name in _FUNCTIONAL
                else (_C10D[name], None) if ns == "c10d" and name in _C10D else None)
        flop = flop_registry.get(packet)
        decomposes = flop is None and func is not torch.ops.prim.device.default and \
            torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), "CompositeImplicitAutograd")
        self._info[func] = (decomposes, flop, coll)
        return self._info[func]

    def _record(self, coll, args, out) -> None:
        kind, gi = coll
        if gi is not None:      # _c10d_functional: the result is the output
            dims, size = self._group(args[gi])
            results = [(t.dtype, tuple(t.shape)) for t in _leaves(out)
                       if isinstance(t, torch.Tensor)]
        else:                   # c10d: the group is the ProcessGroup argument
            pg = next(a for a in args if not isinstance(a, (torch.Tensor, list, tuple, int,
                                                            float, bool, type(None))))
            dims, size = self._group(pg)
            # a c10d op writes its result in place into its first argument
            # (a tensor or lists of them): one record of all of it
            ts = [t for t in _leaves(args[0]) if isinstance(t, torch.Tensor)]
            results = [(ts[0].dtype, (sum(t.numel() for t in ts),))] if ts else []
        path = self._path()
        for dt, shape in results:
            self.records.append(Collective(kind, _DTYPE_NAMES.get(dt, "f32"), shape,
                                           int(size), tuple(dims), path))

    def _track(self, out) -> None:
        for t in _leaves(out):
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                continue
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in self._live or key in self._known:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = _leaves((args, kwargs))
        if any(isinstance(x, DTensor) for x in leaves):
            return NotImplemented
        decomposes, flop, coll = self._info.get(func) or self._learn(func)
        if decomposes:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if any(isinstance(x, FakeTensor) for x in leaves + _leaves(out)):
            # DTensor's sharding propagation: the op at global shapes on fake
            # tensors, for its output's metadata; not the rank's work
            return out
        if flop is not None:
            self.flops += int(flop(*args, **kwargs, out_val=out))
        if coll is not None:
            self._record(coll, args, out)
        self._track(out)
        return out


def _storage_key(t: torch.Tensor) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.untyped_storage()._cdata


def calibrate_cost_semantics(mesh) -> dict[str, float]:
    """Whether the traced FLOP count is global or per rank: a known matmul
    sharded over the mesh's first dim, counted by :class:`StepTrace` (the
    count the dry run uses) and by ``torch.utils.flop_counter.FlopCounterMode``
    (which counts a DTensor op at its global shape)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    ndev = mesh.size()
    M = N = K = 1024
    expect_global = 2 * M * N * K
    pl = [Replicate()] * mesh.ndim
    x = distribute_tensor(torch.empty(M, K, device="meta"), mesh, [Shard(0)] + pl[1:])
    y = distribute_tensor(torch.empty(K, N, device="meta"), mesh, pl)
    with StepTrace(mesh) as tr:
        x @ y
    with FlopCounterMode(display=False) as fc:
        x @ y
    ratio = tr.flops / expect_global
    # ratio ~1 -> global; ~1/ndev -> per rank
    scale = 1.0 if ratio > 0.5 else float(ndev) if ratio > 0 else 0.0
    return {"flops_scale_to_global": scale, "calib_ratio": ratio,
            "flop_counter_ratio": fc.get_total_flops() / expect_global}


@dataclasses.dataclass
class Roofline:
    chips: int
    flops_global: float
    bytes_global: float
    coll_bytes_global: float     # raw operand-byte convention (assignment)
    coll_wire_global: float      # ring-algorithm estimate
    collectives: dict[str, dict[str, float]]
    # The traced step's FLOPs, made global by calibrate_cost_semantics (the
    # JAX package's key, which holds cost_analysis() there). The trace
    # counts no bytes, so hlo_bytes_global is None.
    hlo_flops_global: float = 0.0
    hlo_bytes_global: float | None = None
    # per-rank operand and wire bytes by link (link_bytes)
    coll_by_link: dict[str, dict[str, float]] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_global / (self.chips * PEAK_FLOPS)

    @property
    def t_mem(self) -> float:
        return self.bytes_global / (self.chips * HBM_BW)

    def _t_link(self, key: str) -> float:
        # per-rank bytes over each link's rate: the global bytes over chips
        # times the rate, link by link
        return sum(v[key] / LINK_BW[link] for link, v in self.coll_by_link.items())

    @property
    def t_coll(self) -> float:
        return self._t_link("operand_bytes")

    @property
    def t_coll_wire(self) -> float:
        return self._t_link("wire_bytes")

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_mem,
            "collective": max(self.t_coll, self.t_coll_wire),
        }
        return max(terms, key=terms.get)

    def to_dict(self) -> dict[str, Any]:
        return {
            "chips": self.chips,
            "flops_global": self.flops_global,
            "bytes_global": self.bytes_global,
            "coll_bytes_global": self.coll_bytes_global,
            "coll_wire_global": self.coll_wire_global,
            "t_compute_s": self.t_compute,
            "t_mem_s": self.t_mem,
            "t_coll_s": self.t_coll,
            "t_coll_wire_s": self.t_coll_wire,
            "dominant": self.dominant,
            "hlo_flops_global": self.hlo_flops_global,
            "hlo_bytes_global": self.hlo_bytes_global,
            "collectives": self.collectives,
            "coll_by_link": self.coll_by_link,
        }


def analyze(
    records,
    traced_flops: float,
    mesh,
    chips: int,
    trip_hints: tuple[int, ...] = (),
    analytic_flops: float | None = None,
    analytic_bytes: float | None = None,
) -> Roofline:
    """The roofline of a traced step: ``records`` (:class:`Collective`\\ s)
    and ``traced_flops`` (per rank, as :class:`StepTrace` counts them)."""
    sem = calibrate_cost_semantics(mesh)
    hlo_flops = float(traced_flops) * sem["flops_scale_to_global"]
    colls = parse_collectives(records, trip_hints)
    # traced shapes are per rank -> multiply by chips for global bytes
    coll_raw = sum(c["operand_bytes"] for c in colls.values()) * chips
    coll_wire = sum(c["wire_bytes"] for c in colls.values()) * chips
    return Roofline(
        chips=chips,
        flops_global=analytic_flops if analytic_flops else hlo_flops,
        bytes_global=analytic_bytes if analytic_bytes else 0.0,
        coll_bytes_global=coll_raw,
        coll_wire_global=coll_wire,
        collectives=colls,
        hlo_flops_global=hlo_flops,
        coll_by_link=link_bytes(records, trip_hints),
    )


def model_flops(cfg, tokens: int) -> dict[str, float]:
    total, active = cfg.param_count()
    return {
        "model_flops_6ND": 6.0 * total * tokens,
        "model_flops_6NactiveD": 6.0 * active * tokens,
    }
