"""Algorithm 2 over one forest: guide lookup, fallback bisection, descent.

For CUDA tensors this launches the hand-written kernel
``csrc/forest_sample.cu`` (one thread per uniform, each lane descending to
its own leaf); for CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.ref_forest_sample`. Both agree elementwise
with :func:`repro_torch.core.sample.sample_forest`. The kernel reads the
forest as :func:`forest_pack` lays it out (the fallback flag folded into the
guide entry, a node's split and children in one 16-byte record), which the
samplers make once per forest; it always reads ``cell_first`` for flagged
cells, so no host round trip decides whether any cell is flagged. A forest
of ``PACK_MAX_N`` (2^30) or more intervals has node ids that collide with
the pack's flag bit: for it the wrapper launches the six-array body
(``forest_sample_wide_kernel``), chosen from n alone, and no pack is made.

:func:`forest_sample_batched` is the multi-distribution form (the pool's
drain): lane ``q`` walks row ``dist_id[q]`` of B stacked forests, and
:func:`forest_sample_batched_streams` computes each lane's uniform in the
kernel from its QMC counter and 24-bit rotation. Both are the one-group
case of :func:`forest_sample_grouped`, which serves the stacks of many size
classes in one launch of the templated kernel
``csrc/forest_sample_batched.cu`` (a drain's forest lanes), clips each
lane's result to its tenant's range and writes it to the lane's own place.
All agree elementwise with the plain versions in
:mod:`repro_torch.kernels.ref`. Lanes with a negative row are sentinels:
they resolve to 0 without reading a row. ``coalesce`` sorts each block's
tile of lanes by (group, row, guide cell) inside the kernel; the result is
elementwise identical either way.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, groups
from .ref import ref_forest_pack, ref_forest_sample, ref_forest_sample_grouped


# Bit 30 of a packed guide entry flags the cell (csrc/forest_sample.cu), so
# node ids must stay below it.
PACK_MAX_N = 1 << 30


class PackedForest(NamedTuple):
    """The layout the ``forest_sample`` kernel reads, made by
    :func:`forest_pack` from a forest's six arrays: ``guide`` (m,) int32 is
    ``table`` with bit 30 set in flagged cells that hold a tree; ``nodes``
    (n, 4) int32 is node ``j``'s record (bits of ``cdf[j]``, ``left[j]``,
    ``right[j]``, 0), one 16-byte load a level."""

    guide: torch.Tensor
    nodes: torch.Tensor


def _check_n(name: str, n: int) -> None:
    if n >= PACK_MAX_N:
        raise ValueError(
            f"{name}: n = {n} intervals; the packed layout holds fewer than 2^30")


def _check_spec(name, spec, device) -> None:
    for tname, t, dtype, shape in spec:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {tname} must be {dtype} of shape {shape}, "
                f"got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected {device}")


def forest_pack(cdf, table, left, right, fallback) -> PackedForest:
    """The packed layout of one forest (one launch of ``forest_pack_kernel``
    for CUDA tensors, :func:`repro_torch.kernels.ref.ref_forest_pack` for CPU
    tensors). Build it once per forest and pass it to every
    :func:`forest_sample` call on that forest."""
    n, m = left.shape[0], table.shape[0]
    _check_n("forest_pack", n)
    spec = (
        ("cdf", cdf, torch.float32, (n + 1,)),
        ("table", table, torch.int32, (m,)),
        ("left", left, torch.int32, (n,)),
        ("right", right, torch.int32, (n,)),
        ("fallback", fallback, torch.bool, (m,)),
    )
    _check_spec("forest_pack", spec, table.device)
    if not table.is_cuda:
        return PackedForest(*ref_forest_pack(cdf, table, left, right, fallback))
    dev = table.device
    out = PackedForest(torch.empty(m, dtype=torch.int32, device=dev),
                       torch.empty((n, 4), dtype=torch.int32, device=dev))
    args = [t.contiguous() for _n, t, _d, _s in spec]
    err = _build.library().rt_forest_pack(
        *(t.data_ptr() for t in args), *(t.data_ptr() for t in out), n, m,
        _build.stream_of(table))
    _build.check(err, "forest_pack")
    forest_pack.launches += 1
    return out


forest_pack.launches = 0


def forest_sample(
    cdf: torch.Tensor,
    table: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    cell_first: torch.Tensor,
    fallback: torch.Tensor,
    xi: torch.Tensor,
    use_fallback: bool = True,
    packed: PackedForest | None = None,
) -> torch.Tensor:
    """Batch Algorithm 2: xi (B,) f32 -> interval indices (B,) int32.

    ``packed`` is :func:`forest_pack` of these arrays; the kernel reads it
    (and ``cdf`` and ``cell_first`` in flagged cells), and packs on the way
    where it is not given. A forest of 2^30 or more intervals takes the
    six-array body and no pack. The plain version reads the six arrays."""
    n, m = left.shape[0], table.shape[0]
    spec = (
        ("cdf", cdf, torch.float32, (n + 1,)),
        ("table", table, torch.int32, (m,)),
        ("left", left, torch.int32, (n,)),
        ("right", right, torch.int32, (n,)),
        ("cell_first", cell_first, torch.int32, (m + 1,)),
        ("fallback", fallback, torch.bool, (m,)),
        ("xi", xi, torch.float32, (xi.shape[0],)),
    )
    _check_spec("forest_sample", spec, xi.device)
    if packed is not None:
        _check_n("forest_sample", n)
        _check_spec("forest_sample", (
            ("packed.guide", packed.guide, torch.int32, (m,)),
            ("packed.nodes", packed.nodes, torch.int32, (n, 4)),
        ), xi.device)
    if not xi.is_cuda:
        return ref_forest_sample(
            cdf, table, left, right, cell_first, fallback, xi, use_fallback)
    B = xi.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=xi.device)
    if B == 0:
        return out
    if n >= PACK_MAX_N:
        args = [t.contiguous() for t in (cdf, table, left, right, cell_first, fallback, xi)]
        err = _build.library().rt_forest_sample_wide(
            *(t.data_ptr() for t in args), out.data_ptr(), m, B, int(use_fallback),
            _build.stream_of(xi))
        _build.check(err, "forest_sample")
        forest_sample.launches += 1
        return out
    if packed is None:
        packed = forest_pack(cdf, table, left, right, fallback)
    args = [t.contiguous() for t in (*packed, cdf, cell_first, xi)]
    err = _build.library().rt_forest_sample(
        *(t.data_ptr() for t in args), out.data_ptr(), m, B, int(use_fallback),
        _build.stream_of(xi))
    _build.check(err, "forest_sample")
    forest_sample.launches += 1
    return out


forest_sample.launches = 0


def _check_lanes(name, table, dist_id, *lanes) -> torch.Tensor:
    """Check the (Q,) lane inputs against ``table``'s device; returns the
    dist ids as contiguous int32."""
    if dist_id.dim() != 1 or dist_id.is_floating_point():
        raise ValueError(f"{name}: dist_id must be a 1-D integer tensor")
    for lname, t, dtypes in lanes:
        if t.dim() != 1 or t.shape != dist_id.shape or t.dtype not in dtypes:
            raise ValueError(
                f"{name}: {lname} must be 1-D {dtypes} aligned with dist_id, "
                f"got {t.dtype} {tuple(t.shape)}")
    for t in (dist_id, *(t for _n, t, _d in lanes)):
        if t.device != table.device:
            raise ValueError(f"{name}: lanes on {t.device}, tables on {table.device}")
    return dist_id.to(torch.int32).contiguous()


def _check_stack(name, cdf, table, left, right, cell_first, fallback):
    B, m = table.shape
    n = left.shape[-1]
    spec = (
        ("cdf", cdf, torch.float32, (B, n + 1)),
        ("table", table, torch.int32, (B, m)),
        ("left", left, torch.int32, (B, n)),
        ("right", right, torch.int32, (B, n)),
        ("cell_first", cell_first, torch.int32, (B, m + 1)),
        ("fallback", fallback, torch.bool, (B, m)),
    )
    _check_spec(name, spec, table.device)
    return [t.contiguous() for _n, t, _d, _s in spec]


def forest_sample_batched(
    cdf, table, left, right, cell_first, fallback,
    dist_id: torch.Tensor, xi: torch.Tensor, coalesce: bool = True,
) -> torch.Tensor:
    """Mixed-batch Algorithm 2 over B stacked forests: (Q,) dist ids and f32
    uniforms -> (Q,) int32 row-local indices, one launch (the one-group
    case of :func:`forest_sample_grouped`)."""
    tabs = _check_stack("forest_sample_batched", cdf, table, left, right,
                        cell_first, fallback)
    did = _check_lanes("forest_sample_batched", table, dist_id,
                       ("xi", xi, (torch.float32,)))
    out = torch.empty(did.shape[0], dtype=torch.int32, device=did.device)
    _grouped([tabs], None, did, None, out, xi.contiguous(), None, None, None, 0, coalesce)
    return out


def forest_sample_batched_streams(
    cdf, table, left, right, cell_first, fallback,
    dist_id: torch.Tensor, counter: torch.Tensor, offset_bits: torch.Tensor,
    coalesce: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The stream-aware drain: (Q,) dist ids, rank-adjusted QMC counters and
    24-bit rotations (uint32 values as int32 bit views, the form
    ``DeviceQmcStreams`` keeps) -> ``(idx, xi)``, the row-local indices and
    the exact float32 points the kernel drew (bit-equal to
    ``core.lds.qmc_point_np``); the one-group case of
    :func:`forest_sample_grouped`."""
    tabs = _check_stack("forest_sample_batched_streams", cdf, table, left,
                        right, cell_first, fallback)
    did = _check_lanes("forest_sample_batched_streams", table, dist_id,
                       ("counter", counter, (torch.int32,)),
                       ("offset_bits", offset_bits, (torch.int32,)))
    Q = did.shape[0]
    out = torch.empty(Q, dtype=torch.int32, device=did.device)
    xi = torch.empty(Q, dtype=torch.float32, device=did.device)
    _grouped([tabs], None, did, None, out, None, counter.contiguous(),
             offset_bits.contiguous(), xi, 0, coalesce)
    return out, xi


def forest_sample_grouped(
    stacks, gid, row: torch.Tensor, hi, out: torch.Tensor, *,
    xi=None, counter=None, offset_bits=None, xi_out=None, g0: int = 0,
    coalesce: bool = True,
) -> None:
    """Algorithm 2 over the forest stacks of several size classes, one
    launch for every ``GROUP_CAP`` of them: lane ``q`` of local group
    ``gid[q] - g0`` in ``range(len(stacks))`` descends row ``row[q]`` of
    that group's stack (``cdf, table, left, right, cell_first, fallback``)
    at ``xi[q]``, or at the QMC point of ``counter[q]`` and
    ``offset_bits[q]``, and ``min(idx, hi[q])`` goes to ``out[q]`` in
    place; other lanes are left as they are. ``gid`` None puts every lane in
    group ``g0``, ``hi`` None clips nothing, ``row < 0`` is a sentinel lane
    (0); ``xi_out`` receives the stream points. All lane arrays are (Q,)
    contiguous int32 (float32 for ``xi``, ``xi_out``). ``coalesce`` sorts
    each block's tile of lanes in the kernel; results are elementwise
    identical either way."""
    stream = counter is not None
    name = "forest_sample_batched_streams" if stream else "forest_sample_batched"
    if (xi is None) != stream or (offset_bits is not None) != stream:
        raise ValueError(f"{name}: pass xi, or counter and offset_bits")
    tabs = [_check_stack(name, *s) for s in stacks]
    groups.check_lanes(name, out.device, row.shape[0], gid=gid, row=row, hi=hi, xi=xi,
                       counter=counter, offset_bits=offset_bits, out=out, xi_out=xi_out)
    for t in tabs:
        if t[0].device != out.device:
            raise ValueError(f"{name}: a stack is on {t[0].device}, the lanes on {out.device}")
    _grouped(tabs, gid, row, hi, out, xi, counter, offset_bits, xi_out, g0, coalesce)


def _grouped(tabs, gid, row, hi, out, xi, counter, offset_bits, xi_out, g0, coalesce):
    """The launches of :func:`forest_sample_grouped` (or their plain
    versions, for CPU tensors) over checked, contiguous stacks and lanes."""
    stream = counter is not None
    Q = row.shape[0]
    for c0 in groups.chunks(len(tabs)):
        chunk = tabs[c0:c0 + groups.GROUP_CAP]
        if not out.is_cuda:
            ref_forest_sample_grouped(chunk, gid, row, hi, out, g0 + c0, xi=xi,
                                      counter=counter, offset_bits=offset_bits,
                                      xi_out=xi_out)
            continue
        if Q == 0:
            continue
        desc, flat_bits, end_bit = groups.pack(
            chunk, [(t[1].shape[0], t[2].shape[1], t[1].shape[1]) for t in chunk])
        err = _build.library().rt_forest_sample_grouped(
            desc.ctypes.data, len(chunk), g0 + c0, _ptr(gid), row.data_ptr(), _ptr(hi),
            _ptr(xi), _ptr(counter), _ptr(offset_bits), out.data_ptr(), _ptr(xi_out), Q,
            flat_bits, end_bit, int(stream), int(coalesce), _build.stream_of(out))
        _build.check(err, "forest_sample_batched")
        (forest_sample_batched_streams if stream else forest_sample_batched).launches += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


forest_sample_batched.launches = 0
forest_sample_batched_streams.launches = 0
