"""Batched alias drain: the pool's O(1) path for PRNG tenants.

Lane ``q`` resolves uniform ``xi[q]`` in row ``dist_id[q]`` of the stacked
packed ``(q, alias)`` tables with two gathers and one comparison. For CUDA
tensors this launches the hand-written kernel ``csrc/alias_sample.cu``;
for CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.ref_alias_sample_batched`. Both follow the
float32 steps of :func:`repro_torch.core.alias.np_sample_alias_f32` and
agree with it elementwise. Lanes with a negative row are sentinels that
resolve to 0 without reading a row. :func:`alias_sample_grouped` serves the
tables of many size classes in one launch (a drain's alias lanes), clipped
to each tenant's range and written to each lane's own place;
:func:`alias_sample_batched` is its one-group case. ``coalesce`` sorts each
block's tile of lanes by (group, row, cell) inside the kernel (elementwise
identical either way).
"""
from __future__ import annotations

import torch

from . import _build, groups
from .forest_sample import _check_lanes, _ptr
from .ref import ref_alias_sample_grouped


def _check_table(q: torch.Tensor, alias: torch.Tensor):
    if q.dim() != 2 or q.dtype != torch.float32:
        raise ValueError("alias_sample_batched: q must be a 2-D float32 tensor")
    if alias.dtype != torch.int32 or alias.shape != q.shape:
        raise ValueError("alias_sample_batched: alias must be int32 shaped like q")
    if alias.device != q.device:
        raise ValueError("alias_sample_batched: q and alias must share a device")
    return q.contiguous(), alias.contiguous()


def alias_sample_batched(
    q: torch.Tensor, alias: torch.Tensor, dist_id: torch.Tensor,
    xi: torch.Tensor, coalesce: bool = True,
) -> torch.Tensor:
    """(B, n) f32 / i32 stacked tables; (Q,) dist ids and f32 uniforms ->
    (Q,) int32 row-local indices."""
    tab = _check_table(q, alias)
    did = _check_lanes("alias_sample_batched", q, dist_id, ("xi", xi, (torch.float32,)))
    out = torch.empty(did.shape[0], dtype=torch.int32, device=did.device)
    _grouped([tab], None, did, None, out, xi.contiguous(), 0, coalesce)
    return out


def alias_sample_grouped(tables, gid, row: torch.Tensor, hi, out: torch.Tensor,
                         xi: torch.Tensor, g0: int = 0, coalesce: bool = True) -> None:
    """The alias drain over the ``(q, alias)`` stacks of several size
    classes, one launch for every ``GROUP_CAP`` of them: lane ``q`` of local
    group ``gid[q] - g0`` in ``range(len(tables))`` resolves ``xi[q]`` in
    row ``row[q]`` of that group's stack, and ``min(idx, hi[q])`` goes to
    ``out[q]`` in place; other lanes are left as they are. ``gid`` None puts
    every lane in group ``g0``, ``hi`` None clips nothing, ``row < 0`` is a
    sentinel lane (0). Lane arrays are (Q,) contiguous int32 (``xi``
    float32)."""
    name = "alias_sample_batched"
    tabs = [_check_table(*t) for t in tables]
    groups.check_lanes(name, out.device, row.shape[0], gid=gid, row=row, hi=hi, xi=xi,
                       out=out)
    for t in tabs:
        if t[0].device != out.device:
            raise ValueError(f"{name}: a table is on {t[0].device}, the lanes on {out.device}")
    _grouped(tabs, gid, row, hi, out, xi, g0, coalesce)


def _grouped(tabs, gid, row, hi, out, xi, g0, coalesce):
    """The launches of :func:`alias_sample_grouped` (or their plain
    versions, for CPU tensors) over checked, contiguous tables and lanes."""
    Q = row.shape[0]
    for c0 in groups.chunks(len(tabs)):
        chunk = tabs[c0:c0 + groups.GROUP_CAP]
        if not out.is_cuda:
            ref_alias_sample_grouped(chunk, gid, row, hi, out, g0 + c0, xi)
            continue
        if Q == 0:
            continue
        desc, flat_bits, end_bit = groups.pack(
            chunk, [(t[0].shape[0], t[0].shape[1], t[0].shape[1]) for t in chunk])
        err = _build.library().rt_alias_sample_grouped(
            desc.ctypes.data, len(chunk), g0 + c0, _ptr(gid), row.data_ptr(), _ptr(hi),
            xi.data_ptr(), out.data_ptr(), Q, flat_bits, end_bit, int(coalesce),
            _build.stream_of(out))
        _build.check(err, "alias_sample_batched")
        alias_sample_batched.launches += 1


alias_sample_batched.launches = 0
