"""Batched alias drain: the pool's O(1) path for PRNG tenants.

Lane ``q`` resolves uniform ``xi[q]`` in row ``dist_id[q]`` of the stacked
packed ``(q, alias)`` tables with two gathers and one comparison. For CUDA
tensors this launches the hand-written kernel ``csrc/alias_sample.cu``;
for CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.ref_alias_sample_batched`. Both follow the
float32 steps of :func:`repro_torch.core.alias.np_sample_alias_f32` and
agree with it elementwise. Lanes with ``dist_id < 0`` are sentinels that
resolve to 0 without reading a row; ``coalesce`` runs the stable
sort-by-row pre-pass (elementwise identical either way).
"""
from __future__ import annotations

import torch

from . import _build
from .forest_sample import _bucket_order, _check_lanes
from .ref import ref_alias_sample_batched


def alias_sample_batched(
    q: torch.Tensor, alias: torch.Tensor, dist_id: torch.Tensor,
    xi: torch.Tensor, coalesce: bool = True,
) -> torch.Tensor:
    """(B, n) f32 / i32 stacked tables; (Q,) dist ids and f32 uniforms ->
    (Q,) int32 row-local indices."""
    if q.dim() != 2 or q.dtype != torch.float32:
        raise ValueError("alias_sample_batched: q must be a 2-D float32 tensor")
    if alias.dtype != torch.int32 or alias.shape != q.shape:
        raise ValueError("alias_sample_batched: alias must be int32 shaped like q")
    dist_id = _check_lanes("alias_sample_batched", q, dist_id, ("xi", xi, (torch.float32,)))
    if alias.device != q.device:
        raise ValueError("alias_sample_batched: q and alias must share a device")
    if coalesce:
        order, inv = _bucket_order(dist_id)
        out = _launch(q, alias, dist_id[order], xi[order])
        return out[inv]
    return _launch(q, alias, dist_id, xi)


def _launch(q, alias, dist_id, xi) -> torch.Tensor:
    if not xi.is_cuda:
        return ref_alias_sample_batched(q, alias, dist_id, xi)
    B, n = q.shape
    Q = xi.shape[0]
    out = torch.empty(Q, dtype=torch.int32, device=xi.device)
    if Q == 0:
        return out
    qc, ac, did, x = q.contiguous(), alias.contiguous(), dist_id.contiguous(), xi.contiguous()
    err = _build.library().rt_alias_sample_batched(
        qc.data_ptr(), ac.data_ptr(), did.data_ptr(), x.data_ptr(),
        out.data_ptr(), B, n, Q, _build.stream_of(x))
    _build.check(err, "alias_sample_batched")
    alias_sample_batched.launches += 1
    return out


alias_sample_batched.launches = 0
