"""Algorithm 2 over one forest: guide lookup, fallback bisection, descent.

For CUDA tensors this launches the hand-written kernel
``csrc/forest_sample.cu`` (one thread per uniform, each lane descending to
its own leaf); for CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.ref_forest_sample`. Both agree elementwise
with :func:`repro_torch.core.sample.sample_forest`. The kernel always
receives ``cell_first`` and ``fallback``: no host round trip decides whether
any cell is flagged.

:func:`forest_sample_batched` is the multi-distribution form (the pool's
drain): lane ``q`` walks row ``dist_id[q]`` of B stacked forests, and
:func:`forest_sample_batched_streams` computes each lane's uniform in the
kernel from its QMC counter and 24-bit rotation. Both launch one templated
kernel, ``csrc/forest_sample_batched.cu``, and agree elementwise with the
plain versions in :mod:`repro_torch.kernels.ref`. Lanes with
``dist_id < 0`` are sentinels: they resolve to 0 without reading a row.
``coalesce`` runs the pre-pass :func:`_bucket_order` outside the kernel (a
stable sort of the lanes by row, undone on the way out), as the JAX package
does outside ``pallas_call``; the result is elementwise identical either
way.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import (
    ref_forest_sample,
    ref_forest_sample_batched,
    ref_forest_sample_batched_streams,
)


def forest_sample(
    cdf: torch.Tensor,
    table: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    cell_first: torch.Tensor,
    fallback: torch.Tensor,
    xi: torch.Tensor,
    use_fallback: bool = True,
) -> torch.Tensor:
    """Batch Algorithm 2: xi (B,) f32 -> interval indices (B,) int32."""
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
    for name, t, dtype, shape in spec:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"forest_sample: {name} must be {dtype} of shape {shape}, "
                f"got {t.dtype} {tuple(t.shape)}")
        if t.device != xi.device:
            raise ValueError(f"forest_sample: {name} is on {t.device}, xi on {xi.device}")
    if not xi.is_cuda:
        return ref_forest_sample(
            cdf, table, left, right, cell_first, fallback, xi, use_fallback)
    B = xi.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=xi.device)
    if B == 0:
        return out
    args = [t.contiguous() for _n, t, _d, _s in spec]
    err = _build.library().rt_forest_sample(
        *(t.data_ptr() for t in args), out.data_ptr(), m, B,
        int(use_fallback), _build.stream_of(xi))
    _build.check(err, "forest_sample")
    forest_sample.launches += 1
    return out


forest_sample.launches = 0


def _bucket_order(did: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The coalescing pre-pass: a stable sort of the lanes by row. Returns
    the gather permutation and its inverse scatter permutation; sentinel
    lanes (``did < 0``) group in front."""
    order = torch.sort(did, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return order, inv


def _check_lanes(name, table, dist_id, *lanes) -> torch.Tensor:
    """Check the (Q,) lane inputs against ``table``'s device; returns the
    dist ids as int32."""
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
    return dist_id.to(torch.int32)


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
    for tname, t, dtype, shape in spec:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {tname} must be {dtype} of shape {shape}, "
                f"got {t.dtype} {tuple(t.shape)}")
        if t.device != table.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, table on {table.device}")
    return [t.contiguous() for _n, t, _d, _s in spec]


def forest_sample_batched(
    cdf, table, left, right, cell_first, fallback,
    dist_id: torch.Tensor, xi: torch.Tensor, coalesce: bool = True,
) -> torch.Tensor:
    """Mixed-batch Algorithm 2 over B stacked forests: (Q,) dist ids and f32
    uniforms -> (Q,) int32 row-local interval indices, one launch."""
    tabs = _check_stack("forest_sample_batched", cdf, table, left, right,
                        cell_first, fallback)
    did = _check_lanes("forest_sample_batched", table, dist_id,
                       ("xi", xi, (torch.float32,)))
    inv = None
    if coalesce:
        order, inv = _bucket_order(did)
        did, xi = did[order], xi[order]
    if not xi.is_cuda:
        out = ref_forest_sample_batched(*tabs, did, xi)
    else:
        out = torch.empty(xi.shape[0], dtype=torch.int32, device=xi.device)
        if xi.shape[0]:
            x = xi.contiguous()
            _launch_batched(tabs, did.contiguous(), x, None, None, out, None)
            forest_sample_batched.launches += 1
    return out if inv is None else out[inv]


def forest_sample_batched_streams(
    cdf, table, left, right, cell_first, fallback,
    dist_id: torch.Tensor, counter: torch.Tensor, offset_bits: torch.Tensor,
    coalesce: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The stream-aware drain: (Q,) dist ids, rank-adjusted QMC counters and
    24-bit rotations (uint32 values as int32 bit views, the form
    ``DeviceQmcStreams`` keeps) -> ``(idx, xi)``, the row-local indices and
    the exact float32 points the kernel drew (bit-equal to
    ``core.lds.qmc_point_np``)."""
    tabs = _check_stack("forest_sample_batched_streams", cdf, table, left,
                        right, cell_first, fallback)
    did = _check_lanes("forest_sample_batched_streams", table, dist_id,
                       ("counter", counter, (torch.int32,)),
                       ("offset_bits", offset_bits, (torch.int32,)))
    inv = None
    if coalesce:
        order, inv = _bucket_order(did)
        did, counter, offset_bits = did[order], counter[order], offset_bits[order]
    if not counter.is_cuda:
        out, xi = ref_forest_sample_batched_streams(*tabs, did, counter, offset_bits)
    else:
        Q = counter.shape[0]
        out = torch.empty(Q, dtype=torch.int32, device=counter.device)
        xi = torch.empty(Q, dtype=torch.float32, device=counter.device)
        if Q:
            _launch_batched(tabs, did.contiguous(), None, counter.contiguous(),
                            offset_bits.contiguous(), out, xi)
            forest_sample_batched_streams.launches += 1
    if inv is not None:
        out, xi = out[inv], xi[inv]
    return out, xi


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_batched(tabs, did, xi, ctr, off, out, xi_out) -> None:
    B, m = tabs[1].shape
    n = tabs[2].shape[1]
    err = _build.library().rt_forest_sample_batched(
        *(t.data_ptr() for t in tabs), did.data_ptr(), _ptr(xi), _ptr(ctr),
        _ptr(off), out.data_ptr(), _ptr(xi_out), B, n, m, did.shape[0],
        int(ctr is not None), _build.stream_of(did))
    _build.check(err, "forest_sample_batched")


forest_sample_batched.launches = 0
forest_sample_batched_streams.launches = 0
