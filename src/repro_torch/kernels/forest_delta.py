"""Separator distances of forest construction (Algorithm 1's O(n) pass).

``delta(k) = bits(data[k]) XOR bits(data[k+1])``, set to the sentinel where
the two lower bounds fall into different guide cells. For a CUDA tensor this
launches the hand-written kernel ``csrc/forest_delta.cu``; for a CPU tensor
it runs the plain version :func:`repro_torch.kernels.ref.ref_forest_delta`.

:func:`forest_delta_update` is the weight-update form: the distances of the
new lower bounds and, in the same pass, the mask of leaves whose float32
bits moved (one fused kernel, ``rt_forest_delta_update``).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import ref_forest_delta, ref_forest_delta_update


def forest_delta(data: torch.Tensor, m: int) -> torch.Tensor:
    """data (n,) f32 increasing lower bounds -> (n-1,) distances as int64
    holding the uint32 values (the zero-extension the nearest-greater search
    compares; the kernel writes it directly)."""
    if data.dim() != 1 or data.dtype != torch.float32:
        raise ValueError("forest_delta: data must be a 1-D float32 tensor")
    if not 1 <= m < 2**24:
        raise ValueError("forest_delta: m must be in [1, 2^24)")
    if not data.is_cuda:
        return ref_forest_delta(data, m)
    n = data.shape[0]
    if n < 2:
        return torch.empty(0, dtype=torch.int64, device=data.device)
    data = data.contiguous()
    out = torch.empty(n - 1, dtype=torch.int64, device=data.device)
    err = _build.library().rt_forest_delta(
        data.data_ptr(), out.data_ptr(), n, m, _build.stream_of(data))
    _build.check(err, "forest_delta")
    forest_delta.launches += 1
    return out


forest_delta.launches = 0


def forest_delta_update(
    data_old: torch.Tensor, data_new: torch.Tensor, m: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Old and new (n,) f32 lower bounds -> ``(distances, changed)``: the
    (n-1,) distances of ``data_new`` (bit-equal to :func:`forest_delta`,
    int64 holding the uint32 values) and the (n,) bool mask of leaves whose
    float32 bit pattern moved."""
    for name, t in (("data_old", data_old), ("data_new", data_new)):
        if t.dim() != 1 or t.dtype != torch.float32:
            raise ValueError(f"forest_delta_update: {name} must be a 1-D float32 tensor")
    if data_old.shape != data_new.shape or data_old.device != data_new.device:
        raise ValueError("forest_delta_update: old and new must match in shape and device")
    if not 1 <= m < 2**24:
        raise ValueError("forest_delta_update: m must be in [1, 2^24)")
    if not data_new.is_cuda:
        return ref_forest_delta_update(data_old, data_new, m)
    n = data_new.shape[0]
    out = torch.empty(max(n - 1, 0), dtype=torch.int64, device=data_new.device)
    changed = torch.empty(n, dtype=torch.bool, device=data_new.device)
    if n == 0:
        return out, changed
    old, new = data_old.contiguous(), data_new.contiguous()
    err = _build.library().rt_forest_delta_update(
        old.data_ptr(), new.data_ptr(), out.data_ptr(), changed.data_ptr(),
        n, m, _build.stream_of(new))
    _build.check(err, "forest_delta_update")
    forest_delta_update.launches += 1
    return out, changed


forest_delta_update.launches = 0
