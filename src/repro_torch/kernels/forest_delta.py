"""Separator distances of forest construction (Algorithm 1's O(n) pass).

``delta(k) = bits(data[k]) XOR bits(data[k+1])``, set to the sentinel where
the two lower bounds fall into different guide cells. For a CUDA tensor this
launches the hand-written kernel ``csrc/forest_delta.cu``; for a CPU tensor
it runs the plain version :func:`repro_torch.kernels.ref.ref_forest_delta`.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import ref_forest_delta


def forest_delta(data: torch.Tensor, m: int) -> torch.Tensor:
    """data (n,) f32 increasing lower bounds -> (n-1,) distances as int64
    holding the uint32 values (the kernel writes uint32 bits; the int64
    zero-extension is what the nearest-greater search compares)."""
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
    out = torch.empty(n - 1, dtype=torch.int32, device=data.device)
    err = _build.library().rt_forest_delta(
        data.data_ptr(), out.data_ptr(), n, m, _build.stream_of(data))
    _build.check(err, "forest_delta")
    forest_delta.launches += 1
    return out.to(torch.int64) & 0xFFFFFFFF


forest_delta.launches = 0
