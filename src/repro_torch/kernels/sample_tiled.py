"""Per-row inverse-CDF search for decode sampling: the two-level tiled
count.

Each of B rows has its own inclusive CDF (one softmax row of the decode
logits) and k uniforms. Level 1 counts the row's tile cutpoints (the last
entry of each 512-wide tile) ``<= xi``; level 2 counts the entries of the
one chosen tile ``<= xi`` (see :func:`repro_torch.kernels.ref.
ref_sample_rows` for the exact clipping). For CUDA tensors this launches
the hand-written kernel ``csrc/sample_tiled.cu``; for CPU tensors it runs
the plain version. Comparisons are exact, so the two agree elementwise on
any rows, monotone or not.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import SAMPLE_TILE as TILE
from .ref import ref_sample_rows


def sample_rows(cdf_rows: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """cdf_rows (B, V) float32 inclusive CDFs, xi (B, k) float32 uniforms
    -> (B, k) int32 indices."""
    if cdf_rows.dim() != 2 or cdf_rows.dtype != torch.float32:
        raise ValueError("sample_rows: cdf_rows must be a 2-D float32 tensor")
    if xi.dim() != 2 or xi.dtype != torch.float32 or xi.shape[0] != cdf_rows.shape[0]:
        raise ValueError("sample_rows: xi must be a (B, k) float32 tensor")
    if xi.device != cdf_rows.device:
        raise ValueError("sample_rows: cdf_rows and xi must share a device")
    B, V = cdf_rows.shape
    if V == 0:
        raise ValueError("sample_rows: rows must not be empty")
    if xi.numel() >= 2**31:
        raise ValueError("sample_rows: at most 2^31 - 1 draws a call")
    if not cdf_rows.is_cuda:
        return ref_sample_rows(cdf_rows, xi)
    k = xi.shape[1]
    out = torch.empty((B, k), dtype=torch.int32, device=xi.device)
    if B * k == 0:
        return out
    c, x = cdf_rows.contiguous(), xi.contiguous()
    err = _build.library().rt_sample_rows(
        c.data_ptr(), x.data_ptr(), out.data_ptr(), B, V, k, _build.stream_of(x))
    _build.check(err, "sample_rows")
    sample_rows.launches += 1
    return out


sample_rows.launches = 0
