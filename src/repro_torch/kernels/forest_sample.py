"""Algorithm 2 over one forest: guide lookup, fallback bisection, descent.

For CUDA tensors this launches the hand-written kernel
``csrc/forest_sample.cu`` (one thread per uniform, each lane descending to
its own leaf); for CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.ref_forest_sample`. Both agree elementwise
with :func:`repro_torch.core.sample.sample_forest`. The kernel always
receives ``cell_first`` and ``fallback``: no host round trip decides whether
any cell is flagged.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import ref_forest_sample


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
