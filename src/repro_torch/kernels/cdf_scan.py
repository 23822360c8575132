"""Row-wise CDF scan: softmax, normalized-weights and raw modes.

For a CUDA tensor this launches the hand-written kernel ``csrc/cdf_scan.cu``
(one block per row, a loop over the row's tiles with a running carry); for
a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.ref_cdf_scan`. The raw mode is the row scan
of :func:`repro_torch.core.cdf.chunked_cumsum` on the main path.

Tolerance: the kernel reassociates the sum (tile tree plus carry chain), so
it agrees with the plain version and with the JAX kernel to within
``SCAN_ATOL`` times the row total, not bit for bit. For non-negative terms
any summation order errs by at most (depth) * 2^-24 * total; the depth of
either order at rows up to ~50k is below ~100 additions, and the JAX
suite holds its own kernel to its reference with the same 3e-6.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import ref_cdf_scan

SCAN_ATOL = 3e-6  # times the row total (1 for the normalized modes)

_MODE_SOFTMAX, _MODE_WEIGHTS, _MODE_RAW = 0, 1, 2


def cdf_scan(
    x: torch.Tensor, softmax: bool = True, normalize: bool = True
) -> torch.Tensor:
    """(B, V) logits (``softmax=True``) or non-negative weights -> (B, V)
    float32 inclusive CDF rows (leading 0 omitted). ``normalize=False``
    (weights only) emits the raw inclusive row cumsum."""
    if softmax and not normalize:
        raise ValueError("normalize=False requires softmax=False (raw cumsum)")
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("cdf_scan: x must be a 2-D float32 or bfloat16 tensor")
    if not x.is_cuda:
        return ref_cdf_scan(x, softmax=softmax, normalize=normalize)
    B, V = x.shape
    out = torch.empty((B, V), dtype=torch.float32, device=x.device)
    if B == 0 or V == 0:
        return out
    x = x.contiguous()
    mode = _MODE_SOFTMAX if softmax else _MODE_WEIGHTS if normalize else _MODE_RAW
    err = _build.library().rt_cdf_scan(
        x.data_ptr(), out.data_ptr(), B, V, mode,
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(err, "cdf_scan")
    cdf_scan.launches += 1
    return out


cdf_scan.launches = 0
