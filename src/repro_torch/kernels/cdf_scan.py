"""Row-wise CDF scan: softmax, normalized-weights and raw modes.

For a CUDA tensor this launches the hand-written kernel ``csrc/cdf_scan.cu``
(one block per row, a loop over the row's tiles with a running carry); for
a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.ref_cdf_scan`. The raw mode is the row scan
of :func:`repro_torch.core.cdf.chunked_cumsum` on the main path.

Tolerance: the kernel reassociates the sum (tile tree plus carry chain), so
it agrees with the plain version and with the JAX kernel to within
``SCAN_ATOL`` times the row total, not bit for bit. For non-negative terms
a prefix summed in any order errs by at most (additions on its path) *
2^-24 * total. The kernel's path is at most 12 additions inside a 1024-wide
tile (4 sequential items, 5 warp-shuffle levels, 3 over the 8 warps) plus
one carry addition per earlier tile: 62 at V = 50257, 160 at V = 151936
(the Qwen vocabulary, the decode path's rows). The worst case, 160 * 2^-24
= 9.5e-6 at 151936, needs every rounding to err the same way; rounding to
nearest errs both ways, so a long carry chain's error grows like the
square root of its length, about 13 * 2^-24 = 7.5e-7 there. The JAX suite
holds its own kernel to its reference with the same 3e-6; at V = 151936
``tests/test_torch_sample_rows.py`` holds the plain scan to the JAX
reference, and ``chip_smoke.py``'s serve phase holds every card CDF row of
the decode path to the plain scan, both within ``SCAN_ATOL``.
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
