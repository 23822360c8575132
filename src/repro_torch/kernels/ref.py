"""Plain PyTorch versions of the hand-written kernels.

Each wrapper runs these for a CPU tensor; the CPU tests and the card check
in ``chip_smoke.py`` compare the kernels against them. Nothing on the main
path calls them for a CUDA tensor.
"""
from __future__ import annotations

import torch

# repro_torch.core imports the kernel wrappers, which import this module,
# so this module imports core lazily.


def ref_cdf_scan(
    x: torch.Tensor, softmax: bool = True, normalize: bool = True
) -> torch.Tensor:
    """(B, V) -> (B, V) inclusive row CDFs, float32.

    The same formula as the kernel: each element is normalized first
    (``exp(x - max) / sum`` or ``x / sum``) and the normalized row is then
    scanned; ``normalize=False`` (weights only) is the raw row cumsum."""
    if softmax and not normalize:
        raise ValueError("normalize=False requires softmax=False (raw cumsum)")
    x = x.to(torch.float32)
    if softmax:
        e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
        e = e / e.sum(dim=-1, keepdim=True).expand_as(e)
    elif normalize:
        e = x / x.sum(dim=-1, keepdim=True).expand_as(x)
    else:
        e = x
    return torch.cumsum(e, dim=-1)


def ref_forest_delta(data: torch.Tensor, m: int) -> torch.Tensor:
    """(n,) f32 lower bounds -> (n-1,) separator distances as int64 holding
    the uint32 value: ``bits(a[k]) ^ bits(a[k+1])``, or the sentinel where
    the two bounds fall in different guide cells (cells clipped to [0, m-1]
    exactly like ``core.forest._cells``)."""
    from repro_torch.core.bits import DIST_SENTINEL, float_to_bits

    bits = float_to_bits(data)
    cells = torch.clamp(torch.floor(data * float(m)).to(torch.int32), 0, m - 1)
    raw = bits[:-1] ^ bits[1:]
    return torch.where(
        cells[:-1] != cells[1:], torch.full_like(raw, DIST_SENTINEL), raw
    )


def ref_forest_sample(
    cdf, table, left, right, cell_first, fallback, xi, use_fallback: bool = True
) -> torch.Tensor:
    """Algorithm 2, lane by lane as ``core.sample.sample_forest``: guide
    lookup, optional 32-trip bisection in flagged cells, then descent until
    every lane holds a leaf (at most ``MAX_DEPTH`` trips)."""
    from repro_torch.core.forest import MAX_DEPTH
    from repro_torch.core.sample import _bisect, _guide_cell

    n = left.shape[0]
    g = _guide_cell(xi, table.shape[0])
    j = table[g].to(torch.int64)
    if use_fallback:
        fb = fallback[g] & (j >= 0)
        bal = _bisect(cdf, xi, cell_first[g].long(), cell_first[g + 1].long(), 32)
        j = torch.where(fb, ~bal, j)
    left, right = left.long(), right.long()
    for _ in range(MAX_DEPTH):
        active = j >= 0
        if not bool(active.any()):
            break
        jj = torch.clamp(j, 0, n - 1)
        nxt = torch.where(xi < cdf[jj], left[jj], right[jj])
        j = torch.where(active, nxt, j)
    return (~j).to(torch.int32)
