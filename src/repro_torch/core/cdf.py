"""CDF construction: the inversion-method substrate.

``build_cdf`` turns weights into the partition 0 = P_0 < P_1 < ... < P_n = 1
as a parallel prefix sum over a fixed grid of ``SCAN_CHUNKS`` rows. On the
card the row scan is the hand-written ``cdf_scan`` kernel in raw mode
(:mod:`repro_torch.kernels.cdf_scan`); on the CPU it is its plain version.

The scan does not reproduce XLA's reassociation, so the port's CDF bits may
differ from ``repro.core.build_cdf`` by a few ulp; ``finalize_cdf`` is
bit-equal given equal raw sums. The interval lower bounds used as radix-tree
keys are ``cdf[:-1]``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import to_device
from repro_torch.kernels.cdf_scan import cdf_scan

_ONE_MINUS_EPS = float(np.nextafter(np.float32(1.0), np.float32(0.0)))

# Fixed reassociation grid: SCAN_CHUNKS independent row scans plus a serial
# carry over the row totals, the same grid as the JAX package's.
SCAN_CHUNKS = 64


def normalize_weights(w: np.ndarray) -> np.ndarray:
    """Float64 normalization for high-dynamic-range weights.

    Distributions like the paper's ``p_i ~ i^20`` overflow float32 *before*
    normalization; normalize in float64 on the host first, then feed float32.
    """
    w = np.asarray(w, np.float64)
    s = w.sum()
    if not np.isfinite(s) or s <= 0:
        raise ValueError("weights must be non-negative with a positive finite sum")
    return (w / s).astype(np.float32)


def updated_weights(raw, weights=None, delta=None):
    """New raw float64 weights + their normalized float32 form: pass new
    full ``weights``, or a ``delta`` added to the current ``raw``."""
    if (weights is None) == (delta is None):
        raise ValueError("pass exactly one of weights or delta")
    if weights is None:
        raw = np.asarray(raw, np.float64) + np.asarray(delta, np.float64)
    else:
        raw = np.asarray(weights, np.float64)
    return raw, normalize_weights(raw)


def scan_chunk_rows(w: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., SCAN_CHUNKS, L) zero-padded chunk rows: the scan
    grid of each distribution."""
    n = w.shape[-1]
    L = -(-n // SCAN_CHUNKS)
    rows = F.pad(w, (0, SCAN_CHUNKS * L - n))
    return rows.reshape(*w.shape[:-1], SCAN_CHUNKS, L)


def chunk_bounds(n: int) -> np.ndarray:
    """Element spans of the scan-grid rows: row r covers [b[r], b[r+1])."""
    L = -(-n // SCAN_CHUNKS)
    return np.minimum(np.arange(SCAN_CHUNKS + 1, dtype=np.int64) * L, n)


def _raw_row_scan(rows: torch.Tensor) -> torch.Tensor:
    return cdf_scan(rows, softmax=False, normalize=False)


def chunked_cumsum(w: torch.Tensor, row_scan=None) -> torch.Tensor:
    """Inclusive prefix sum over the fixed ``SCAN_CHUNKS`` grid, for one
    distribution (n,) or a stack of them (B, n).

    Every chunk row of every distribution is scanned independently by
    ``row_scan`` in one launch (default: the ``cdf_scan`` kernel in raw
    mode, or its plain version for a CPU tensor); the serial carry over each
    distribution's chunk totals is one more raw row scan. A row of a stack
    therefore gets the same bits as the same weights scanned alone."""
    scan = _raw_row_scan if row_scan is None else row_scan
    n = w.shape[-1]
    rows = scan_chunk_rows(w.reshape(-1, n))           # (B, 64, L)
    B, C, L = rows.shape
    local = scan(rows.reshape(B * C, L)).reshape(B, C, L)
    carry = scan(local[:, :, -1].contiguous())         # (B, 64) inclusive
    carry = F.pad(carry[:, :-1], (1, 0))               # exclusive
    out = (local + carry[:, :, None]).reshape(B, C * L)[:, :n]
    return out.reshape(w.shape)


def _cummax(c: torch.Tensor) -> torch.Tensor:
    """Running maximum along the last axis, in two levels over rows of about
    sqrt(n): ``torch.cummax`` scans a 1-D CUDA tensor within one thread
    block. Max is exact, so the result equals ``torch.cummax`` bit for bit."""
    n = c.shape[-1]
    L = max(1, math.isqrt(n))
    R = -(-n // L)
    flat = c.reshape(-1, n)
    rows = F.pad(flat, (0, R * L - n)).reshape(flat.shape[0], R, L)
    local = torch.cummax(rows, 2).values
    carry = torch.cummax(local[:, :, -1], 1).values
    carry = F.pad(carry[:, :-1], (1, 0), value=-math.inf)
    out = torch.maximum(local, carry[:, :, None]).reshape(flat.shape[0], R * L)
    return out[:, :n].reshape(c.shape)


def finalize_cdf(raw: torch.Tensor) -> torch.Tensor:
    """Raw inclusive scan (..., n) -> normalized cdf (..., n+1) with exact
    endpoints, row by row.

    Divides by a same-device tensor: PyTorch's CUDA division by a host
    scalar multiplies by its reciprocal, which is not IEEE division."""
    total = raw[..., -1:].expand_as(raw)
    c = torch.clamp(raw / total, 0.0, 1.0).to(torch.float32)
    c[..., -1] = 1.0
    c = _cummax(c)  # monotone under float rounding
    return F.pad(c, (1, 0))


def build_cdf(weights, row_scan=None, device="cuda") -> torch.Tensor:
    """Normalized inclusive prefix sum with exact 0/1 endpoints.

    ``weights`` (n,) gives ``cdf`` (n+1,) float32 on ``device`` with
    cdf[0] == 0 and cdf[n] == 1; a stack (B, n) gives (B, n+1), each row
    bit-equal to that row's own ``build_cdf``. Weights must be non-negative
    with a positive sum; ties (zero-width intervals) are permitted."""
    w = to_device(weights, device, torch.float32)
    return finalize_cdf(chunked_cumsum(w, row_scan=row_scan))


def cdf_from_logits(logits, temperature: float = 1.0, device="cuda") -> torch.Tensor:
    """Stable softmax -> CDF along the last axis; shape (..., n) -> (..., n+1)."""
    x = to_device(logits, device)
    x = (x / temperature).to(torch.float32)
    x = x - torch.amax(x, dim=-1, keepdim=True)
    c = torch.cumsum(torch.exp(x), dim=-1)
    c = torch.clamp(c / c[..., -1:].expand_as(c), 0.0, 1.0)
    c = torch.cummax(c, dim=-1).values
    c[..., -1] = 1.0
    return torch.cat([c.new_zeros(c.shape[:-1] + (1,)), c], dim=-1)


def lower_bounds(cdf: torch.Tensor) -> torch.Tensor:
    """Interval lower bounds P_0..P_{n-1} (the radix-tree keys) in [0, 1).

    Clamps the never-sampled exactly-1.0 lower bound of a zero-width
    trailing interval."""
    return torch.clamp_max(cdf[..., :-1], _ONE_MINUS_EPS)


def np_build_cdf(weights: np.ndarray) -> np.ndarray:
    """Numpy oracle for tests (float64 accumulate, float32 out)."""
    w = np.asarray(weights, np.float64)
    c = np.cumsum(w)
    c = (c / c[-1]).astype(np.float32)
    c = np.clip(c, 0.0, 1.0)
    c[-1] = 1.0
    c = np.maximum.accumulate(c)
    return np.concatenate([[np.float32(0.0)], c])
