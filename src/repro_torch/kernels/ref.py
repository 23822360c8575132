"""Plain PyTorch versions of the hand-written kernels.

Each wrapper runs these for a CPU tensor; the CPU tests and the card check
in ``chip_smoke.py`` compare the kernels against them. Nothing on the main
path calls them for a CUDA tensor.
"""
from __future__ import annotations

import math

import torch

# repro_torch.core imports the kernel wrappers, which import this module,
# so this module imports core lazily.


def ref_cdf_scan(
    x: torch.Tensor, softmax: bool = True, normalize: bool = True
) -> torch.Tensor:
    """(B, V) -> (B, V) inclusive row CDFs, float32.

    Each element is normalized first (``exp(x - max) / sum`` or ``x / sum``)
    and the normalized row is then scanned, as in the JAX kernel; the CUDA
    kernel scans the terms and divides each prefix by the row's total (the
    same function, within ``SCAN_ATOL``). ``normalize=False`` (weights
    only) is the raw row cumsum."""
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


def ref_forest_delta_update(data_old: torch.Tensor, data_new: torch.Tensor, m: int):
    """Distances of the new lower bounds (as :func:`ref_forest_delta`) and
    the (n,) mask of leaves whose float32 bit pattern moved."""
    changed = data_old.view(torch.int32) != data_new.view(torch.int32)
    return ref_forest_delta(data_new, m), changed


def _batched_descent(cdf, table, left, right, cell_first, fallback, dist_id, xi):
    """Mixed-batch Algorithm 2 with 2-D gathers: lane q walks row
    ``dist_id[q]`` (clamped to B-1); sentinel lanes (``dist_id < 0``) start
    at leaf ``~0`` and never descend."""
    from repro_torch.core.forest import MAX_DEPTH
    from repro_torch.core.sample import _guide_cell

    B, m = table.shape
    raw = dist_id.long()
    valid = raw >= 0
    did = torch.clamp(raw, 0, B - 1)
    g = _guide_cell(xi, m)
    j = torch.where(valid, table[did, g].long(), -1)
    flagged = fallback[did, g] & (j >= 0)
    lo, hi = cell_first[did, g].long(), cell_first[did, g + 1].long()
    for _ in range(32):
        mid = (lo + hi + 1) >> 1
        ge = xi >= cdf[did, mid]
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid - 1)
    j = torch.where(flagged, ~lo, j)
    n = left.shape[1]
    for _ in range(MAX_DEPTH):
        active = j >= 0
        if not bool(active.any()):
            break
        jj = torch.clamp(j, 0, n - 1)
        nxt = torch.where(xi < cdf[did, jj], left[did, jj], right[did, jj]).long()
        j = torch.where(active, nxt, j)
    return (~j).to(torch.int32)


def ref_forest_sample_batched(
    cdf, table, left, right, cell_first, fallback, dist_id, xi
) -> torch.Tensor:
    """Lane by lane as ``core.sample.sample_forest`` of the lane's row:
    guide lookup, 32-trip bisection in flagged cells, then descent until
    every lane holds a leaf. Sentinel lanes resolve to 0."""
    return _batched_descent(cdf, table, left, right, cell_first, fallback,
                            dist_id, xi)


def ref_forest_sample_batched_streams(
    cdf, table, left, right, cell_first, fallback, dist_id, counter, offset_bits
):
    """The exact 24-bit stream point of each lane (``core.lds.qmc_point``
    of the int32 counter and offset bits), then the batched descent.
    Returns ``(idx, xi)``."""
    from repro_torch.core.lds import qmc_point

    xi = qmc_point(counter, offset_bits)
    return _batched_descent(cdf, table, left, right, cell_first, fallback,
                            dist_id, xi), xi


def ref_alias_build_batched(weights: torch.Tensor):
    """(B, n) weights -> packed ``(q, alias)`` (B, n) float32 / int32: the
    positional split-and-pack row core of the JAX package's
    ``alias_split_pack_rows``, in torch. Demand and supply are cumsums of
    masked per-cell terms over the original cell order, pinned bit-flat
    between member cells by a running max; three searches per cell then
    land on original heavy indices. Zero-weight (padded) cells become
    q == 0 lights that are never an alias target.

    The per-cell terms are float32 as in the JAX core, but the two tapes
    (and the debts taken from them) are carried in float64: in float32 the
    tapes of a 65536-cell row reach ~4e4, where an ulp is ~4e-3, and
    boundary ties between them misroute whole light cells (mass off by up
    to 1 per cell). On dyadic rows both precisions are exact, so the
    tables equal the JAX core's bit for bit."""
    w = weights.to(torch.float32)
    R, n = w.shape
    pos = torch.arange(n, dtype=torch.int64, device=w.device).expand(R, n)
    wsum = w.sum(dim=-1, keepdim=True)
    npi = w / wsum.expand_as(w) * float(n)
    light = npi < 1.0
    heavy = ~light
    zero = torch.zeros_like(npi)
    dvals = torch.where(light, 1.0 - npi, zero).double()
    svals = torch.where(heavy, npi - 1.0, zero).double()
    ninf = torch.full_like(dvals, -math.inf)
    D = torch.cummax(torch.where(light, torch.cumsum(dvals, -1), ninf), -1).values
    S = torch.cummax(torch.where(heavy, torch.cumsum(svals, -1), ninf), -1).values
    total = torch.minimum(D[:, -1:], S[:, -1:])
    has_both = light.any(-1, keepdim=True) & heavy.any(-1, keepdim=True)
    last_heavy = torch.clamp(
        torch.where(heavy, pos, -1).amax(-1, keepdim=True), min=0)

    def pick(p):  # a search result, or the last heavy past the end
        return torch.where(p < n, torch.clamp(p, max=n - 1), last_heavy)

    alias_light = pick(torch.searchsorted(S, D - dvals, right=True))
    x = S
    pj = torch.searchsorted(D, x, right=False)
    inside = (pj < n) & (x < total) & (svals > 0.0)
    Dj = torch.gather(D, 1, torch.clamp(pj, max=n - 1))
    debt = torch.clamp(torch.where(inside, Dj - x, torch.zeros_like(x)), 0.0, 1.0)
    nxt = pick(torch.searchsorted(S, x, right=True))
    alias_heavy = torch.where(debt > 0.0, nxt, pos)

    q = torch.where(light, npi, (1.0 - debt).to(torch.float32))
    alias = torch.where(light, alias_light, alias_heavy)
    q = torch.where(has_both, q, torch.ones_like(q))
    alias = torch.where(has_both, alias, pos)
    return q.to(torch.float32), alias.to(torch.int32)


def ref_alias_sample_batched(q, alias, dist_id, xi) -> torch.Tensor:
    """Float32 scale, truncate, clamp of the fraction into [0, 1), one
    comparison, with 2-D gathers; sentinel lanes resolve to 0."""
    from repro_torch.core.alias import ALIAS_FRAC_MAX

    B, n = q.shape
    raw = dist_id.long()
    valid = raw >= 0
    did = torch.clamp(raw, 0, B - 1)
    scaled = xi * float(n)
    cell = torch.clamp(scaled.to(torch.int32), 0, n - 1)
    frac = torch.clamp(scaled - cell.to(torch.float32), 0.0, float(ALIAS_FRAC_MAX))
    cl = cell.long()
    out = torch.where(frac < q[did, cl], cell, alias[did, cl])
    return torch.where(valid, out, torch.zeros_like(out)).to(torch.int32)


# The tile of the JAX kernel's default and of csrc/sample_tiled.cu
# (RT_SAMPLE_TILE): the plain version is held to that kernel at this tile.
SAMPLE_TILE = 512


def ref_sample_rows(cdf_rows: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """(B, V) inclusive CDF rows, (B, k) uniforms -> (B, k) int32: the
    two-level tiled count of the JAX package's ``_sample_kernel``. Rows are
    padded to whole tiles with 2.0 (never ``<= xi``); ``t`` counts the tile
    cutpoints (each tile's last entry) ``<= xi``, clipped to the last tile;
    ``off`` counts that tile's entries ``<= xi``, clipped to ``tile - 1``;
    the index is ``min(t * tile + off, V - 1)``. On monotone rows this is
    ``searchsorted(row, xi, right)`` clipped to ``V - 1``; on rows with a
    dip only the count is defined, so this is written as the count."""
    B, V = cdf_rows.shape
    tile = SAMPLE_TILE
    nt = -(-V // tile)
    padded = torch.nn.functional.pad(cdf_rows.to(torch.float32), (0, nt * tile - V), value=2.0)
    tiles = padded.view(B, nt, tile)
    x = xi.to(torch.float32)
    t = (tiles[:, None, :, -1] <= x[:, :, None]).sum(-1)               # (B, k)
    t = torch.clamp(t, max=nt - 1)
    seg = tiles[torch.arange(B, device=x.device)[:, None], t]            # (B, k, tile)
    off = torch.clamp((seg <= x[:, :, None]).sum(-1), max=tile - 1)
    return torch.clamp(t * tile + off, max=V - 1).to(torch.int32)


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's dtype:
    the JAX package's ``ref_flash_attention``. Scores are materialized in
    float32 and divided by ``sqrt(hd)``; query ``i`` sees key ``j <= i`` when
    causal (masked to ``-1e30``); float32 softmax, float32 product with V,
    cast to q's dtype. Query head ``h`` reads key head ``h // (H / KV)``."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd).to(torch.float32)
    s = torch.einsum("bqhgk,bthk->bhgqt", qg, k.to(torch.float32)) / math.sqrt(hd)
    if causal:
        keep = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(keep, s, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqt,bthk->bqhgk", w, v.to(torch.float32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)
