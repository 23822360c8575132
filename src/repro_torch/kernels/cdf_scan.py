"""Row-wise CDF scan: softmax, normalized-weights and raw modes.

For a CUDA tensor this launches the hand-written kernel ``csrc/cdf_scan.cu``
in the regime :func:`scan_plan` picks from the row length ``V`` alone:

* ``V <= SHORT_MAX`` (the pool's chunk and carry rows): one warp a row;
* ``V <= CAPACITY`` (every vocabulary of the repo's configs, and the chunk
  rows of ``chunked_cumsum`` up to n = 2^24): one thread-block cluster of 1
  to 8 blocks a row, each block holding a contiguous slice in shared
  memory; the row is read once and written once, with one exchange between
  the blocks;
* longer rows: one block a row walking its tiles with a running carry (the
  row is read twice in the normalized modes). This is a dispatch on ``V``,
  not a fallback: a refused launch raises.

For a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.ref_cdf_scan`. The raw mode is the row scan
of :func:`repro_torch.core.cdf.chunked_cumsum` on the main path.

Bits: every sum runs in an order fixed by the plan (a lane's four elements
of a round in order, lanes by a shuffle-up scan, rounds by a running carry,
warps and cluster ranks in order), so a row's bits depend only on its
contents and ``V``: the same row alone, in any stack, and from run to run.
:func:`scan_in_kernel_order` is that order written in plain PyTorch. The
terms are scanned before they are normalized (each output is one IEEE
division of its prefix by the row's total), so a normalized row ends at
exactly 1.

Tolerance: the association is not the plain version's, so the kernel agrees
with it and with the JAX kernel to within ``SCAN_ATOL`` times the row total,
not bit for bit. For non-negative terms a sum errs by at most (additions on
a term's path) * 2^-24 * total. At V = 151936 (the Qwen vocabulary, the
decode path's rows: 8 blocks of 32 warps, 5 rounds a warp) a term passes at
most 3 additions along its lane's four elements, 5 shuffle levels to its
round's total, 5 along its warp's rounds, 30 along the warps' totals, 1 to
its block's total, 6 along the ranks' shares and 1 into the output: 51,
against 160 for the former one-block tile loop. The row total that divides
it has the same path, and softmax adds two roundings (the share's rescale
and the division). The worst case, (51 + 51 + 2) * 2^-24 = 6.2e-6, needs
every rounding to err the same way; rounding to nearest errs both ways, so
the error grows like the square root of a path's length, about
(7.1 + 7.1 + 2) * 2^-24 = 9.7e-7. The JAX suite holds its own kernel to its
reference with the same 3e-6; ``tests/test_torch_cuda.py`` holds the
kernel to the plain scan within ``SCAN_ATOL`` at every regime boundary, and
``chip_smoke.py``'s serve phase holds every card CDF row of the decode path
to it.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import _build
from .ref import ref_cdf_scan

SCAN_ATOL = 3e-6  # times the row total (1 for the normalized modes)

_MODE_SOFTMAX, _MODE_WEIGHTS, _MODE_RAW = 0, 1, 2

WARP, CLUSTER, BLOCK = 0, 1, 2  # regimes, as csrc/cdf_scan.cu numbers them
ROUND = 128             # elements a warp covers in one round: 4 a lane
SHORT_MAX = 1024        # rows up to this long: one warp a row, at most 8 rounds
WARP_ROWS = 4           # warps (rows) a block in the warp regime
CTA_MIN = 4096          # a cluster takes one block for each this many elements
CLUSTER_MAX = 8         # the portable cluster size
CTA_WARPS = 32          # most warps a cluster block
CTA_ROUNDS = 8          # most rounds a warp of a cluster block
CAPACITY = CLUSTER_MAX * CTA_WARPS * CTA_ROUNDS * ROUND  # 262144 elements
BLOCK_THREADS = 256


class ScanPlan(NamedTuple):
    regime: int    # WARP, CLUSTER or BLOCK
    cluster: int   # blocks a row (cluster size)
    slice: int     # elements a block (a warp in the warp regime) covers
    threads: int   # threads a block
    rounds: int    # rounds of ROUND elements a warp walks
    smem: int      # dynamic shared memory a block, bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def scan_plan(V: int) -> ScanPlan:
    """The kernel's launch plan for rows of length ``V`` (>= 1). A warp-regime
    row's last element lies in its last round. Cluster slices are whole
    multiples of 8 elements (one 16-byte bf16 load), every block of a
    cluster holds at least one element, and a block keeps its slice in
    shared memory: warps x rounds x ROUND floats, then one float a warp for
    each of two partials and two published values."""
    if V <= SHORT_MAX:
        rounds = _cdiv(V, ROUND)
        return ScanPlan(WARP, 1, rounds * ROUND, 32 * WARP_ROWS, rounds, 0)
    if V <= CAPACITY:
        cluster = min(CLUSTER_MAX, _cdiv(V, CTA_MIN))
        slice_ = _cdiv(_cdiv(V, cluster), 8) * 8
        warps = min(CTA_WARPS, _cdiv(slice_, 4 * ROUND))
        rounds = _cdiv(slice_, warps * ROUND)
        return ScanPlan(CLUSTER, cluster, slice_, 32 * warps, rounds,
                        4 * (warps * (rounds * ROUND + 2) + 2))
    return ScanPlan(BLOCK, 1, V, BLOCK_THREADS, 1, 0)


def scan_in_kernel_order(
    x: torch.Tensor, softmax: bool = True, normalize: bool = True
) -> torch.Tensor:
    """The warp and cluster regimes' arithmetic in plain PyTorch: the same
    float32 operations, in the kernel's order, on any device. The raw and
    weights modes give the kernel's bits; softmax's ``exp`` is PyTorch's.
    Rows over ``CAPACITY`` (the block regime) raise.

    A block scans exp(x - its max), x, or raw x: lanes take four elements
    in order, a shuffle-up scan joins the lanes of a round, a running carry
    the rounds of a warp, and the warps' totals in order give each warp's
    prefix. A block's total is its prefix at its last element. A cluster's
    ranks share total * exp(max - M) (softmax; M the row max) or their
    totals; the row sum adds the shares in rank order and a block's base
    the lower ranks' shares. The output is (base + scale * prefix) / sum,
    scale = exp(max - M) (softmax), (base + prefix) / sum (weights) or
    base + prefix (raw); one warp a row is the one-block case without the
    exchange: prefix / sum."""
    B, V = x.shape
    p = scan_plan(V)
    if p.regime == BLOCK:
        raise ValueError("scan_in_kernel_order: rows over CAPACITY are not modelled")
    ranks, S, R = p.cluster, p.slice, p.rounds
    W = 1 if p.regime == WARP else p.threads // 32
    span = W * R * ROUND  # elements a block (one warp in the warp regime) holds
    f32 = dict(dtype=torch.float32, device=x.device)

    def tiles(row):  # (B, ranks * S) -> (B, ranks, W, R, 32 lanes, 4)
        t = torch.zeros(B, ranks, span, **f32)
        t[:, :, :S] = row.reshape(B, ranks, S)
        return t.reshape(B, ranks, W, R, 32, 4)

    flat = torch.zeros(B, ranks * S, **f32)
    flat[:, :V] = x.to(torch.float32)
    valid = tiles(torch.arange(ranks * S, device=x.device).expand(B, -1) < V) > 0
    v = tiles(flat)
    lanes = torch.arange(32, device=x.device)
    if softmax:
        bmax = torch.where(valid, v, -math.inf).amax(dim=(2, 3, 4, 5))
        v = torch.where(valid, torch.exp(v - bmax[:, :, None, None, None, None]), 0.0)
    carry = torch.zeros(B, ranks, W, 1, **f32)  # each warp's running round carry
    for j in range(R):
        a = v[:, :, :, j]
        for i in range(1, 4):
            a[..., i] = a[..., i] + a[..., i - 1]
        incl = a[..., 3]
        for o in (1, 2, 4, 8, 16):
            up = torch.zeros_like(incl)
            up[..., o:] = incl[..., :-o]
            incl = torch.where(lanes >= o, incl + up, incl)
        excl = torch.zeros_like(incl)
        excl[..., 1:] = incl[..., :-1]
        v[:, :, :, j] = (carry + excl)[..., None] + a
        carry = carry + incl[..., 31:32]
    v = v.reshape(B, ranks, W, R * ROUND)
    n_last = [min(S, V - q * S) - 1 for q in range(ranks)]
    if p.regime == WARP:
        v = v.reshape(B, span)
        if normalize:
            v = v / v[:, n_last[0]:n_last[0] + 1]
        return v[:, :V]
    wpre = torch.zeros(B, ranks, W, **f32)
    for w in range(1, W):
        wpre[:, :, w] = wpre[:, :, w - 1] + carry[:, :, w - 1, 0]
    v = (wpre[..., None] + v).reshape(B, ranks, span)
    share = torch.stack([v[:, q, n_last[q]] for q in range(ranks)], dim=1)
    if softmax:
        scale = torch.exp(bmax - bmax.amax(dim=1, keepdim=True))
        share = share * scale
        v = v * scale[..., None]
    base = torch.zeros(B, ranks, **f32)
    for q in range(1, ranks):
        base[:, q] = base[:, q - 1] + share[:, q - 1]
    v = base[..., None] + v
    if normalize:
        v = v / (base[:, -1:] + share[:, -1:])[..., None]
    return v[:, :, :S].reshape(B, ranks * S)[:, :V]


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
        int(x.dtype == torch.bfloat16), *scan_plan(V), _build.stream_of(x))
    _build.check(err, "cdf_scan")
    cdf_scan.launches += 1
    return out


cdf_scan.launches = 0
