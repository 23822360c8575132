"""The port's hand-written CUDA kernels against their plain versions.

These tests need the card: each skips (inside a fixture) where there is
none. The file imports only the port, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Distances, descents and alias drains (single-stack, and grouped over many
size classes in one launch a method) are held bit-exact / elementwise;
scans to ``SCAN_ATOL`` times the row total against the plain version (the
kernel reassociates the sum), bit for bit against ``scan_in_kernel_order``
in the raw and weights modes, and a row's scan bits alone, in a stack and
from run to run; the alias build bit for bit on dyadic rows (exact partial sums in any
order) and to validity and mass conservation on every row; the per-row
inverse-CDF search elementwise on monotone and dipped rows; flash attention
to the JAX suite's tolerances (2e-5 in float32, 2e-2 in bfloat16) against
its plain version on the same card tensors (the two sum in other orders),
bitwise repeatable, with every instance on the tensor cores (HGMMA in the
library's SASS, bf16 and float32 alike); the descent of a forest of
2^30 + 1 intervals (the six-array body) against its plain version; the
multi-row forest and the 2-D map's drains (the one-class drain under
``set_sync_debug_mode("error")``) against their plain versions; the Mamba
scan's backward against autograd through an out-of-place scan, and a
train step of a reduced MoE and a reduced Jamba repeated bitwise under
deterministic algorithms; B10 on a rank's local query heads at a nonzero
head offset; and the LM's dist layer on a (1, 1) mesh over a single-rank
nccl group (DTensor parameters, hints, a placed decode cache): train steps,
the hinted flash forward and decode steps bit for bit the unsharded
model's; and the dry run's per-rank argument bytes (``launch.dryrun`` on
``meta`` tensors) equal to those of the same state on the card.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import build_forest, forest_from_cdf
from repro_torch.core.alias import build_alias_parallel, np_sample_alias_f32
from repro_torch.core.lds import qmc_point_np
from repro_torch.dist.local import whole
from repro_torch.kernels import groups, ref
from repro_torch.kernels.alias_build import alias_build_batched
from repro_torch.kernels.alias_sample import alias_sample_batched, alias_sample_grouped
from repro_torch.kernels.cdf_scan import (
    CAPACITY,
    SCAN_ATOL,
    cdf_scan,
    scan_in_kernel_order,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.forest_delta import forest_delta, forest_delta_update
from repro_torch.kernels.forest_sample import (
    forest_pack,
    forest_sample,
    forest_sample_batched,
    forest_sample_batched_streams,
    forest_sample_grouped,
)
from repro_torch.kernels.sample_tiled import sample_rows
from repro_torch.pool import BatchedForest, ForestPool, build_forest_batched
from repro_torch.serve.sampler import DeviceQmcStreams

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    return torch.device("cuda")


def test_forest_delta_bit_exact(cuda):
    data = torch.sort(torch.rand(100_003, generator=torch.Generator().manual_seed(0))).values
    for m in (1, 7, 4096, 1 << 17):
        got = forest_delta(data.to(cuda), m)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref.ref_forest_delta(data, m))


# Every regime boundary of scan_plan: warp rows (<= 1024), clusters of 1-8
# blocks up to CAPACITY, one block a row past it.
_SCAN_LENGTHS = (1, 31, 32, 33, 1024, 1025, 2048, 2049, 16384, 151936, 202048,
                 CAPACITY, CAPACITY + 1)
_SCAN_MODES = {"softmax": (True, True), "weights": (False, True), "raw": (False, False)}


def _scan_input(B, V, mode, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    if mode == "softmax":
        return torch.randn(B, V, generator=g, device=device) * 3
    return torch.rand(B, V, generator=g, device=device)


@pytest.mark.parametrize("mode", list(_SCAN_MODES))
def test_cdf_scan_matches_plain(cuda, mode):
    """The plain version runs on the CPU copy: its sequential cumsum errs
    least (the card's cumsum drifts past 3e-6 at 262144 elements)."""
    softmax, normalize = _SCAN_MODES[mode]
    for V in _SCAN_LENGTHS:
        for B in (1, 16, 64):
            x = _scan_input(B, V, mode, V + B, "cpu")
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                got = cdf_scan(xd.to(cuda), softmax=softmax, normalize=normalize).cpu()
                want = ref.ref_cdf_scan(xd, softmax=softmax, normalize=normalize)
                bad = (got - want).abs() > SCAN_ATOL * want[:, -1:].abs()
                assert not bool(bad.any()), (V, B, dtype)


@pytest.mark.parametrize("mode", list(_SCAN_MODES))
def test_cdf_scan_is_its_plan_order(cuda, mode):
    """The kernel adds and divides in the order scan_in_kernel_order writes
    down: bit for bit in the raw and weights modes; softmax's exp is
    PyTorch's there, so it is held to SCAN_ATOL."""
    softmax, normalize = _SCAN_MODES[mode]
    for V in _SCAN_LENGTHS[:-1]:
        x = _scan_input(16, V, mode, V, cuda)
        for dtype in (torch.float32, torch.bfloat16):
            got = cdf_scan(x.to(dtype), softmax=softmax, normalize=normalize)
            want = scan_in_kernel_order(x.to(dtype), softmax=softmax, normalize=normalize)
            if softmax:
                assert bool(((got - want).abs() <= SCAN_ATOL).all()), (V, dtype)
            else:
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (V, dtype)


@pytest.mark.parametrize("mode", list(_SCAN_MODES))
def test_cdf_scan_row_bits_independent_of_stack(cuda, mode):
    """A row alone, in a stack of 7 and in a stack of 64 gets the same bits,
    and so does a second run: no sum depends on the other rows or on the
    order blocks run in."""
    softmax, normalize = _SCAN_MODES[mode]
    for V in _SCAN_LENGTHS:
        for dtype in (torch.float32, torch.bfloat16):
            x = _scan_input(64, V, mode, 3 * V, cuda).to(dtype)
            stack64 = cdf_scan(x, softmax=softmax, normalize=normalize).view(torch.int32)
            again = cdf_scan(x, softmax=softmax, normalize=normalize).view(torch.int32)
            stack7 = cdf_scan(x[30:37], softmax=softmax, normalize=normalize).view(torch.int32)
            alone = cdf_scan(x[33:34], softmax=softmax, normalize=normalize).view(torch.int32)
            assert torch.equal(stack64, again), (V, dtype)
            assert torch.equal(stack7, stack64[30:37]), (V, dtype)
            assert torch.equal(alone, stack64[33:34]), (V, dtype)


def _tied(hot, hot2):
    w = np.zeros(300, np.float32)
    w[hot] = 1.2
    if hot2 is not None:
        w[hot2] = 0.8
    return w


_FORESTS = {
    "power8": (np.random.default_rng(0).random(5000) ** 8 + 1e-9, 1024),
    "power20": (np.random.default_rng(1).random(5000) ** 20 + 1e-9, 64),
    "spike_at_zero": (_tied(150, None), 16),
    "interior_ties": (_tied(0, 299), 16),
    "dyadic_chain": (np.asarray([2.0 ** -(i + 1) for i in range(24)] + [2.0 ** -24],
                                np.float32), 1),
}


@pytest.mark.parametrize("name", list(_FORESTS))
def test_forest_sample_matches_plain(cuda, name):
    w, m = _FORESTS[name]
    f = build_forest(w, m, device="cpu")
    fd = type(f)(*(t.to(cuda) for t in f))
    xi = torch.rand(100_000, generator=torch.Generator().manual_seed(2))
    for fb in (True, False):
        got = forest_sample(*fd[:4], fd.cell_first, fd.fallback, xi.to(cuda),
                            use_fallback=fb).cpu()
        want = forest_sample(*f[:4], f.cell_first, f.fallback, xi, use_fallback=fb)
        assert torch.equal(got, want)


def _edge_uniforms(f, B, seed):
    """B uniforms: every interval's lower bound (as many as fit), 0,
    1 - 2^-24, the lowest uniform of the last guide cell, and random ones."""
    m = f.table.shape[0]
    edges = torch.cat([f.cdf[:-1], torch.tensor([0.0, 1.0 - 2.0 ** -24, (m - 1) / m])])
    rnd = torch.rand(B, generator=torch.Generator().manual_seed(seed))
    k = min(B, edges.numel())
    pick = torch.randperm(edges.numel(), generator=torch.Generator().manual_seed(seed))[:k]
    rnd[:k] = edges[pick]
    rnd[-1] = 1.0 - 2.0 ** -24
    return rnd


@pytest.mark.parametrize("B", [1, 31, 33, 257, 4097, 100_000])
@pytest.mark.parametrize("name", list(_FORESTS))
def test_forest_sample_lane_tails_and_edges(cuda, name, B):
    """Lane counts around a warp and a block, uniforms at the CDF's values,
    at 0, at 1 - 2^-24 and in the last guide cell, with the pack given and
    made on the way, and with xi at an odd offset."""
    w, m = _FORESTS[name]
    f = build_forest(w, m, device="cpu")
    fd = type(f)(*(t.to(cuda) for t in f))
    pk = forest_pack(fd.cdf, fd.table, fd.left, fd.right, fd.fallback)
    xi = _edge_uniforms(f, B + 1, B)
    for fb in (True, False):
        want = forest_sample(*f[:4], f.cell_first, f.fallback, xi, use_fallback=fb)
        for packed in (pk, None):
            got = forest_sample(*fd[:4], fd.cell_first, fd.fallback, xi.to(cuda),
                                use_fallback=fb, packed=packed)
            assert torch.equal(got.cpu(), want)
        odd = forest_sample(*fd[:4], fd.cell_first, fd.fallback, xi.to(cuda)[1:],
                            use_fallback=fb, packed=pk)
        assert torch.equal(odd.cpu(), want[1:])


@pytest.mark.parametrize("name", list(_FORESTS))
def test_forest_pack_matches_plain(cuda, name):
    w, m = _FORESTS[name]
    f = build_forest(w, m, device="cpu")
    fd = type(f)(*(t.to(cuda) for t in f))
    got = forest_pack(fd.cdf, fd.table, fd.left, fd.right, fd.fallback)
    want = ref.ref_forest_pack(f.cdf, f.table, f.left, f.right, f.fallback)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("how", ["update_weights", "from_state"])
def test_forest_sampler_draws_from_its_current_forest(cuda, how):
    """The stale-pack guard: after an update or a restore, a sampler draws
    what a freshly built sampler over the same weights draws."""
    from repro_torch.core import forest_to_numpy
    from repro_torch.serve.sampler import ForestSampler

    rng = np.random.default_rng(6)
    w0, w1 = rng.random(50_000) ** 4 + 1e-6, rng.random(50_000) ** 12 + 1e-6
    fresh = ForestSampler(w1, m=8192, n_slots=4096, device=cuda)
    if how == "update_weights":
        s = ForestSampler(w0, m=8192, n_slots=4096, device=cuda)
        s.sample(np.arange(4096))
        s.update_weights(w1)
        s.streams = type(fresh.streams).restore(fresh.streams.snapshot())
    else:
        s = ForestSampler.from_state(forest_to_numpy(fresh.forest),
                                     fresh.streams.snapshot(), device=cuda)
    for _ in range(3):
        slots = rng.integers(0, 4096, 20_000)
        np.testing.assert_array_equal(s.sample(slots), fresh.sample(slots))


def test_build_forest_on_card_equals_plain_build(cuda):
    """Same CDF bits in, same six arrays out, on either device."""
    w = np.random.default_rng(3).random(70_000) ** 4
    fd = build_forest(w, 4096, device=cuda)
    f = forest_from_cdf(fd.cdf.cpu(), 4096, device="cpu")
    for a, b in zip(fd, f):
        assert torch.equal(a.cpu(), b)


# ------------------------------------------------------------- pool kernels


def test_forest_delta_update_bit_exact(cuda):
    g = torch.Generator().manual_seed(4)
    old = torch.sort(torch.rand(70_001, generator=g)).values
    new = old.clone()
    new[::7] = torch.nextafter(new[::7], torch.tensor(2.0))
    new = torch.sort(new).values
    for m in (1, 4096, 1 << 16):
        d, ch = forest_delta_update(old.to(cuda), new.to(cuda), m)
        wd, wch = ref.ref_forest_delta_update(old, new, m)
        assert torch.equal(d.cpu(), wd) and torch.equal(ch.cpu(), wch)
        assert torch.equal(d.cpu(), ref.ref_forest_delta(new, m))


def _stack(n, m, B, seed):
    """B stacked forests of width n (one tied row with fallback cells)."""
    rng = np.random.default_rng(seed)
    W = (rng.random((B, n)) ** 6 + 1e-9).astype(np.float32)
    W[-1] = 0.0
    W[-1, n // 2] = 1.0
    return build_forest_batched(W, m, device="cpu")


@pytest.mark.parametrize("B,n,m", [(1, 8, 8), (5, 64, 32), (3, 300, 300), (6, 4096, 4096)])
def test_forest_sample_batched_matches_plain(cuda, B, n, m):
    f = _stack(n, m, B, B * n)
    fd = BatchedForest(*(t.to(cuda) for t in f))
    assert bool(f.fallback.any())
    g = torch.Generator().manual_seed(5)
    Q = 50_000
    did = torch.randint(-1, B + 1, (Q,), generator=g, dtype=torch.int32)
    xi = torch.rand(Q, generator=g)
    ctr = torch.randint(-2**31, 2**31, (Q,), generator=g, dtype=torch.int32)  # uint32 bits
    off = torch.randint(0, 2**24, (Q,), generator=g, dtype=torch.int32)
    want = forest_sample_batched(*f, did, xi)
    wi, wx = forest_sample_batched_streams(*f, did, ctr, off)
    for co in (True, False):
        got = forest_sample_batched(*fd, did.to(cuda), xi.to(cuda), coalesce=co)
        assert torch.equal(got.cpu(), want), co
        gi, gx = forest_sample_batched_streams(*fd, did.to(cuda), ctr.to(cuda),
                                               off.to(cuda), coalesce=co)
        assert torch.equal(gi.cpu(), wi), co
        assert torch.equal(gx.cpu().view(torch.int32), wx.view(torch.int32)), co
        want_pts = qmc_point_np(ctr.numpy().view(np.uint32), off.numpy().view(np.uint32))
        assert np.array_equal(gx.cpu().numpy().view(np.uint32), want_pts.view(np.uint32))


def _dyadic_rows(n, B, seed):
    """Integer weights in [1, 8) with a power-of-two total: n*p and every
    partial sum of the tapes is exact in float32, in any order."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(B):
        c = rng.integers(1, 8, n)
        extra = (1 << int(np.ceil(np.log2(c.sum())))) - c.sum()
        np.add.at(c, rng.integers(0, n, extra), 1)
        rows.append(c)
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("n", [4, 32, 1000, 4096, 4097, 65536])
def test_alias_build_matches_plain(cuda, n):
    """Bit-exact on dyadic rows (exact partial sums in any order); valid
    and mass-conserving on every row, including padded zero cells."""
    B = 8 if n <= 4096 else 3
    dy = _dyadic_rows(n, B, n)
    q, a = alias_build_batched(torch.from_numpy(dy).to(cuda))
    wq, wa = alias_build_batched(torch.from_numpy(dy))
    assert torch.equal(q.cpu(), wq) and torch.equal(a.cpu(), wa)
    for b in range(B):
        t = build_alias_parallel(dy[b].astype(np.float64), device="cpu")
        assert torch.equal(q[b].cpu(), t.q) and torch.equal(a[b].cpu(), t.alias)
    rng = np.random.default_rng(n + 1)
    W = (rng.random((B, n)) ** 6 + 1e-9).astype(np.float32)
    W[0, n // 2:] = 0.0  # padding
    W[1] = 1.0           # exactly uniform: identity
    q, a = (x.cpu().numpy() for x in alias_build_batched(torch.from_numpy(W).to(cuda)))
    assert np.all((q >= 0) & (q <= 1)) and np.all((a >= 0) & (a < n))
    assert np.array_equal(a[1], np.arange(n)) and np.all(q[1] == 1.0)
    for b in range(B):
        npi = W[b].astype(np.float64) / W[b].sum(dtype=np.float64) * n
        mass = q[b].astype(np.float64).copy()
        np.add.at(mass, a[b], 1.0 - q[b].astype(np.float64))
        # n*p are float32 and sum to n only to a few ulps of n; the cells at
        # the tapes' ends absorb that residue
        np.testing.assert_allclose(mass, npi, rtol=2e-4, atol=2e-4 + n * 2.0**-22)
    assert np.all(q[0, n // 2:] == 0.0)
    assert not np.any(np.isin(a[0], np.arange(n // 2, n)) & (q[0] < 1.0))


def _check_alias_tables(W, q, a):
    """Valid tables that conserve each cell's mass n*p to the tolerance of
    ROADMAP C6, with zero (padded) cells at q == 0 and never an alias
    target of a cell that can take it."""
    B, n = W.shape
    q, a = q.cpu().numpy(), a.cpu().numpy()
    assert np.all((q >= 0) & (q <= 1)) and np.all((a >= 0) & (a < n))
    for b in range(B):
        npi = W[b].astype(np.float64) / W[b].sum(dtype=np.float64) * n
        mass = q[b].astype(np.float64).copy()
        np.add.at(mass, a[b], 1.0 - q[b].astype(np.float64))
        np.testing.assert_allclose(mass, npi, rtol=2e-4, atol=2e-4 + n * 2.0**-22)
        zero = W[b] == 0
        assert np.all(q[b][zero] == 0.0)
        assert not np.any(zero[a[b]] & (q[b] < 1.0))


def _check_dyadic_exact(dy, cuda):
    """A dyadic stack on the card: bit-equal to the plain version and to
    the host build_alias_parallel, row by row."""
    q, a = alias_build_batched(torch.from_numpy(dy).to(cuda))
    wq, wa = alias_build_batched(torch.from_numpy(dy))
    assert torch.equal(q.cpu(), wq) and torch.equal(a.cpu(), wa)
    for b in range(dy.shape[0]):
        t = build_alias_parallel(dy[b].astype(np.float64), device="cpu")
        assert torch.equal(q[b].cpu(), t.q) and torch.equal(a[b].cpu(), t.alias)


@pytest.mark.parametrize("n", [300, 1000, 4096, 65536])
def test_alias_build_row_alone_equals_row_in_stack(cuda, n):
    """A row's table depends on the row and n alone: built alone (an
    update) it is bit-equal to the same row inside a 7-row stack (an
    admission wave), off the dyadic grid too."""
    rng = np.random.default_rng(n + 7)
    W = (rng.random((7, n)) ** 6 + 1e-9).astype(np.float32)
    W[3, n // 3:] = 0.0
    q, a = alias_build_batched(torch.from_numpy(W).to(cuda))
    for b in range(7):
        qb, ab = alias_build_batched(torch.from_numpy(W[b:b + 1]).to(cuda))
        assert torch.equal(qb[0], q[b]) and torch.equal(ab[0], a[b]), b


@pytest.mark.parametrize("n", [2048, 65536])
def test_alias_build_is_bitwise_repeatable(cuda, n):
    rng = np.random.default_rng(n + 8)
    W = torch.from_numpy((rng.random((5, n)) ** 6 + 1e-9).astype(np.float32)).to(cuda)
    first = alias_build_batched(W)
    for _ in range(3):
        again = alias_build_batched(W)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


@pytest.mark.parametrize("n", [512, 513, 2047, 2048, 2049, 16384, 65537])
def test_alias_build_tile_edges(cuda, n):
    """Rows at and around the tile of 2048 cells, a pool class of 8 tiles,
    a row one cell past the largest class, and the one-tile body's switch
    from one cell at a time to interleaved searches (two cells a thread):
    bit-exact on dyadic rows, valid and mass-conserving on others, padded
    or not."""
    _check_dyadic_exact(_dyadic_rows(n, 3, n), cuda)
    rng = np.random.default_rng(n + 9)
    W = (rng.random((4, n)) ** 6 + 1e-9).astype(np.float32)
    W[0, n // 2 + 1:] = 0.0
    W[1, :n // 5] = 0.0
    q, a = alias_build_batched(torch.from_numpy(W).to(cuda))
    _check_alias_tables(W, q, a)


def _one_heavy_rows(n):
    """Dyadic rows (total 2n, lights at n*p = 1/2): (a) three heavies, two
    of them small and one holding half the mass, so the heavies' queries
    of the first tile reach across the row; (b) one heavy, all other
    cells light."""
    span = np.ones(n, np.float32)
    span[0] = span[n // 13] = 3.0
    span[1] = 2 * n - (n - 3) - 6
    one = np.ones(n, np.float32)
    one[n // 2] = n + 1
    return np.stack([span, one])


@pytest.mark.parametrize("n", [4096, 65536])
def test_alias_build_window_spans_row(cuda, n):
    """Rows whose search windows span the row (longer than what shared
    memory stages): bit-exact on the dyadic rows; valid and
    mass-conserving on the same shapes off the grid."""
    dy = _one_heavy_rows(n)
    assert all(r.sum() == 2 * n for r in dy)
    _check_dyadic_exact(dy, cuda)
    W = np.full((2, n), 1e-3, np.float32)
    W[0, 0], W[0, 1], W[0, n // 13] = 2e-3, 60.0, 3e-3
    W[1, n // 2] = 50.0
    q, a = alias_build_batched(torch.from_numpy(W).to(cuda))
    _check_alias_tables(W, q, a)
    assert np.all(a[1].cpu().numpy() == n // 2)


def test_alias_build_dyadic_65536_bit_exact(cuda):
    _check_dyadic_exact(_dyadic_rows(1 << 16, 4, 16), cuda)


def test_alias_build_conserves_mass_at_65536(cuda):
    """The pool's rows at its largest class, padded to it from every real
    size range of the class, at C6's tolerance."""
    n = 1 << 16
    rng = np.random.default_rng(17)
    W = (rng.random((8, n)) ** 6 + 1e-9).astype(np.float32)
    for b, real in enumerate((n, n - 1, 60000, 50000, 40000, 32769, 32769, n // 2 + 3)):
        W[b, real:] = 0.0
    q, a = alias_build_batched(torch.from_numpy(W).to(cuda))
    _check_alias_tables(W, q, a)


def test_alias_build_padded_cells_unreachable(cuda):
    """Zero-padded cells of multi-tile rows: q == 0, never an alias target,
    and no uniform reaches them through the drain's float32 rule."""
    rng = np.random.default_rng(18)
    n = 1 << 14
    W = np.zeros((3, n), np.float32)
    reals = (n // 2 + 1, 3000, 2049)
    for b, real in enumerate(reals):
        W[b, :real] = rng.random(real) ** 6 + 1e-9
    q, a = alias_build_batched(torch.from_numpy(W).to(cuda))
    _check_alias_tables(W, q, a)
    xi = rng.random(200_000).astype(np.float32)
    for b, real in enumerate(reals):
        assert np.all(np_sample_alias_f32(q[b].cpu().numpy(), a[b].cpu().numpy(), xi) < real)


@pytest.mark.parametrize("n", [8, 300, 65536])
def test_alias_sample_matches_f32_oracle(cuda, n):
    rng = np.random.default_rng(n)
    B = 4
    W = (rng.random((B, n)) ** 4 + 1e-6).astype(np.float32)
    q, a = alias_build_batched(torch.from_numpy(W))
    Q = 100_000
    did = rng.integers(-1, B, Q).astype(np.int32)
    xi = rng.random(Q).astype(np.float32)
    xi[:3] = [0.0, 1.0, np.nextafter(np.float32(1), np.float32(0))]
    qn, an = q.numpy(), a.numpy()
    want = np.zeros(Q, np.int32)
    for b in range(B):
        sel = did == b
        want[sel] = np_sample_alias_f32(qn[b], an[b], xi[sel])
    for co in (True, False):
        got = alias_sample_batched(q.to(cuda), a.to(cuda), torch.from_numpy(did).to(cuda),
                                   torch.from_numpy(xi).to(cuda), coalesce=co)
        assert np.array_equal(got.cpu().numpy(), want), co


def test_pool_on_card_equals_pool_on_cpu(cuda):
    """A pool admitted on the card: its forest rows equal the plain CPU
    build from the same CDF bits, and the same pool restored on the CPU
    drains equal to it (plain versions against the kernels)."""
    rng = np.random.default_rng(9)
    tenants = [rng.random(n) ** 3 + 1e-4 for n in (5, 40, 300, 1000, 6, 64, 500)]
    methods = ["forest"] * 4 + ["alias"] * 3
    card = ForestPool(device=cuda)
    hs = card.insert_many(tenants, method=methods)
    for h in hs[:4]:
        fd = card.forest_row(h)
        fc = forest_from_cdf(fd.cdf.cpu(), fd.m, device="cpu")
        for x, y in zip(fd, fc):
            assert torch.equal(x.cpu(), y)
    cpu = ForestPool.restore(card.snapshot(), device="cpu")
    lanes = [hs[i] for i in rng.integers(0, len(tenants), 20_000)]
    xi = rng.random(len(lanes)).astype(np.float32)
    assert np.array_equal(card.sample(lanes, xi), cpu.sample(lanes, xi))
    streams = [DeviceQmcStreams(64, seed=2, device=d) for d in (cuda, "cpu")]
    slots = rng.integers(0, 64, len(lanes))
    a, b = (p.sample_streams(lanes, slots, s) for p, s in zip((card, cpu), streams))
    assert np.array_equal(a, b)
    assert torch.equal(streams[0].counters.cpu(), streams[1].counters)


def _mixed_drain(G, Q, seed):
    """A drain's lanes over 2G groups: forest groups 0..G-1 and alias groups
    G..2G-1 cycling through classes of 8..4096 cells (three rows each, the
    last forest row tied, with flagged cells); group 5 gets no lane; rows
    -1 (sentinel) .. 3 (clamped to the last row); clip bounds below each
    class's size."""
    sizes = (8, 64, 512, 4096)
    forests = [_stack(n, n, 3, n) for n in sizes]
    assert all(bool(f.fallback.any()) for f in forests)
    rng = np.random.default_rng(seed)
    tables = [alias_build_batched(torch.from_numpy(
        (rng.random((3, n)) ** 4 + 1e-6).astype(np.float32))) for n in sizes]
    gid = rng.integers(0, 2 * G, Q).astype(np.int32)
    gid[gid == 5] = 6
    size = np.asarray(sizes)[gid % G % len(sizes)]
    lanes = (torch.from_numpy(gid),
             torch.from_numpy(rng.integers(-1, 4, Q).astype(np.int32)),
             torch.from_numpy((rng.random(Q) * size).astype(np.int32)))
    xi = torch.from_numpy(rng.random(Q).astype(np.float32))
    xi[:3] = torch.tensor([0.0, 1.0, float(np.nextafter(np.float32(1), np.float32(0)))])
    ctr = torch.from_numpy(rng.integers(-2**31, 2**31, Q).astype(np.int32))
    off = torch.from_numpy(rng.integers(0, 2**24, Q).astype(np.int32))
    return ([forests[g % len(sizes)] for g in range(G)],
            [tables[g % len(sizes)] for g in range(G)], lanes, xi, ctr, off)


def _grouped_drain(forests, tables, lanes, xi, ctr, off, dev, coalesce):
    """One B5 (B6 when ``ctr`` is given) and one B8 launch set over the
    drain's lanes; returns the drain's results and the stream points."""
    G = len(forests)
    mv = lambda ts: tuple(t.to(dev) for t in ts)  # noqa: E731
    lanes = mv(lanes)
    out = torch.full((lanes[0].shape[0],), -7, dtype=torch.int32, device=dev)
    pts = torch.full(out.shape, -1.0, device=dev)
    kw = (dict(xi=xi.to(dev)) if ctr is None else
          dict(counter=ctr.to(dev), offset_bits=off.to(dev), xi_out=pts))
    forest_sample_grouped([mv(f) for f in forests], *lanes, out, coalesce=coalesce, **kw)
    alias_sample_grouped([mv(t) for t in tables], *lanes, out, xi.to(dev), g0=G,
                         coalesce=coalesce)
    return out.cpu(), pts.cpu()


@pytest.mark.parametrize("cap", [3, 32])
def test_grouped_drain_kernels_match_plain(cuda, cap, monkeypatch):
    """B5, B6 and B8 over 40 + 40 groups of four classes (8..4096 cells)
    with tied rows, sentinel lanes and an empty group, in one launch per
    method and in 14 (``GROUP_CAP`` 3), coalesced or not: elementwise
    equal to the grouped plain versions, B6's points bit-equal to
    ``qmc_point_np``, every lane written once."""
    monkeypatch.setattr(groups, "GROUP_CAP", cap)
    G = 40
    forests, tables, lanes, xi, ctr, off = _mixed_drain(G, 60_000, cap)
    launches = -(-G // cap)
    for stream in (False, True):
        c = (ctr, off) if stream else (None, None)
        want, wpts = _grouped_drain(forests, tables, lanes, xi, *c, "cpu", True)
        assert bool((want != -7).all())
        for co in (True, False):
            body = forest_sample_batched_streams if stream else forest_sample_batched
            b0, a0 = body.launches, alias_sample_batched.launches
            got, pts = _grouped_drain(forests, tables, lanes, xi, *c, cuda, co)
            torch.cuda.synchronize()
            assert (body.launches - b0, alias_sample_batched.launches - a0) == (
                launches, launches)
            assert torch.equal(got, want), (stream, co)
            if stream:
                fl = lanes[0] < G
                assert torch.equal(pts.view(torch.int32), wpts.view(torch.int32))
                want_pts = qmc_point_np(ctr.numpy().view(np.uint32)[fl.numpy()],
                                        off.numpy().view(np.uint32)[fl.numpy()])
                assert np.array_equal(pts[fl].numpy().view(np.uint32), want_pts.view(np.uint32))


def test_stream_drain_launches_each_method_once(cuda):
    """A stream drain over twelve classes of both methods adds exactly one
    launch to B6 and one to B8, a host-uniform drain one to B5 and one to
    B8; both equal the same pool's drains on the CPU."""
    rng = np.random.default_rng(17)
    sizes = [int(n) for n in rng.integers(5, 3000, 48)]
    tenants = [rng.random(n) ** 3 + 1e-4 for n in sizes]
    methods = ["forest" if i % 2 == 0 else "alias" for i in range(len(sizes))]
    card = ForestPool(device=cuda)
    hs = card.insert_many(tenants, method=methods)
    assert len(card.classes) >= 4 and len(card.alias_classes) >= 4
    cpu = ForestPool.restore(card.snapshot(), device="cpu")
    lanes = [hs[i] for i in rng.integers(0, len(hs), 30_001)]
    streams = [DeviceQmcStreams(256, seed=3, device=d) for d in (cuda, "cpu")]
    slots = rng.integers(0, 256, len(lanes))
    bodies = (forest_sample_batched, forest_sample_batched_streams, alias_sample_batched)
    before = [b.launches for b in bodies]
    got = card.sample_streams(lanes, slots, streams[0])
    assert [b.launches - c for b, c in zip(bodies, before)] == [0, 1, 1]
    assert np.array_equal(got, cpu.sample_streams(lanes, slots, streams[1]))
    xi = rng.random(len(lanes)).astype(np.float32)
    before = [b.launches for b in bodies]
    got = card.sample(lanes, xi)
    assert [b.launches - c for b, c in zip(bodies, before)] == [1, 0, 1]
    assert np.array_equal(got, cpu.sample(lanes, xi))


@pytest.mark.parametrize("n", [300, 100_000, 600_000])
def test_pool_update_equals_fresh_wave(cuda, n):
    """A forest tenant re-weighted by update_weights gets the CDF row bits
    that the same weights get when admitted in a fresh stacked wave beside
    other tenants of its size class (one chunk-row scan alone against one
    in a stack: warp rows at n = 300, one-block and four-block clusters at
    the 2^17 and 2^20 classes)."""
    rng = np.random.default_rng(n)
    w0, w1, *others = (rng.random(n) ** 4 + 1e-6 for _ in range(6))
    pool = ForestPool(device=cuda)
    h = pool.insert_many([others[0], w0, others[1]])[1]
    pool.update_weights(h, w1)
    fresh = ForestPool(device=cuda)
    g = fresh.insert_many([others[2], others[3], w1])[2]
    got, want = pool.forest_row(h).cdf, fresh.forest_row(g).cdf
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _cdf_rows(B, V, seed, cuda):
    g = torch.Generator().manual_seed(seed)
    return cdf_scan((torch.randn(B, V, generator=g) * 3).to(cuda))


@pytest.mark.parametrize("B,V,k", [
    (1, 1, 1), (3, 511, 4), (16, 151936, 1), (4, 50257, 3), (256, 1024, 2),
    (2, 151935, 3), (3, 50257, 8),            # row bases off the 16-byte grid
    (4, 7, 2), (5, 31, 8),                    # V < 32: one partial tile
    (2, 1023, 4), (2, 1025, 4), (3, 2047, 2), (3, 2049, 8), (2, 1024, 3),  # 512 j -+ 1
    (256, 151936, 1), (256, 1024, 8),         # four warps a block
    (1, 300000, 2)])                          # level 1 in two rounds of loads (586 tiles)
def test_sample_rows_matches_plain(cuda, B, V, k):
    cdf = _cdf_rows(B, V, V, cuda)
    g = torch.Generator().manual_seed(k)
    xi = torch.rand(B, k, generator=g).to(cuda)
    xi[0, 0] = 0.0
    if k > 1:
        xi[:, 1] = cdf[:, -1]                          # the last entry
        xi[-1, -1] = float(np.float32(1.0 - 2.0 ** -24))
    before = sample_rows.launches
    got = sample_rows(cdf, xi)
    torch.cuda.synchronize()
    assert sample_rows.launches == before + 1
    assert torch.equal(got.cpu(), ref.ref_sample_rows(cdf.cpu(), xi.cpu()))
    # on these monotone rows: searchsorted (right), clipped
    want = torch.clamp(torch.searchsorted(cdf, xi, right=True), max=V - 1)
    assert torch.equal(got.long(), want)


def test_sample_rows_misaligned_row_base(cuda):
    """V % 4 == 0 but the rows start 4 bytes past the 16-byte grid (a view
    one float into its buffer): the scalar tile path, equal to the plain
    version."""
    B, V = 3, 151936
    rows = _cdf_rows(B, V, 3, cuda)
    buf = torch.empty(B * V + 1, device=cuda)
    view = buf[1:].view(B, V)
    view.copy_(rows)
    assert view.data_ptr() % 16 and view.is_contiguous()
    xi = torch.rand(B, 5, generator=torch.Generator().manual_seed(4)).to(cuda)
    assert torch.equal(sample_rows(view, xi).cpu(), ref.ref_sample_rows(rows.cpu(), xi.cpu()))


def test_sample_rows_matches_plain_on_dipped_rows(cuda):
    """Rows with one-ulp dips at tile cutpoints and noisy rows: only the
    count is defined there, and kernel and plain version count alike."""
    rng = np.random.default_rng(7)
    V = 5000
    base = np.cumsum(rng.random(V)).astype(np.float32)
    base /= base[-1]
    dip = base.copy()
    for j in range(511, V - 1, 512):
        dip[j] = np.nextafter(dip[j + 1], np.float32(2.0))
    noisy = (base + rng.normal(0.0, 1e-3, V)).astype(np.float32)
    rows = torch.tensor(np.stack([dip, noisy, base[::-1].copy()]))
    xi = torch.tensor(np.stack([r[rng.integers(0, V, 8)] for r in rows.numpy()]))
    got = sample_rows(rows.to(cuda), xi.to(cuda))
    assert torch.equal(got.cpu(), ref.ref_sample_rows(rows, xi))


def test_engine_steps_on_card(cuda):
    """A reduced Qwen1.5 engine on the card: every sampler call's tokens
    equal the plain inverse on the same card CDF rows, and those rows are
    within SCAN_ATOL of the plain scan (chip_smoke's recorder and check)."""
    import dataclasses
    import importlib.util

    import repro_torch.configs as C
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine, TokenSampler

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(C.get_reduced("qwen1_5_0_5b"), dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    eng = ServeEngine(model, cfg, n_slots=4, max_seq=64,
                      sampler=TokenSampler(n_slots=4, device=cuda), device=cuda)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 6), max_new=3) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    before = sample_rows.launches
    with smoke.SamplerCalls() as rec:
        eng.run(max_steps=50)
    torch.cuda.synchronize()
    assert all(r.done and len(r.out) == 3 for r in reqs)
    assert sample_rows.launches - before == len(rec.calls) > 0
    for c in rec.calls:
        smoke.check_sampler_call(c)


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(B, Sq, Sk, H, KV, hd, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Sq, H, hd), generator=g)
    k = torch.randn((B, Sk, KV, hd), generator=g)
    v = torch.randn((B, Sk, KV, hd), generator=g)
    return [t.to(device=device, dtype=dtype) for t in (q, k, v)]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [
    (1, 128, 128, 4, 4, 32), (2, 96, 96, 4, 2, 64), (1, 256, 256, 8, 2, 32),
    (2, 64, 64, 2, 1, 128), (1, 100, 100, 2, 2, 32), (1, 1000, 1000, 4, 2, 64),
    (2, 37, 200, 4, 4, 64), (1, 5, 20, 2, 1, 32), (1, 1024, 1024, 32, 8, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(cuda, B, Sq, Sk, H, KV, hd, causal, dtype):
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, dtype, Sq + H + hd, cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ref.ref_flash_attention(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KV", [(1, 1024, 64, 8), (2, 1000, 8, 2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_hd112_matches_plain(cuda, B, S, H, KV, causal, dtype):
    """Head dim 112 (Kimi K2: 7168 / 64 heads), which runs the hd-128 tile
    over zero-filled columns: Kimi's heads at 1024 tokens and a ragged GQA
    case, scaled by 1/sqrt(112), against the plain version; no column past
    112 is written."""
    q, k, v = _qkv(B, S, S, H, KV, 112, dtype, S + H, cuda)
    buf = torch.full((B, S, H, 128), 7.0, dtype=dtype, device=cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ref.ref_flash_attention(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    assert got.shape == q.shape and got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol)
    # an output view whose rows are 128 wide: the 16 columns past 112 stay as they were
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import _strides

    o = buf[..., :112]
    err = _build.library().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, S, H, KV, 112,
        *_strides(q), *_strides(k), *_strides(v), *_strides(o), int(causal),
        int(dtype == torch.bfloat16), 112 ** -0.5, _build.stream_of(q))
    _build.check(err, "flash_attention")
    torch.cuda.synchronize()
    assert torch.equal(o, got)
    assert bool((buf[..., 112:] == 7.0).all())


def test_flash_attention_reads_strided_heads(cuda):
    """q/k/v as transposed views of (B, heads, S, hd) tensors: read through
    their strides, with the result of the contiguous inputs."""
    q, k, v = _qkv(2, 130, 130, 4, 2, 64, torch.bfloat16, 0, cuda)
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert not qt.is_contiguous()
    got = flash_attention(qt, kt, vt, causal=True)
    assert torch.equal(got, flash_attention(q, k, v, causal=True))
    with pytest.raises(NotImplementedError, match="B10"):
        flash_attention(q.requires_grad_(), k, v)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [
    (1, 129, 129, 4, 2, 64),      # Sq one row past a 128-row query tile
    (2, 255, 255, 4, 4, 128),     # Sq one row short of two tiles
    (1, 100, 300, 4, 2, 64),      # Sq < Sk
    (1, 200, 50, 4, 4, 32),       # Sk under one 128-key tile, Sq > Sk
    (1, 50, 50, 2, 2, 64),        # both under one tile
    (1, 384, 384, 16, 4, 128),    # GQA, G = 4
    (1, 300, 300, 16, 2, 64),     # GQA, G = 8
    (1, 257, 257, 8, 1, 32),      # G = 8 at hd 32, ragged
    (4, 512, 512, 16, 16, 64),    # 256 blocks, more than the SMs
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_tile_edges(cuda, B, Sq, Sk, H, KV, hd, causal):
    """The tensor-core body at the edges of its 128-row query and 128-key
    tiles, GQA groups and head dims, against the plain version."""
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, torch.bfloat16, Sq + Sk + H + hd, cuda)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.ref_flash_attention(q, k, v, causal=causal)
    tol = FLASH_TOL[torch.bfloat16]
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [
    (1, 63, 63, 2, 1, 64),        # one warpgroup's rows, one key tile short
    (1, 65, 65, 4, 2, 64),        # one row into the second warpgroup, past a key tile
    (1, 127, 129, 4, 4, 32),      # one row short of a 128-row query tile, hd 32
    (2, 129, 127, 4, 4, 32),      # one row past it
    (1, 64, 255, 1, 1, 64),       # one CTA: a cluster of 4 over 4 key tiles, one short
    (1, 64, 256, 1, 1, 64),       # ... exactly 4 tiles
    (1, 64, 257, 1, 1, 64),       # ... 5 tiles, rank 0 takes two
    (1, 257, 257, 1, 1, 64),      # causal: the first query tile leaves ranks without keys
    (1, 96, 127, 2, 1, 128),      # hd 128: 32-key tiles, 4 x 32 - 1 keys
    (1, 96, 129, 2, 1, 128),      # ... 4 x 32 + 1
    (1, 33, 300, 8, 2, 128),      # Sq < Sk, GQA G = 4
    (2, 200, 50, 4, 4, 32),       # Sq > Sk
    (1, 300, 300, 16, 2, 64),     # GQA G = 8
    (1, 1000, 1000, 4, 2, 64),    # the 10f shape: clusters of 4
    (4, 512, 512, 16, 16, 64),    # 256 CTAs: no split
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_tile_edges(cuda, B, Sq, Sk, H, KV, hd, causal):
    """The float32 tensor-core body (three TF32 products) at the edges of its
    128-row query tiles (64 rows a warpgroup) and 64- or 32-key tiles, of the
    key tiles a cluster's ranks share, with GQA, causal or not, at hd 32, 64
    and 128: within the JAX suite's float32 tolerance of the plain version."""
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, torch.float32, Sq + Sk + H + hd, cuda)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.ref_flash_attention(q, k, v, causal=causal)
    tol = FLASH_TOL[torch.float32]
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 1000, 4, 2, 64), (1, 257, 2, 1, 32),
                                          (1, 300, 2, 2, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_split_is_deterministic(cuda, B, S, H, KV, hd, causal):
    """Shapes whose query tiles run as clusters of 2 or 4 CTAs, joined in rank
    order: two calls bitwise equal, and the strided (B, heads, S, hd) views
    (read with scalar loads) give the same bits as contiguous inputs."""
    q, k, v = _qkv(B, S, S, H, KV, hd, torch.float32, 11, cuda)
    a = flash_attention(q, k, v, causal=causal)
    assert torch.equal(a, flash_attention(q, k, v, causal=causal))
    buf = [torch.empty(t.numel() + 1, device=cuda) for t in (q, k, v)]
    shifted = [b_[1:].view(t.shape).copy_(t) for b_, t in zip(buf, (q, k, v))]
    assert shifted[0].data_ptr() % 16
    assert torch.equal(flash_attention(*shifted, causal=causal), a)


def test_flash_attention_copies_what_tma_cannot_read(cuda):
    """bf16 views with a base off the 16-byte grid, or a head stride that is
    not a multiple of 16 bytes, give the result of their contiguous copies."""
    q, k, v = _qkv(2, 200, 200, 4, 2, 64, torch.bfloat16, 1, cuda)

    def shifted(t):  # base one element (2 bytes) past an aligned allocation
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    def padded(t):  # rows of hd + 2 elements
        buf = torch.zeros((*t.shape[:3], t.shape[3] + 2), dtype=t.dtype, device=t.device)
        buf[..., :t.shape[3]].copy_(t)
        return buf[..., :t.shape[3]]

    want = flash_attention(q, k, v, causal=True)
    for make in (shifted, padded):
        qa, ka, va = (make(t) for t in (q, k, v))
        assert qa.data_ptr() % 16 or qa.stride(2) % 8
        assert torch.equal(flash_attention(qa, ka, va, causal=True), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_is_deterministic(cuda, dtype):
    """Two calls on the same inputs are bitwise equal (no atomics, a fixed
    summation order)."""
    q, k, v = _qkv(2, 1000, 1000, 8, 2, 128, dtype, 3, cuda)
    a = flash_attention(q, k, v, causal=True)
    b = flash_attention(q, k, v, causal=True)
    assert torch.equal(a, b)


def test_flash_attention_bf16_runs_on_tensor_cores(cuda):
    """The library's SASS: every instance of B10 runs on the tensor cores,
    with HGMMA (wgmma): bf16 on bf16, float32 as three TF32 products for
    each product."""
    from repro_torch.kernels import _build

    sass = {n: t for n, t in _build.sass().items() if "flash_attention" in n}
    bf16 = {n: t.count("HGMMA") for n, t in sass.items() if "bf16" in n}
    f32 = {n: t.count("HGMMA") for n, t in sass.items() if "f32" in n}
    assert len(bf16) == 4 and all(bf16.values()), bf16  # hd 32, 64, 128, 112
    assert len(f32) == 4 and all(f32.values()), f32


def test_forward_flash_matches_einsum_on_card(cuda):
    """The eval forward with kernel B10 against the einsum path, reduced
    Qwen3-4B (GQA, qk-norm) in float32 over 200 tokens (ragged tiles);
    2e-4, the JAX package's own flash-against-einsum tolerance."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.models import forward, init_params

    cfg = dataclasses.replace(C.get_reduced("qwen3_4b"), dtype="float32")
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (2, 200), generator=torch.Generator().manual_seed(1))
    before = flash_attention.launches
    with torch.no_grad():
        a, _ = forward(model, cfg, {"tokens": toks})
        b, _ = forward(model, dataclasses.replace(cfg, attn_impl="flash"), {"tokens": toks})
    torch.cuda.synchronize()
    assert flash_attention.launches - before == cfg.n_layers
    np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(), rtol=2e-4, atol=2e-4)


def test_trainer_steps_on_card(cuda, tmp_path):
    """Two trainer steps of a tiny float32 model on the card: finite losses,
    the mixture drawn by the forest kernels, state checkpointed and
    restorable."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.ckpt import latest_step
    from repro_torch.train import TrainConfig, Trainer

    cfg = dataclasses.replace(C.get_reduced("qwen1_5_0_5b"), dtype="bfloat16")
    tc = TrainConfig(steps=2, global_batch=4, seq_len=32, ckpt_dir=str(tmp_path),
                     log_every=1)
    before = forest_sample.launches
    out = Trainer(cfg, tc, log_fn=lambda s: None, device=cuda).run()
    torch.cuda.synchronize()
    assert forest_sample.launches - before == 2
    assert [m["step"] for m in out["metrics"]] == [0, 1]
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    assert int(out["opt"].step) == 2 and latest_step(tmp_path) == 2
    assert all(p.dtype == torch.float32 and p.is_cuda for p in out["params"].parameters())


def _outofplace_scan(a, bx):
    """The Mamba scan's rounds out of place, which autograd differentiates
    round by round."""
    n, d, h = a.shape[1], 1, bx
    while d < n:
        h = torch.cat([h[:, :d], h[:, d:] + a[:, d:] * h[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return h


def test_ssm_scan_backward_on_card(cuda):
    """``ssm_scan``'s adjoint scan against autograd through the out-of-place
    scan on the same card tensors, float32: rtol 1e-5, atol 1e-6 of the
    largest entry (on the CPU at this shape both stay within 2.3e-7 of it
    from float64)."""
    from repro_torch.models.ssm import ssm_scan

    g = torch.Generator(device=cuda).manual_seed(0)
    shape = (2, 300, 64, 16)
    a = torch.rand(shape, generator=g, device=cuda) * 0.5 + 0.5
    bx = torch.randn(shape, generator=g, device=cuda)
    dh = torch.randn(shape, generator=g, device=cuda)
    got = torch.autograd.grad(ssm_scan(a.requires_grad_(), bx.requires_grad_()), (a, bx), dh)
    want = torch.autograd.grad(_outofplace_scan(a, bx), (a, bx), dh)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6 * float(y.abs().max()))


@pytest.mark.parametrize("arch,over", [("kimi_k2_1t_a32b", {"n_layers": 1}),
                                       ("jamba_1_5_large_398b", {})])
def test_train_step_repeats_bitwise_on_card(cuda, arch, over):
    """One train step of a reduced MoE config (one layer) and of reduced
    Jamba (Mamba, attention and MoE) on the card, twice from the same
    state under ``torch.use_deterministic_algorithms(True)``: loss and
    every parameter and moment after the step bitwise equal. The MoE
    dispatch scatters and gathers by index, whose backward accumulates."""
    import dataclasses
    import os

    import repro_torch.configs as C
    from repro_torch.data import make_batch
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, init_opt
    from repro_torch.train.step import make_train_step

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = dataclasses.replace(C.get_reduced(arch), dtype="bfloat16", **over)
    batch = make_batch(cfg, 0, 4, 64)
    oc = AdamWConfig()
    out = []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                                param_dtype=torch.float32).requires_grad_(True)
            model, opt, m = make_train_step(cfg, oc, remat="none")(model, init_opt(oc, model),
                                                                   batch)
            torch.cuda.synchronize()
            out.append((m, model, opt))
    finally:
        torch.use_deterministic_algorithms(False)
    (m0, p0, o0), (m1, p1, o1) = out
    assert np.isfinite(float(m0["loss"]))
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"], m1["grad_norm"])
    for (n, a), b in zip(p0.named_parameters(), p1.parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(o0.m[n], o1.m[n]) and torch.equal(o0.v[n], o1.v[n]), n


# ------------------------------------------- wide forests and the 2-D map


def _wide_forest(n: int, m: int):
    """A forest of ``n`` >= 2^30 intervals made cheaply (not by
    ``build_forest``, whose flat level tables would need ~180 GB here):
    every guide cell tags one interval, spread up to ``n - 1``, except cell
    ``m - 3``, a two-node tree whose second node id is 2^30 (the pack's flag
    bit), and cell ``m - 2``, flagged, whose bisection runs over
    [2^30 - 1, 2^30] (``lo + hi + 1`` reaches 2^31 there)."""
    from repro_torch.core import RadixForest

    g = torch.arange(m, dtype=torch.int64)
    table = (~((g * (n - 1)) // (m - 1))).to(torch.int32)
    cdf = torch.zeros(n + 1)
    left = torch.full((n,), -1, dtype=torch.int32)
    right = torch.full((n,), -1, dtype=torch.int32)
    cell_first = torch.zeros(m + 1, dtype=torch.int32)
    fallback = torch.zeros(m, dtype=torch.bool)
    a, b = (1 << 30) - 2, 1 << 30
    table[m - 3] = a
    cdf[a], left[a], right[a] = (m - 2.5) / m, ~((1 << 30) - 3), b
    cdf[b], left[b], right[b] = (m - 2.25) / m, ~((1 << 30) - 1), ~(1 << 30)
    table[m - 2], fallback[m - 2] = a, True
    cell_first[m - 2], cell_first[m - 1] = (1 << 30) - 1, 1 << 30
    return RadixForest(cdf, table, left, right, cell_first, fallback)


def test_forest_sample_of_2_30_plus_1_intervals_takes_the_six_array_body(cuda):
    """C9: a forest of 2^30 + 1 intervals, whose node ids the pack's flag bit
    cannot hold beside them, descends through the six-array body (chosen
    from n; no pack made) and equals the plain version, node id 2^30 and a
    bisection at 2^30 included."""
    from repro_torch.core.sample import PackedForestHolder

    n, m = (1 << 30) + 1, 1 << 16
    f = _wide_forest(n, m)
    xi = torch.rand(1 << 16, generator=torch.Generator().manual_seed(3))
    xi[:6] = torch.tensor([(m - 2.9) / m, (m - 2.4) / m, (m - 2.1) / m, (m - 1.5) / m,
                           (m - 0.5) / m, 1 - 2**-24])
    want = forest_sample(*f[:4], f.cell_first, f.fallback, xi)
    assert want[:6].tolist() == [(1 << 30) - 3, (1 << 30) - 1, 1 << 30, 1 << 30, 1 << 30,
                                 1 << 30]
    fd = type(f)(*(t.to(cuda) for t in f))
    del f
    packs, launches = forest_pack.launches, forest_sample.launches
    got = forest_sample(*fd[:4], fd.cell_first, fd.fallback, xi.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert forest_pack.launches == packs and forest_sample.launches == launches + 1
    holder = PackedForestHolder()
    holder.forest = fd
    assert holder._packed is None
    with pytest.raises(ValueError, match="2\\^30"):
        forest_pack(fd.cdf, fd.table, fd.left, fd.right, fd.fallback)


def test_forest_sample_below_2_30_keeps_the_packed_body(cuda):
    """Below 2^30 intervals the wrapper packs on the way (one counted
    ``forest_pack`` launch) and the packed body's draws are unchanged."""
    w, m = _FORESTS["power8"]
    f = build_forest(w, m, device="cpu")
    fd = type(f)(*(t.to(cuda) for t in f))
    xi = torch.rand(50_000, generator=torch.Generator().manual_seed(4))
    packs = forest_pack.launches
    got = forest_sample(*fd[:4], fd.cell_first, fd.fallback, xi.to(cuda))
    assert forest_pack.launches == packs + 1
    assert torch.equal(got.cpu(), forest_sample(*f[:4], f.cell_first, f.fallback, xi))


@pytest.mark.parametrize("R,W,m,Q", [(1, 1, 1, 1), (3, 8, 8, 511), (17, 9, 16, 512),
                                     (5, 512, 512, 513), (64, 4096, 4096, 100_000)])
def test_sample_forest_rows_matches_plain(cuda, R, W, m, Q):
    """``build_forest_rows`` on the card equals the plain build from the same
    CDF bits, and ``sample_forest_rows`` (B5 over the row-local view) equals
    its plain version at lane counts around a tile, class widths at their
    edges, and uniforms at 0, 1 - 2^-24 and the rows' CDF values."""
    from repro_torch.core import build_forest_rows, np_build_cdf, sample_forest_rows

    rng = np.random.default_rng(R * W)
    img = rng.random((R, W)) ** 8 + 1e-9
    img[0, W // 2:] = 0.0                       # trailing zeros: lower bounds of 1.0
    img[0, 0] += 1.0
    cdfs = np.stack([np_build_cdf(r / r.sum()) for r in img])
    fc = build_forest_rows(cdfs, m, device="cpu")
    fd = build_forest_rows(cdfs, m, device=cuda)
    for k in ("data", "table", "left", "right", "cell_first", "fallback"):
        assert torch.equal(getattr(fd, k).cpu(), getattr(fc, k)), k
    rows = rng.integers(0, R, Q).astype(np.int32)
    xi = rng.random(Q).astype(np.float32)
    k = min(Q, R * W)
    xi[:k] = cdfs[:, :-1].reshape(-1)[:k]
    rows[:k] = np.repeat(np.arange(R), W)[:k]
    xi[-1], rows[-1] = 1 - 2**-24, 0
    before = forest_sample_batched.launches
    got = sample_forest_rows(fd, torch.as_tensor(rows).to(cuda), torch.as_tensor(xi).to(cuda))
    assert forest_sample_batched.launches == before + 1
    assert torch.equal(got.cpu(), sample_forest_rows(fc, rows, xi))


def _plain_map_drain(m, u, v):
    """A ``Map2DSampler``'s drain by the plain versions, on CPU copies of the
    card's forests and lane tables."""
    from repro_torch.core import RadixForest, sample_forest
    from repro_torch.kernels import ops as K

    marg = RadixForest(*(t.cpu() for t in m.forest))
    row = sample_forest(marg, u.cpu(), device="cpu")
    r = row.long()
    fused = len(m.classes) == 1
    lanes = (None if fused else m._group_t.cpu()[r], m._slot_t.cpu()[r], m._hi_t.cpu()[r])
    col = torch.empty_like(row)
    forests = [BatchedForest(*(t.cpu() for t in c.forest)) for c in m.classes.values()]
    K.forest_sample_grouped(forests, lanes, col, xi=v.cpu())
    return row, col


def test_map2d_fused_drain_makes_no_host_sync(cuda):
    """The single-class drain (B1 on the marginal, the slot gather, B5, the
    width clip) runs under ``set_sync_debug_mode("error")`` and equals the
    plain versions; the 2-D device streams equal their host twin."""
    from repro_torch.configs.paper_workloads import env_map_2d
    from repro_torch.serve.sampler import DeviceQmc2Streams, Qmc2Streams
    from repro_torch.spatial import Map2DSampler

    m = Map2DSampler(env_map_2d(64, 128), device=cuda)
    assert len(m.classes) == 1
    streams, host = DeviceQmc2Streams(1024, seed=1, device=cuda), Qmc2Streams(1024, seed=1)
    slots = np.random.default_rng(0).integers(0, 1024, 20_000)
    slots[:64] = slots[64:128]
    u, v = streams.draw(slots)
    hu, hv = host.next(slots)
    assert np.array_equal(u.cpu().numpy(), hu) and np.array_equal(v.cpu().numpy(), hv)
    assert np.array_equal(streams.counters.cpu().numpy().view(np.uint32), host.counters)
    m.sample_map((u, v))
    torch.cuda.synchronize()
    b1, b5 = forest_sample.launches, forest_sample_batched.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        row, col, _, _ = m.sample_map((u, v))
        with pytest.raises(RuntimeError):  # the mode does refuse a host read
            row[0].item()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (forest_sample.launches - b1, forest_sample_batched.launches - b5) == (1, 1)
    want_row, want_col = _plain_map_drain(m, u, v)
    assert torch.equal(row.cpu(), want_row) and torch.equal(col.cpu(), want_col)


def test_map2d_multi_class_drain_and_update_on_card(cuda):
    """A ragged map over several classes drains in one grouped B5 launch
    equal to the plain versions; an update is bit-equal to a fresh build
    on the card."""
    from repro_torch.spatial import Map2DSampler

    rng = np.random.default_rng(2)
    rows = [rng.random(w) ** 3 + 1e-6 for w in rng.integers(1, 300, 200)]
    rows[7] = np.zeros(len(rows[7]))
    m = Map2DSampler(rows, device=cuda)
    assert len(m.classes) >= 5
    pts = torch.rand((30_000, 2), generator=torch.Generator().manual_seed(1)).to(cuda)
    before = forest_sample_batched.launches
    row, col, u, v = m.sample_map(pts)
    assert forest_sample_batched.launches == before + 1
    want_row, want_col = _plain_map_drain(m, u, v)
    assert torch.equal(row.cpu(), want_row) and torch.equal(col.cpu(), want_col)
    assert not bool((row == 7).any())
    new = {r: rng.random(len(rows[r])) + 0.1 for r in (3, 7, 150)}
    m.update_map(new)
    fresh_rows = list(rows)
    for r, w in new.items():
        fresh_rows[r] = w
    fresh = Map2DSampler(fresh_rows, device=cuda)
    for wc in m.classes:
        for a, b in zip(m.classes[wc].forest, fresh.classes[wc].forest):
            assert torch.equal(a, b), wc
    for a, b in zip(m.forest, fresh.forest):
        assert torch.equal(a, b)


def test_save_state_round_trips_card_tensors_bit_for_bit(cuda, tmp_path):
    """``save_state`` of CUDA tensors (bfloat16 included) loads back with
    the same bits: bfloat16 as a CPU bf16 tensor, the rest as numpy."""
    from repro_torch.ckpt import load_state, save_state

    g = torch.Generator(device=cuda).manual_seed(0)
    blob = {"f": torch.rand(1000, generator=g, device=cuda),
            "bf": torch.randn(64, 33, generator=g, device=cuda).to(torch.bfloat16),
            "i": torch.arange(7, dtype=torch.int32, device=cuda), "t": (1, "x")}
    save_state(tmp_path, blob, 2)
    got, step = load_state(tmp_path)
    assert step == 2 and got["t"] == (1, "x")
    assert got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"].view(torch.int16), blob["bf"].cpu().view(torch.int16))
    assert np.array_equal(got["f"].view(np.int32), blob["f"].cpu().numpy().view(np.int32))
    assert np.array_equal(got["i"], blob["i"].cpu().numpy())


def test_sample_sharded_on_one_rank_nccl_equals_sample_forest(cuda, tmp_path):
    """A single-rank nccl group: the sharded build gathers to build_forest's
    arrays and both drains equal sample_forest; B2/B3 launch on the way."""
    import torch.distributed as dist

    from repro_torch.core import sample_forest
    from repro_torch.dist import forest as DF

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        rng = np.random.default_rng(3)
        w = (rng.random(1 << 16) ** 4 + 1e-6).astype(np.float32)
        before = (cdf_scan.launches, forest_delta.launches)
        sf = DF.build_forest_sharded(w, 1 << 14, device=cuda)
        assert cdf_scan.launches > before[0] and forest_delta.launches > before[1]
        f = build_forest(w, 1 << 14, device=cuda)
        g = DF.gather_forest(sf)
        for a, b in zip(g, f):
            assert torch.equal(a, b)
        xi = torch.rand(1 << 18, generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda)
        want = sample_forest(f, xi, device=cuda)
        for routed in (True, False):
            assert torch.equal(DF.sample_sharded(sf, xi, routed=routed, device=cuda), want)
        with pytest.raises(ValueError, match="gloo"):
            DF.sample_sharded(sf, xi.cpu(), device="cpu")
    finally:
        dist.destroy_process_group()


def test_verify_pool_names_a_corrupted_card_row(cuda):
    from repro_torch.robust import verify_pool

    rng = np.random.default_rng(4)
    pool = ForestPool(device=cuda)
    hs = pool.insert_many([rng.random(n) + 1e-3 for n in (5, 40, 300, 40)],
                          method=["forest", "forest", "alias", "alias"])
    assert verify_pool(pool) == []
    pool.classes[hs[1].size_class].forest.cdf[hs[1].row, 7] = float("nan")
    pool.alias_classes[hs[2].size_class].table.q[hs[2].row, 3] = 2.0
    assert verify_pool(pool) == [
        f"forest[64] row {hs[1].row}: cdf has non-finite entries",
        f"alias[512] row {hs[2].row}: alias split points q outside [0, 1]"]


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A (1, 1) DeviceMesh over a single-rank nccl group, destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1, device=cuda)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("H,KV,h0,Hl", [(16, 4, 6, 4), (16, 4, 8, 8), (8, 8, 3, 2),
                                         (32, 8, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_on_local_heads_at_an_offset(cuda, H, KV, h0, Hl, dtype):
    """B10 on a rank's query heads h0..h0+Hl (global KV head (h0 + h) //
    (H / KV): a slice where the heads cover whole groups, else one KV head
    picked a query head) against its plain version on the same heads."""
    from repro_torch.dist.local import _kv_heads

    g = torch.Generator(device=cuda).manual_seed(H * 100 + h0)
    q, k, v = (torch.randn(2, 300, n, 64, generator=g, device=cuda).to(dtype)
               for n in (H, KV, KV))
    kl, vl = _kv_heads(k, h0, Hl, H // KV), _kv_heads(v, h0, Hl, H // KV)
    got = flash_attention(q[:, :, h0:h0 + Hl], kl, vl, causal=True)
    want = ref.ref_flash_attention(q, k, v, causal=True)[:, :, h0:h0 + Hl]
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _dist_lm_cfg():
    import dataclasses

    import repro_torch.configs as C

    return dataclasses.replace(C.get_reduced("qwen1_5_0_5b"), n_layers=4, d_model=512,
                               n_heads=8, n_kv_heads=8, head_dim=64, vocab=4096)


def test_dist_lm_train_step_on_one_rank_is_bitwise(cuda, nccl_mesh):
    """Train steps of a model distributed by ``Policy.recommended`` on the
    (1, 1) nccl mesh: losses, gradient norms, parameters and moments bit
    for bit the unsharded model's, under deterministic algorithms."""
    from repro_torch.data import MixtureSampler, make_batch
    from repro_torch.dist import sharding as TS
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, init_opt
    from repro_torch.train.step import make_train_step

    cfg = _dist_lm_cfg()
    mixture = MixtureSampler((0.5, 0.25, 0.125, 0.125), device=cuda)

    def model():
        return init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                           param_dtype=torch.float32).requires_grad_()

    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    plain = model()
    sh = TS.distribute_params(model(), nccl_mesh, TS.Policy.recommended(cfg, nccl_mesh, "train"))
    po, so = init_opt(oc, plain), init_opt(oc, sh)
    step = make_train_step(cfg, oc, remat="dots")
    torch.use_deterministic_algorithms(True)
    try:
        for s in range(2):
            batch = make_batch(cfg, s, 4, 128, mixture=mixture)
            _, _, m1 = step(plain, po, batch)
            _, _, m2 = step(sh, so, batch)
            for k in ("loss", "grad_norm", "lr"):
                assert torch.equal(m1[k], m2[k]), k
    finally:
        torch.use_deterministic_algorithms(False)
    for (n, a), b in zip(plain.named_parameters(), sh.parameters()):
        assert torch.equal(whole(b), a), n
    for k in po.m:
        assert torch.equal(whole(so.m[k]), po.m[k]) and torch.equal(whole(so.v[k]), po.v[k])


def test_dryrun_argument_bytes_equal_the_card_state(cuda, tmp_path):
    """The dry run's per-rank argument bytes of a train cell (a fake world
    of one rank, ``meta`` tensors, the one- and two-period states
    extrapolated) equal the bytes of the same state on the card:
    parameters, AdamW moments and step, and the int32 batch, placed by
    ``Policy.recommended`` on a (1, 1) nccl mesh."""
    from types import SimpleNamespace

    import torch.distributed as dist

    from repro_torch.dist import sharding as TS
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, init_opt

    cfg, sh = _dist_lm_cfg(), ShapeSpec("t", 128, 4, "train")
    with D.fake_world(1):
        mesh = make_production_mesh(mesh_shape=(1, 1))
        want = D.argument_bytes(cfg, sh, mesh, TS.Policy.recommended(cfg, mesh, "train"))
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device=cuda)
        model = TS.distribute_params(
            init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda,
                        param_dtype=torch.float32).requires_grad_(),
            mesh, TS.Policy.recommended(cfg, mesh, "train"))
        batch = {k: torch.zeros(sh.global_batch, sh.seq_len, dtype=torch.int32, device=cuda)
                 for k in ("tokens", "labels")}
        state = SimpleNamespace(groups={"params": model, "opt": init_opt(AdamWConfig(), model),
                                        "batch": batch})
        assert D.input_bytes(state) == want
    finally:
        dist.destroy_process_group()


def test_dist_lm_hinted_flash_and_decode_on_one_rank(cuda, nccl_mesh):
    """The hinted flash eval forward (B10 through the local-heads wrapper)
    and four ``make_serve_step`` steps (B3, B9) on a cache placed by
    ``cache_spec_tree``: bit for bit the unsharded model's; the compressed
    pod all-reduce of a gradient equals dequantize(quantize(g))."""
    import dataclasses

    from repro_torch.dist import compression as Q
    from repro_torch.dist import hints as H
    from repro_torch.dist import sharding as TS
    from repro_torch.models import forward, init_params, prefill
    from repro_torch.train.step import make_serve_step

    cfg = _dist_lm_cfg()
    flash = dataclasses.replace(cfg, attn_impl="flash")
    g = torch.Generator(device=cuda)
    plain = init_params(cfg, g.manual_seed(0), cuda)
    pol = TS.Policy.for_mesh(nccl_mesh)
    dm = TS.distribute_params(init_params(cfg, g.manual_seed(0), cuda), nccl_mesh, pol)
    tok = torch.randint(0, cfg.vocab, (2, 512), generator=g.manual_seed(1), device=cuda)
    before = flash_attention.launches
    with torch.no_grad():
        want, _ = forward(plain, flash, {"tokens": tok})
        with H.sharding_hints(H.Hints(pol, gather_weights=True, seq_shard=True)):
            got, _ = forward(dm, flash, {"tokens": tok})
    assert flash_attention.launches - before == 2 * cfg.n_layers
    assert torch.equal(whole(got), want)

    pol = TS.Policy.recommended(cfg, nccl_mesh, "decode")
    dd = TS.distribute_params(init_params(cfg, g.manual_seed(0), cuda), nccl_mesh, pol)
    logits, cache, _ = prefill(plain, cfg, {"tokens": tok[:, :16].repeat(8, 1)}, max_seq=32)
    dcache = TS.distribute_cache(cfg, {b: {k: t.clone() for k, t in c.items()}
                                       for b, c in cache.items()}, nccl_mesh, pol)
    serve = make_serve_step(cfg)
    nxt, pos = logits.argmax(-1), torch.full((16,), 16, device=cuda)
    before = (cdf_scan.launches, sample_rows.launches)
    for s in range(4):
        xi = torch.rand(16, generator=g.manual_seed(10 + s), device=cuda)
        a, _ = serve(plain, cache, nxt, pos, xi)
        b, _ = serve(dd, dcache, nxt, pos, xi)
        assert torch.equal(a, b)
        nxt, pos = a, pos + 1
    assert (cdf_scan.launches - before[0], sample_rows.launches - before[1]) == (8, 8)
    for b_, c in cache.items():
        for k, t in c.items():
            assert torch.equal(whole(dcache[b_][k]), t), (b_, k)

    x = torch.randn(10_000, generator=g.manual_seed(2), device=cuda)
    q, s = Q.quantize_int8(x)
    assert torch.equal(Q.make_pod_allreduce(compress=True)(x), Q.dequantize_int8(q, s))
    assert torch.equal(Q.make_pod_allreduce()(x), x)


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "jamba_1_5_large_398b"])
def test_dist_families_on_one_rank_are_bitwise(cuda, nccl_mesh, arch):
    """Reduced Kimi K2 (MoE) and one period of reduced Jamba (Mamba,
    attention, MoE) distributed on the (1, 1) nccl mesh, where the MoE,
    Mamba and decode-cache local forms run on whole shards: a train step
    under ``Policy.for_mesh`` (loss, gradient norm, every parameter and
    moment) under deterministic algorithms, and prefill plus four decode
    steps under the decode preset and under the 2-D ``shard_seq`` preset
    (logits and cache), bit for bit the unsharded model's."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.data import make_batch
    from repro_torch.dist import sharding as TS
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.train import AdamWConfig, init_opt
    from repro_torch.train.step import make_train_step

    cfg = C.get_reduced(arch)
    if arch.startswith("jamba"):
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern))   # one period
    g = torch.Generator(device=cuda)

    def model(dtype=torch.float32):
        return init_params(cfg, g.manual_seed(0), cuda, param_dtype=dtype)

    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    plain = model().requires_grad_()
    sh = TS.distribute_params(model(), nccl_mesh, TS.Policy.for_mesh(nccl_mesh)).requires_grad_()
    po, so = init_opt(oc, plain), init_opt(oc, sh)
    step = make_train_step(cfg, oc, remat="none")
    batch = make_batch(cfg, 0, 4, 64)
    torch.use_deterministic_algorithms(True)
    try:
        _, _, m1 = step(plain, po, batch)
        _, _, m2 = step(sh, so, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    for k in ("loss", "grad_norm", "lr"):
        assert torch.equal(m1[k], m2[k]), k
    for (n, a), b in zip(plain.named_parameters(), sh.parameters()):
        assert torch.equal(whole(b), a), n
    for k in po.m:
        assert torch.equal(whole(so.m[k]), po.m[k]) and torch.equal(whole(so.v[k]), po.v[k])

    tok = torch.randint(0, cfg.vocab, (8, 16), generator=g.manual_seed(1), device=cuda)
    plain = init_params(cfg, g.manual_seed(0), cuda)
    logits, cache, _ = prefill(plain, cfg, {"tokens": tok}, max_seq=24)
    for pol in (TS.Policy.recommended(cfg, nccl_mesh, "decode"),
                TS.Policy(dp=(), tp=("data", "model"), fsdp=(), shard_seq=True, sp="model")):
        dm = TS.distribute_params(init_params(cfg, g.manual_seed(0), cuda), nccl_mesh, pol)
        dl, dc, _ = prefill(dm, cfg, {"tokens": tok}, max_seq=24)
        assert torch.equal(whole(dl), logits)
        for b_, c in cache.items():
            for k, t in c.items():
                assert torch.equal(whole(dc[b_][k]), t), (pol, b_, k)
        want = {b_: {k: t.clone() for k, t in c.items()} for b_, c in cache.items()}
        got = TS.distribute_cache(cfg, {b_: {k: t.clone() for k, t in c.items()}
                                        for b_, c in cache.items()}, nccl_mesh, pol)
        nxt, pos = logits.argmax(-1), torch.full((8,), 16, device=cuda)
        for _ in range(4):
            a, want = decode_step(plain, cfg, want, nxt, pos)
            b, got = decode_step(dm, cfg, got, nxt, pos)
            assert torch.equal(whole(b), a), pol
            nxt, pos = a.argmax(-1), pos + 1
        for b_, c in want.items():
            for k, t in c.items():
                assert torch.equal(whole(got[b_][k]), t), (pol, b_, k)
