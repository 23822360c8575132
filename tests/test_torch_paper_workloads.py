"""The port's QMC generators, metrics, Table 1 counting and the paper's
workload benchmarks (``benchmarks/torch_table1.py``,
``benchmarks/torch_convergence.py``) against the JAX package (CPU).

The generators are exact integer (or float64 numpy) arithmetic copied from
the reference, so they are held bit for bit, the 2-D stream twins on
tensors included. Counting is a function of the forest arrays, which are a
function of the CDF bits: given the reference's CDF every count equals
the reference's. The port's own CDF differs from the reference's by a few
ulp (ROADMAP C2); what that moves is pinned here as measured.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import benchmarks.convergence as jax_conv
import benchmarks.table1 as jax_table1
import benchmarks.torch_convergence as conv
import benchmarks.torch_table1 as table1
from repro.core import build_cdf as jax_build_cdf
from repro.core import build_forest as jax_build_forest
from repro.core import counting as jax_counting
from repro.core import lds as jax_lds
from repro.core import metrics as jax_metrics
from repro_torch.core import (
    build_forest,
    forest_from_cdf,
    forest_to_numpy,
    np_sample_cutpoint_binary_counting,
    np_sample_forest_counting,
    quadratic_error,
    sample_forest,
    star_discrepancy_1d,
    table1_row,
    warp_cost,
    warped_uniformity_1d,
)
from repro_torch.core import lds
from repro_torch.core.cdf import normalize_weights
from repro_torch.core.counting import np_sample_binary_counting
from repro_torch.core.sample import sample_forest_with_stats

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()


def _jax_cdf(w) -> np.ndarray:
    return np.asarray(jax_build_cdf(jnp.asarray(w, jnp.float32)))


# ------------------------------------------------------------------- lds


@pytest.mark.parametrize("scramble", [None, 3])
def test_sobol_equals_jax_in_every_dimension(scramble):
    want = jax_lds.sobol(513, jax_lds.SOBOL_MAX_DIMS, scramble_seed=scramble)
    got = lds.sobol(513, lds.SOBOL_MAX_DIMS, scramble_seed=scramble)
    assert lds.SOBOL_MAX_DIMS == jax_lds.SOBOL_MAX_DIMS == 17
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    with pytest.raises(ValueError):
        lds.sobol(8, lds.SOBOL_MAX_DIMS + 1)


@pytest.mark.parametrize("fn,args", [
    ("hammersley", (300, 2)), ("hammersley", (97, 17)),
    ("halton", (300, 3)), ("halton", (50, 16, 1000)),
    ("uniform", (64, 3, 5)),
])
def test_point_sets_equal_jax(fn, args):
    got, want = getattr(lds, fn)(*args), getattr(jax_lds, fn)(*args)
    assert got.shape == want.shape and np.array_equal(got.view(np.uint64),
                                                      want.view(np.uint64))


@pytest.mark.parametrize("base", [2, 3, 5, 7, 53])
def test_radical_inverse_equals_jax(base):
    i = np.concatenate([np.arange(2000), [2**24 - 1, 2**31 - 1, 2**32 - 1]])
    if base != 2:
        i = i.astype(np.int64)
    got, want = lds.radical_inverse(i, base), jax_lds.radical_inverse(i, base)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))


def _counters() -> np.ndarray:
    rng = np.random.default_rng(4)
    edges = np.concatenate([np.arange(2**24 - 64, 2**24 + 64),
                            np.arange(2**32 - 128, 2**32), np.arange(64)])
    return np.concatenate([edges, rng.integers(0, 2**32, 4000)]).astype(np.uint32)


def test_2d_stream_points_equal_jax_numpy_and_tensor_twins():
    """The 2-D stream pipeline bit for bit: numpy against JAX's numpy, the
    tensor twins (int32 bit views in) against JAX's jnp twins, at counters
    around 2^24 and up to 2^32 - 1."""
    c = _counters()
    rng = np.random.default_rng(5)
    ou = rng.integers(0, 2**24, len(c)).astype(np.uint32)
    ov = rng.integers(0, 2**24, len(c)).astype(np.uint32)
    assert np.array_equal(lds.sobol2_bits24_np(c), jax_lds.sobol2_bits24_np(c))
    for got, want in zip(lds.qmc2_bits24_np(c, ou, ov), jax_lds.qmc2_bits24_np(c, ou, ov)):
        assert np.array_equal(got, want)
    for got, want in zip(lds.qmc2_point_np(c, ou, ov), jax_lds.qmc2_point_np(c, ou, ov)):
        assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32),
                                                          want.view(np.uint32))

    def bits(a):
        return torch.as_tensor(a.view(np.int32))

    jc, jou, jov = (jnp.asarray(a) for a in (c, ou, ov))
    assert np.array_equal(lds.sobol2_bits24(bits(c)).numpy(),
                          np.asarray(jax_lds.sobol2_bits24(jc)).astype(np.int64))
    # int64 values in give the same as int32 bits in
    assert torch.equal(lds.sobol2_bits24(torch.as_tensor(c.astype(np.int64))),
                       lds.sobol2_bits24(bits(c)))
    for got, want in zip(lds.qmc2_bits24(bits(c), bits(ou), bits(ov)),
                         jax_lds.qmc2_bits24(jc, jou, jov)):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    for got, want in zip(lds.qmc2_point(bits(c), bits(ou), bits(ov)),
                         jax_lds.qmc2_point(jc, jou, jov)):
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))


def test_lds_low_discrepancy():
    n = 4096
    assert star_discrepancy_1d(lds.sobol(n, 1)[:, 0]) < 0.002
    assert star_discrepancy_1d(lds.hammersley(n, 2)[:, 1]) < 0.01
    assert star_discrepancy_1d(np.random.default_rng(0).random(n)) > 0.005


def test_sobol_high_dims_distinct_and_nondegenerate():
    """Pairwise-distinct columns through dim 16 with non-degenerate 2-D
    projections (>= 64 of 256 cells), each column of low discrepancy."""
    n = 256
    p = lds.sobol(n, 16)
    for i in range(16):
        for j in range(i + 1, 16):
            assert not np.array_equal(p[:, i], p[:, j]), (i, j)
            grid = np.zeros((16, 16), int)
            np.add.at(grid, (np.floor(p[:, i] * 16).astype(int),
                             np.floor(p[:, j] * 16).astype(int)), 1)
            assert np.count_nonzero(grid) >= 64, (i, j)
        assert star_discrepancy_1d(p[:, i]) < 0.02, i
    assert lds.sobol(8, lds.SOBOL_MAX_DIMS).shape == (8, lds.SOBOL_MAX_DIMS)


def test_radical_inverse_exact_float32():
    i = np.arange(1024, dtype=np.uint32)
    x = lds.radical_inverse_base2(i)
    assert np.all((x >= 0) & (x < 1))
    assert np.all(np.float32(x).astype(np.float64) == x)
    assert len(np.unique(np.float32(x))) == 1024


# ------------------------------------------------------- metrics, counting


def test_metrics_equal_jax():
    rng = np.random.default_rng(8)
    x = rng.random(3000)
    assert abs(star_discrepancy_1d(x) - jax_metrics.star_discrepancy_1d(x)) <= 1e-12
    p = normalize_weights(rng.random(50) + 0.1).astype(np.float64)
    counts = rng.integers(0, 100, 50)
    assert abs(quadratic_error(counts, p) - jax_metrics.quadratic_error(counts, p)) <= 1e-12
    cdf = np.concatenate([[0.0], np.cumsum(p)])
    xi = rng.random(2000)
    idx = np.clip(np.searchsorted(cdf[1:], xi, side="right"), 0, 49)
    assert abs(warped_uniformity_1d(xi, idx, cdf)
               - jax_metrics.warped_uniformity_1d(xi, idx, cdf)) <= 1e-12


@pytest.mark.parametrize("n,m", [(200, 128), (64, 16), (300, 300)])
def test_counting_equals_jax_given_jax_cdf(n, m):
    """Every counting twin and Table 1 row equals the reference's on the
    forest built from the reference's CDF; the forest's counts also equal
    ``sample_forest_with_stats`` plus the guide load."""
    rng = np.random.default_rng(n)
    w = normalize_weights(rng.random(n) ** 6 + 1e-9)
    jf = jax_build_forest(jnp.asarray(w), m)
    f = forest_from_cdf(np.asarray(jf.cdf), m, device="cpu")
    xi = rng.random(4096).astype(np.float32)
    fn = forest_to_numpy(f)
    i_np, loads = np_sample_forest_counting(f, xi)
    j_np, jloads = jax_counting.np_sample_forest_counting(jf, xi)
    assert np.array_equal(i_np, j_np) and np.array_equal(loads, jloads)
    idx, visits = sample_forest_with_stats(f, xi, device="cpu")
    assert np.array_equal(idx.numpy(), i_np) and np.array_equal(visits.numpy() + 1, loads)
    got = np_sample_cutpoint_binary_counting(fn["cdf"], fn["cell_first"], fn["table"], xi)
    want = jax_counting.np_sample_cutpoint_binary_counting(
        np.asarray(jf.cdf), np.asarray(jf.cell_first), np.asarray(jf.table), xi)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    got = np_sample_binary_counting(fn["cdf"], xi)
    want = jax_counting.np_sample_binary_counting(np.asarray(jf.cdf), xi)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert table1_row(loads) == jax_counting.table1_row(jloads)
    assert warp_cost(loads, 8) == jax_counting.warp_cost(jloads, 8)


def test_table1_shape_of_results():
    """The forest beats binary search on avg_32 for the periodic HDR
    distribution, on the port's own build."""
    n = 256
    rng = np.random.default_rng(0)
    xi = rng.random(1 << 14).astype(np.float32)
    w = normalize_weights((np.arange(n) % 64 + 1.0) ** 35)
    f = build_forest(w, 256, device="cpu")
    fn = forest_to_numpy(f)
    _, loads_f = np_sample_forest_counting(f, xi)
    _, loads_b = np_sample_cutpoint_binary_counting(fn["cdf"], fn["cell_first"], fn["table"], xi)
    assert warp_cost(loads_f) < warp_cost(loads_b)


def test_kary_collapse_counts():
    """Paper Sec. 5: a 4-ary traversal visits ceil(depth / 2) nodes."""
    rng = np.random.default_rng(1)
    w = normalize_weights(rng.random(512) ** 10 + 1e-12)
    f = build_forest(w, 128, device="cpu")
    xi = rng.random(4096).astype(np.float32)
    _, loads = np_sample_forest_counting(f, xi)
    tree_visits = loads - 1
    kary_loads = 1 + np.ceil(tree_visits / 2)
    assert np.all(kary_loads <= loads)
    assert float(kary_loads.mean()) < float(loads.mean()) or tree_visits.max() <= 1


# ------------------------------------------------------------- benchmarks


def test_torch_table1_equals_jax_table1_given_jax_cdf():
    want = jax_table1.run(n_samples=1 << 14)
    got = table1.run(n_samples=1 << 14, device="cpu", cdf_of=lambda _name, w: _jax_cdf(w))
    assert got == want
    assert table1.PAPER == jax_table1.PAPER


def test_torch_table1_on_its_own_cdf_moves_one_row():
    """On the port's own CDF (which differs from the reference's in a few
    words, ROADMAP C2), the ``(i mod 32 + 1)^25`` cutpoint+binary row reads
    avg 1.2548 / avg32 4.1304 against the reference's 1.2470 / 3.9414 (the
    full 2^16 draws; measured on the CPU); every other row is equal."""
    want = jax_table1.run()
    got = table1.run(device="cpu")
    moved = [(a[0], a[1]) for a, b in zip(got, want) if a != b]
    assert moved == [("(i mod 32 + 1)^25", "cutpoint+binary")]
    row = dict(((a[0], a[1]), a[2]) for a in got)[moved[0]]
    assert (row["maximum"], round(row["average"], 4), round(row["average_32"], 4)) == \
        (6, 1.2548, 4.1304)
    lines = table1.main(device="cpu")
    assert len(lines) == 8 and all(s.startswith("table1,") and "| paper:" in s for s in lines)


def test_torch_convergence_equals_jax_given_jax_cdf():
    """Errors equal the reference's bit for bit given its CDFs, and the
    inverse histograms equal histograms of the reference's draws."""
    counts = []
    got = conv.run_1d(max_log2=12, device="cpu", cdf_of=_jax_cdf, counts=counts)
    assert got == jax_conv.run_1d(max_log2=12)
    p = jax_conv.density_1d()
    assert np.array_equal(conv.density_1d(), p)
    xi = jax_lds.sobol(1 << 12, dims=1)[:, 0].astype(np.float32)
    jf = jax_build_forest(jnp.asarray(p), 64)
    from repro.core import sample_forest as jax_sample_forest

    want = np.bincount(np.asarray(jax_sample_forest(jf, jnp.asarray(xi))), minlength=64)
    assert np.array_equal(counts[-1], want)
    got2 = conv.run_2d(max_log2=12, h=16, w=32, device="cpu", cdf_of=_jax_cdf)
    assert got2 == jax_conv.run_2d(max_log2=12, h=16, w=32)
    got3 = conv.run_discrepancy(1024, device="cpu", cdf_of=_jax_cdf)
    assert got3 == jax_conv.run_discrepancy(1024)


def test_torch_convergence_on_dyadic_densities_equals_jax(monkeypatch):
    """Fed dyadic densities, the port's own CDFs are exact and so equal the
    reference's: every error is equal, on the port's own build."""
    x = np.arange(64)
    dyadic_1d = ((x % 8) + 1).astype(np.float64)
    dyadic_1d[-1] += 512 - dyadic_1d.sum()   # total 512: every p_i dyadic
    dyadic_1d = dyadic_1d / 512

    def env(h, w, seed=0):
        img = (np.add.outer(np.arange(h) % 4, np.arange(w) % 4) + 1).astype(np.float64)
        return img / img.sum()

    for mod in (conv, jax_conv):
        monkeypatch.setattr(mod, "density_1d", lambda n=64: dyadic_1d.astype(np.float32))
        monkeypatch.setattr(mod, "env_map_2d", env)
    assert conv.run_1d(max_log2=10, device="cpu") == jax_conv.run_1d(max_log2=10)
    assert conv.run_2d(max_log2=12, h=16, w=32, device="cpu") == \
        jax_conv.run_2d(max_log2=12, h=16, w=32)
    assert conv.run_discrepancy(512, device="cpu") == jax_conv.run_discrepancy(512)


# On the port's own CDFs, the relative difference of each error from the
# reference's. Measured on the CPU at these sizes: 0 for every row (the
# CDFs differ in 21 of 65 words for density_1d, but no Sobol' point of the
# first 2^12 falls between two CDFs' boundaries). A draw that did move
# would change one count by 1 and an error by about 2/N * |c/N - p|,
# relatively up to ~1e-2 at N = 2^8.
CONVERGENCE_RTOL = 1e-2


def test_torch_convergence_on_its_own_cdf_within_tolerance():
    for got, want in ((conv.run_1d(max_log2=12, device="cpu"), jax_conv.run_1d(max_log2=12)),
                      (conv.run_2d(max_log2=12, h=16, w=32, device="cpu"),
                       jax_conv.run_2d(max_log2=12, h=16, w=32))):
        for (n, e_inv, e_ali), (n2, j_inv, j_ali) in zip(got, want):
            assert n == n2 and e_ali == j_ali  # the alias baseline is the host's
            assert abs(e_inv - j_inv) <= CONVERGENCE_RTOL * j_inv, (n, e_inv, j_inv)
    d, jd = conv.run_discrepancy(1024, device="cpu"), jax_conv.run_discrepancy(1024)
    for k in d:
        assert abs(d[k] - jd[k]) <= CONVERGENCE_RTOL * jd[k], k
    assert abs(d["inverse"] - d["input"]) < 1e-6  # a monotone warp preserves it
    assert d["alias"] > 5 * d["inverse"]


def test_sample_forest_twin_on_jax_forest_arrays():
    """The port's sampler on the reference's forest arrays resolves the
    draws of the 1-D convergence density as the reference does."""
    p = conv.density_1d()
    jf = jax_build_forest(jnp.asarray(p), 64)
    f = forest_from_cdf(np.asarray(jf.cdf), 64, device="cpu")
    xi = lds.sobol(4096, 1)[:, 0].astype(np.float32)
    from repro.core import sample_forest as jax_sample_forest

    assert np.array_equal(sample_forest(f, xi, device="cpu").numpy(),
                          np.asarray(jax_sample_forest(jf, jnp.asarray(xi))))
