"""The port's multi-row forest (``core/forest2d.py``) and
``pool.batched_from_row_forest`` against the JAX package (CPU).

Tree topology is a function of the CDF bits, so both builders get the same
CDF rows (numpy's ``np_build_cdf``, as the reference's own tests use) and
their arrays are held bit for bit; the descents elementwise. The cases of
``tests/test_forest2d_and_extras.py`` run here at fixed seeds.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import forest2d as jax_forest2d
from repro.core.cdf import normalize_weights, np_build_cdf
from repro.pool.batched import batched_from_row_forest as jax_batched_from_row_forest
from repro_torch.core import (
    build_forest,
    build_forest_rows,
    depth_stats,
    forest_from_cdf,
    np_reference_rows,
    sample_forest,
    sample_forest_rows,
    validate_forest_rows,
)
from repro_torch.pool import batched_from_row_forest

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

_FIELDS = ("data", "table", "left", "right", "cell_first", "fallback")

# (seed, R, W, m): the hypothesis ranges of the reference's tests, at fixed
# draws, and the edges (one row, width 1, m 1, m > W).
_CASES = [(0, 5, 33, 16), (1, 1, 2, 1), (2, 12, 40, 64), (3, 3, 1, 1), (4, 4, 17, 3),
          (5, 10, 2, 48), (6, 7, 40, 1)]


def _cdfs(seed, R, W, power=6, zero_tail=0):
    rng = np.random.default_rng(seed)
    img = rng.random((R, W)) ** power + 1e-9
    if zero_tail and W > zero_tail:
        img[0, W - zero_tail:] = 0.0   # trailing zero weights: lower bounds of 1.0
    return rng, np.stack([np_build_cdf(normalize_weights(r)) for r in img])


@pytest.mark.parametrize("seed,R,W,m", _CASES)
def test_build_forest_rows_bit_equal_to_jax(seed, R, W, m):
    _, cdfs = _cdfs(seed, R, W, zero_tail=3)
    want = jax_forest2d.build_forest_rows(jnp.asarray(cdfs), m=m)
    got = build_forest_rows(cdfs, m, device="cpu")
    assert (got.rows, got.width, got.m) == (want.rows, want.width, want.m)
    for k in _FIELDS:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    validate_forest_rows(got)


@pytest.mark.parametrize("seed,R,W,m", _CASES)
def test_sample_forest_rows_elementwise_equal_to_jax(seed, R, W, m):
    """Elementwise equal to the reference's descent, and an inverse within
    each row (ties are zero-width intervals, equivalent)."""
    rng, cdfs = _cdfs(seed, R, W)
    jf = jax_forest2d.build_forest_rows(jnp.asarray(cdfs), m=m)
    f = build_forest_rows(cdfs, m, device="cpu")
    rows = rng.integers(0, R, 512).astype(np.int32)
    xi = rng.random(512).astype(np.float32)
    got = sample_forest_rows(f, rows, xi).numpy()
    want = np.asarray(jax_forest2d.sample_forest_rows(jf, jnp.asarray(rows), jnp.asarray(xi)))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    ref = np_reference_rows(cdfs, rows, xi)
    mism = got != ref
    assert all(cdfs[rows[i]][got[i]] == cdfs[rows[i]][ref[i]] for i in np.where(mism)[0])
    assert np.all(cdfs[rows, got] <= xi) and np.all(xi < cdfs[rows, got + 1] + 1e-7)


def test_sample_forest_rows_compares_against_clamped_lower_bounds():
    """A row whose trailing weights are zero has lower bounds of exactly 1.0,
    clamped to 1 - 2^-24 in the flat forest's ``data``: a uniform of
    1 - 2^-24 lands on the last (zero-width) interval there, as in the
    reference, while the batched view over the unclamped CDF rows (the
    pool's, like a single build) returns the last live interval."""
    _, cdfs = _cdfs(9, 3, 20, zero_tail=4)
    f = build_forest_rows(cdfs, 8, device="cpu")
    jf = jax_forest2d.build_forest_rows(jnp.asarray(cdfs), m=8)
    xi = np.full(6, 1 - 2**-24, np.float32)
    xi[3:] = [0.0, 0.5, 0.999]
    rows = np.zeros(6, np.int32)
    got = sample_forest_rows(f, rows, xi).numpy()
    want = np.asarray(jax_forest2d.sample_forest_rows(jf, jnp.asarray(rows), jnp.asarray(xi)))
    assert np.array_equal(got, want) and got[0] == 19
    bf = batched_from_row_forest(f, cdfs)
    from repro_torch.kernels import ops

    pool = ops.forest_sample_batched(bf, torch.as_tensor(rows), torch.as_tensor(xi)).numpy()
    single = sample_forest(forest_from_cdf(cdfs[0], 8, device="cpu"), xi, device="cpu").numpy()
    assert np.array_equal(pool, single) and pool[0] == 15


@pytest.mark.parametrize("seed,R,W,m", _CASES)
def test_batched_from_row_forest_bit_equal(seed, R, W, m):
    """Equal to the reference's rewrap, and row ``r`` equal to the single
    build of row ``r``, fallback flags included."""
    _, cdfs = _cdfs(seed, R, W, power=12, zero_tail=2)
    f = build_forest_rows(cdfs, m, device="cpu")
    got = batched_from_row_forest(f, cdfs)
    jf = jax_forest2d.build_forest_rows(jnp.asarray(cdfs), m=m)
    want = jax_batched_from_row_forest(jf, jnp.asarray(cdfs))
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype and np.array_equal(a.numpy(), np.asarray(b))
    for r in range(R):
        single = forest_from_cdf(cdfs[r], m, device="cpu")
        for a, b in zip(got.row(r), single):
            assert torch.equal(a, b), r


def test_build_forest_rows_flags_degenerate_rows_like_single_builds():
    """Tied rows flag cells for the fallback bisection exactly where their
    single builds do."""
    cdfs = []
    for r in range(4):
        w = np.zeros(300)
        w[50 * r + 10] = 1.0
        cdfs.append(np_build_cdf(normalize_weights(w + 1e-12)))
    cdfs = np.stack(cdfs)
    f = build_forest_rows(cdfs, 16, device="cpu")
    assert bool(f.fallback.any())
    for r in range(4):
        single = forest_from_cdf(cdfs[r], 16, device="cpu")
        assert torch.equal(f.fallback[r * 16:(r + 1) * 16], single.fallback)
    xi = np.random.default_rng(0).random(2048).astype(np.float32)
    rows = np.repeat(np.arange(4), 512).astype(np.int32)
    got = sample_forest_rows(f, rows, xi).numpy()
    assert np.all(cdfs[rows, got] <= xi) and np.all(xi < cdfs[rows, got + 1])


def test_validate_forest_rows_raises_on_corruption():
    _, cdfs = _cdfs(11, 4, 40)
    f = build_forest_rows(cdfs, 4, device="cpu")
    validate_forest_rows(f)
    tree = int(torch.nonzero(f.table >= 0)[0, 0])
    for field, k, value in (("table", tree, int(f.table[tree]) + 1),
                            ("table", 0, ~(f.width + 1)),
                            ("right", int(f.table[tree]), ~0)):
        arr = getattr(f, field).clone()
        arr[k] = value
        with pytest.raises(AssertionError):
            validate_forest_rows(f._replace(**{field: arr}))


def test_multirow_matches_per_row_build():
    rng = np.random.default_rng(3)
    R, W, m = 5, 33, 16
    img = rng.random((R, W)) ** 4 + 1e-9
    cdfs = np.stack([np_build_cdf(normalize_weights(r)) for r in img])
    f2 = build_forest_rows(cdfs, m, device="cpu")
    xi = rng.random(1024).astype(np.float32)
    for r in range(R):
        a = sample_forest(forest_from_cdf(cdfs[r], m, device="cpu"), xi, device="cpu").numpy()
        b = sample_forest_rows(f2, np.full(len(xi), r, np.int32), xi).numpy()
        assert np.array_equal(a, b) or np.all(cdfs[r][a] == cdfs[r][b])


def test_forest2d_distribution_preserved_chi2():
    rng = np.random.default_rng(11)
    R, W, m = 8, 48, 32
    img = rng.random((R, W)) ** 2 + 0.05
    cdfs = np.stack([np_build_cdf(normalize_weights(r)) for r in img])
    f = build_forest_rows(cdfs, m, device="cpu")
    per_row = 1 << 13
    rows = np.repeat(np.arange(R), per_row).astype(np.int32)
    xi = rng.random(R * per_row).astype(np.float32)
    cols = sample_forest_rows(f, rows, xi).numpy()
    chi2 = 0.0
    for r in range(R):
        counts = np.bincount(cols[r * per_row:(r + 1) * per_row], minlength=W)
        expected = np.diff(cdfs[r]) * per_row
        chi2 += float(np.sum((counts - expected) ** 2 / np.maximum(expected, 1e-9)))
    # dof = R*(W-1) = 376: mean 376, sd ~27.4; 650 is a ~10-sigma guard
    assert chi2 < 650, chi2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forest2d_marginal_conditional_consistency(seed):
    """Row from the marginal forest, column from the row forests: each stage
    brackets its uniform, and for a fixed row the column is monotone in v."""
    rng = np.random.default_rng(seed)
    R, W = 2 + 4 * seed, 8 + 12 * seed
    img = rng.random((R, W)) ** 3 + 1e-9
    marg = build_forest(normalize_weights(img.sum(axis=1)), 16, device="cpu")
    cond = np.stack([np_build_cdf(normalize_weights(r)) for r in img])
    f2 = build_forest_rows(cond, 8, device="cpu")
    B = 128
    xi_r = rng.random(B).astype(np.float32)
    xi_c = np.sort(rng.random(B).astype(np.float32))
    rows = sample_forest(marg, xi_r, device="cpu")
    mc = marg.cdf.numpy()
    r = rows.numpy()
    assert np.all(mc[r] <= xi_r) and np.all(xi_r < mc[r + 1])
    cols = sample_forest_rows(f2, rows, xi_c).numpy()
    assert np.all(cond[r, cols] <= xi_c) and np.all(xi_c < cond[r, cols + 1] + 1e-7)
    fixed = sample_forest_rows(f2, np.full(B, r[0], np.int32), xi_c).numpy()
    assert np.all(np.diff(fixed) >= 0)


def test_forest2d_depth_bound():
    """Per-cell depth is O(log overlap): the flat build's rows equal single
    builds, whose depth stays under 2*log2(o_max) + 5."""
    rng = np.random.default_rng(5)
    R, W, m = 6, 64, 4
    img = rng.random((R, W)) ** 6 + 1e-7
    cdfs = np.stack([np_build_cdf(normalize_weights(r)) for r in img])
    bf = batched_from_row_forest(build_forest_rows(cdfs, m, device="cpu"), cdfs)
    for r in range(R):
        ds = depth_stats(bf.row(r))
        data = cdfs[r][:-1]
        cells = np.clip(np.floor(data * np.float32(m)).astype(int), 0, m - 1)
        o_max = int(np.bincount(cells, minlength=m).max()) + 1
        bound = 2 * int(np.ceil(np.log2(max(o_max, 2)))) + 5
        assert ds["max_depth"] <= bound < o_max, (r, ds["max_depth"], o_max)
