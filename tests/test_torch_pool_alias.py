"""The port's packed-alias path and pool restore against the JAX package.

The batched alias build sums in a fixed order, and summation order sets the
bits off the dyadic grid, so it is held bit for bit to JAX's row core and
to the host ``build_alias_parallel`` on dyadic rows, and to validity and
mass conservation on every row. The drain is held elementwise to the
float32 numpy oracle. A JAX pool snapshotted and restored into the port
drains elementwise equal to the JAX pool, across updates and evictions.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.alias import build_alias_parallel as jax_build_alias_parallel
from repro.core.alias import np_sample_alias_f32 as jax_np_sample_alias_f32
from repro.core.cdf import normalize_weights
from repro.kernels.alias_build import alias_split_pack_rows
from repro.pool import ForestPool as JaxPool
from repro.serve.sampler import DeviceQmcStreams as JaxDeviceQmcStreams
from repro_torch.core.alias import (
    ALIAS_FRAC_MAX,
    build_alias_parallel,
    np_sample_alias_f32,
)
from repro_torch.interop import handle_from_numpy, pool_from_snapshot
from repro_torch.kernels.alias_build import alias_build_batched
from repro_torch.kernels.alias_sample import alias_sample_batched
from repro_torch.pool import ForestPool
from repro_torch.robust.errors import QuarantinedError, StaleHandleError
from repro_torch.serve.sampler import DeviceQmcStreams

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

_jax_pack_rows = jax.jit(alias_split_pack_rows)

_FAMILIES = ("uniform", "powerlaw", "ties", "zeros", "spike")


def _family_weights(kind: str, n: int, rng) -> np.ndarray:
    """The weight families of the JAX pool suite."""
    if kind == "uniform":
        return rng.random(n).astype(np.float32) + np.float32(1e-3)
    if kind == "powerlaw":
        return (rng.random(n).astype(np.float32) ** 8) + np.float32(1e-9)
    if kind == "ties":
        base = rng.random(max(n // 4, 1)).astype(np.float32) + np.float32(1e-3)
        return base[rng.integers(0, len(base), n)]
    if kind == "zeros":
        w = rng.random(n).astype(np.float32)
        w[rng.random(n) < 0.5] = 0.0
        w[rng.integers(0, n)] = 1.0
        return w
    w = np.full(n, 1e-7, np.float32)
    w[rng.integers(0, n)] = 1.0
    return w


def _dyadic(n: int, rng) -> np.ndarray:
    """Integer weights in [1, 8) with a power-of-two total: n*p and every
    partial sum of the alias tapes and of the CDF is exact in float32, so
    any summation order gives the same bits."""
    c = rng.integers(1, 8, n)
    extra = (1 << int(np.ceil(np.log2(c.sum())))) - c.sum()
    np.add.at(c, rng.integers(0, n, extra), 1)
    return c.astype(np.float64)


def _mass(q, alias) -> np.ndarray:
    m = np.asarray(q, np.float64).copy()
    np.add.at(m, np.asarray(alias), 1.0 - np.asarray(q, np.float64))
    return m


_DYADIC_ROWS = [
    np.array([0.25, 0.25, 0.5, 1.0]),
    np.array([1.0, 0.5, 0.25, 0.25]),
    np.array([0.5, 1.0, 0.5, 2.0]),  # zero-surplus heavy at npi == 1
    np.array([2.0, 1.0, 0.5, 0.5]),
]


@pytest.mark.parametrize("n", [4, 8, 24, 256])
def test_alias_build_plain_bit_exact_on_dyadics(n):
    rng = np.random.default_rng(n)
    rows = _DYADIC_ROWS if n == 4 else [_dyadic(n, rng) for _ in range(6)]
    W = np.stack(rows).astype(np.float32)
    q, a = alias_build_batched(torch.from_numpy(W))
    jq, ja = _jax_pack_rows(jnp.asarray(W))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(a.numpy(), np.asarray(ja))
    for b, w in enumerate(rows):
        host = jax_build_alias_parallel(w)
        assert np.array_equal(q[b].numpy(), np.asarray(host.q)), b
        assert np.array_equal(a[b].numpy(), np.asarray(host.alias)), b
        ported = build_alias_parallel(w, device="cpu")
        assert torch.equal(ported.q, q[b]) and torch.equal(ported.alias, a[b])


@pytest.mark.parametrize("kind", _FAMILIES)
def test_alias_build_plain_valid_and_mass_conserving(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    for n, B in ((2, 3), (3, 2), (33, 4), (160, 4)):
        W = np.stack([normalize_weights(_family_weights(kind, n, rng)) for _ in range(B)])
        q, a = (x.numpy() for x in alias_build_batched(torch.from_numpy(W)))
        assert np.all((q >= 0.0) & (q <= 1.0)) and np.all((a >= 0) & (a < n))
        for b in range(B):
            npi = W[b].astype(np.float64) / W[b].sum(dtype=np.float64) * n
            np.testing.assert_allclose(_mass(q[b], a[b]), npi, rtol=2e-4, atol=_atol(n))


def _atol(n: int) -> float:
    """Mass tolerance: the JAX suite's 2e-4, plus the row's normalization
    residue (float32 n*p sum to n only to a few ulps of n, and the cells at
    the tapes' ends absorb it)."""
    return 2e-4 + n * 2.0**-22


def test_alias_build_plain_conserves_mass_at_65536():
    """Rows of the pool's largest class: with float32 tapes (the JAX core)
    ties between rounded tape values misroute whole cells here; the port's
    float64 tapes keep every cell's mass. Both builds run on the same rows,
    and the JAX core's errors are asserted too, so the fault the port
    departs from is shown by the reference itself."""
    rng = np.random.default_rng(65537)
    n = 1 << 16
    W = (rng.random((3, n)) ** 6 + 1e-9).astype(np.float32)
    W[0, n // 2:] = 0.0
    W[1] = 1.0
    q, a = (x.numpy() for x in alias_build_batched(torch.from_numpy(W)))
    jq, ja = (np.asarray(x) for x in _jax_pack_rows(jnp.asarray(W)))
    assert np.all((q >= 0.0) & (q <= 1.0)) and np.all((a >= 0) & (a < n))
    for b in range(3):
        npi = W[b].astype(np.float64) / W[b].sum(dtype=np.float64) * n
        np.testing.assert_allclose(_mass(q[b], a[b]), npi, rtol=2e-4, atol=_atol(n))
        jax_err = np.abs(_mass(jq[b], ja[b]) - npi)
        outside = jax_err > _atol(n) + 2e-4 * np.abs(npi)
        if b == 1:  # uniform row: exact in float32 too
            assert not outside.any()
        else:  # misrouted cells, each off by most of a cell's mass
            assert outside.any() and jax_err.max() > 0.5, (b, jax_err.max())


def test_alias_build_zero_padded_cells_unreachable():
    w = np.pad(np.array([0.3, 0.5, 0.2], np.float32), (0, 5))
    q, a = (x[0].numpy() for x in alias_build_batched(torch.from_numpy(w[None])))
    assert np.all(q[3:] == 0.0)
    assert not np.any(np.isin(a, np.arange(3, 8)) & (q < 1.0))
    xi = np.linspace(0, 1, 4097, dtype=np.float32)[:-1]
    assert np.all(np_sample_alias_f32(q, a, xi) < 3)


@pytest.mark.parametrize("n", [1, 31, 2047, 2048, 2049, 4096, 40000, 65536, 65537])
def test_alias_build_plain_at_tile_edges(n):
    """The plain version at the kernel's tile edges (2048 cells a tile):
    bit-equal to the host build on a dyadic row; valid and mass-conserving
    on a power-law row whose last quarter is zero padding, the padding at
    q == 0 and never an alias target."""
    rng = np.random.default_rng(n)
    dy = _dyadic(n, rng)
    q, a = alias_build_batched(torch.from_numpy(dy.astype(np.float32)[None]))
    host = build_alias_parallel(dy, device="cpu")
    assert torch.equal(q[0], host.q) and torch.equal(a[0], host.alias)
    w = (rng.random(n) ** 6 + 1e-9).astype(np.float32)
    real = n - n // 4
    w[real:] = 0.0
    q, a = (x[0].numpy() for x in alias_build_batched(torch.from_numpy(w[None])))
    assert np.all((q >= 0.0) & (q <= 1.0)) and np.all((a >= 0) & (a < n))
    npi = w.astype(np.float64) / w.sum(dtype=np.float64) * n
    np.testing.assert_allclose(_mass(q, a), npi, rtol=2e-4, atol=_atol(n))
    assert np.all(q[real:] == 0.0) and not np.any((a >= real) & (q < 1.0))


def test_alias_build_plain_row_alone_equals_row_in_stack():
    """A row's table depends on the row and n alone: each row of a 7-row
    stack of non-dyadic rows equals the same row built alone."""
    rng = np.random.default_rng(11)
    n = 4099
    W = (rng.random((7, n)) ** 6 + 1e-9).astype(np.float32)
    W[3, n // 3:] = 0.0
    q, a = alias_build_batched(torch.from_numpy(W))
    for b in range(7):
        qb, ab = alias_build_batched(torch.from_numpy(W[b:b + 1]))
        assert torch.equal(qb[0], q[b]) and torch.equal(ab[0], a[b]), b


def test_alias_sample_plain_matches_f32_oracle():
    rng = np.random.default_rng(7)
    n = 32
    rows = [_family_weights("uniform", n, rng), np.ones(n, np.float32),
            _family_weights("ties", n, rng), _family_weights("spike", n, rng),
            _family_weights("zeros", n, rng)]
    W = np.stack([normalize_weights(r) for r in rows])
    q, a = alias_build_batched(torch.from_numpy(W))
    Q = 2000
    did = rng.integers(-1, len(rows), Q).astype(np.int32)
    xi = rng.random(Q).astype(np.float32)
    xi[:4] = [0.0, ALIAS_FRAC_MAX, 1.0, 0.5]
    qn, an = q.numpy(), a.numpy()
    want = np.array([jax_np_sample_alias_f32(qn[d], an[d], np.array([x]))[0] if d >= 0 else 0
                     for d, x in zip(did, xi)], np.int32)
    for co in (True, False):
        got = alias_sample_batched(q, a, torch.from_numpy(did), torch.from_numpy(xi),
                                   coalesce=co).numpy()
        assert np.array_equal(got, want), co


def _mixed_jax_pool(rng):
    """Eight tenants over four (method, size class) groups, one of them
    tied (fallback cells). Few groups keep JAX's compiles few."""
    pool = JaxPool(min_class=8)
    sizes = (3, 5, 7, 8, 40, 33, 60, 64)
    methods = ["forest", "alias"] * 4
    tenants = [_family_weights(k, s, rng) for k, s in zip(_FAMILIES * 2, sizes)]
    tenants[4] = np.zeros(40, np.float32)
    tenants[4][20] = 1.0
    return pool, pool.insert_many(tenants, method=methods)


def _as_lists(state):
    """The snapshot as a checkpoint round trip returns it: sets as lists."""
    state = dict(state, quarantined=[list(k) for k in state["quarantined"]])
    state["classes"] = {int(k): dict(d, degenerate_rows=sorted(d["degenerate_rows"]))
                        for k, d in state["classes"].items()}
    return state


@pytest.mark.parametrize("lists", [False, True])
def test_jax_pool_restored_into_port_drains_equal(lists):
    rng = np.random.default_rng(41)
    jp, jh = _mixed_jax_pool(rng)
    state = jp.snapshot()
    pp = pool_from_snapshot(_as_lists(state) if lists else state, device="cpu")
    ph = [handle_from_numpy(h) for h in jh]
    assert ph == [tuple(h) for h in jh]
    jstreams = JaxDeviceQmcStreams(32, seed=3)
    pstreams = DeviceQmcStreams.restore(jstreams.snapshot(), device="cpu")

    def drains(label):
        Q = 1500
        pick = rng.integers(0, len(jh), Q)
        xi = rng.random(Q).astype(np.float32)
        want = jp.sample([jh[i] for i in pick], xi, use_pallas=False)
        for co in (True, False):
            got = pp.sample([ph[i] for i in pick], xi, coalesce=co)
            assert np.array_equal(got, want), (label, co)
        slots = rng.integers(0, 32, Q)
        want, wxi = jp.sample_streams([jh[i] for i in pick], slots, jstreams,
                                      use_pallas=False, return_xi=True)
        got, gxi = pp.sample_streams([ph[i] for i in pick], slots, pstreams, return_xi=True)
        assert np.array_equal(got, want), label
        assert np.array_equal(gxi.view(np.uint32), np.asarray(wxi).view(np.uint32))

    drains("restored")
    # churn on both: dyadic updates (same bits in either package) and a
    # bit-identical one that skips, evictions, re-inserts into freed rows
    for i in (1, 4):
        w = _dyadic(jh[i].n, rng)
        for pool, h in ((jp, jh[i]), (pp, ph[i])):
            pool.update_weights(h, w)
            pool.update_weights(h, w * 4.0)
    for i in (2, 7):
        jp.evict(jh[i])
        pp.evict(ph[i])
        with pytest.raises(StaleHandleError):
            pp.sample([ph[i]], [0.5])
    fresh = [_dyadic(n, rng) for n in (6, 63)]
    methods = ["forest", "alias"]
    new_j = jp.insert_many(fresh, method=methods)
    new_p = pp.insert_many(fresh, method=methods)
    assert new_p == [tuple(h) for h in new_j]
    for i, hj, hp in zip((2, 7), new_j, new_p):
        jh[i], ph[i] = hj, hp
    drains("churned")
    assert pp.stats() == jp.stats()


def test_quarantine_state_carries_across():
    rng = np.random.default_rng(43)
    jp = JaxPool(policy="quarantine")
    bad = rng.random(7)
    bad[3] = np.nan
    jh = jp.insert_many([rng.random(6) + 1e-3, bad], method=["forest", "alias"])
    pp = ForestPool.restore(jp.snapshot(), device="cpu")
    ph = [handle_from_numpy(h) for h in jh]
    assert not pp.is_quarantined(ph[0]) and pp.is_quarantined(ph[1])
    with pytest.raises(QuarantinedError):
        pp.weights(ph[1])
    assert pp.stats()["quarantined"] == 1 and pp.policy == "quarantine"
    pp.update_weights(ph[1], rng.random(7) + 1e-3)  # a clean update clears it
    assert not pp.is_quarantined(ph[1])
