"""The port's forest pool against the JAX package's (plain versions, CPU).

Tree topology is a function of the CDF bits and the port's scan does not
reproduce XLA's reassociation, so the batched build is held bit for bit to
JAX's when fed JAX's CDFs; the port's own batched build is held bit for bit
to its single build, row by row. Descents are elementwise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.cdf import build_cdf as jax_build_cdf
from repro.core.cdf import normalize_weights
from repro.kernels import ref as jax_ref
from repro.kernels.alias_sample import alias_sample_batched as jax_alias_sample_batched
from repro.kernels.forest_sample import forest_sample_batched as jax_forest_sample_batched
from repro.pool import build_forest_batched_from_cdf as jax_batched_from_cdf
from repro_torch.core import build_forest, forest_to_numpy, validate_forest
from repro_torch.core.sample import sample_forest
from repro_torch.kernels import groups, ops
from repro_torch.kernels.alias_build import alias_build_batched
from repro_torch.kernels.alias_sample import alias_sample_grouped
from repro_torch.kernels.forest_sample import forest_sample_batched, forest_sample_grouped
from repro_torch.pool import (
    BatchedForest,
    ForestPool,
    build_forest_batched,
    build_forest_batched_from_cdf,
)
from repro_torch.robust.errors import StaleHandleError
from repro_torch.serve.sampler import DeviceQmcStreams

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

# Jitted oracles: one compile per shape instead of op-by-op dispatch.
_jax_cdf_rows = jax.jit(jax.vmap(jax_build_cdf))
_jax_ref_batched = jax.jit(jax_ref.ref_forest_sample_batched)

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


def _tied(n: int) -> np.ndarray:
    """A degenerate row: all mass on one interior leaf, exact ties around."""
    w = np.zeros(n, np.float32)
    w[n // 2] = 1.0
    return w


def _padded_stack(tenants, size):
    return np.stack([np.pad(normalize_weights(np.asarray(w, np.float64)),
                            (0, size - len(w))) for w in tenants])


@pytest.mark.parametrize("kind", _FAMILIES)
@pytest.mark.parametrize("sizes,m", [((1, 1), 1), ((3, 5, 7, 8), 8),
                                     ((17, 64, 40, 100), 32)])
def test_batched_from_jax_cdf_bit_identical(kind, sizes, m):
    """Ragged tenants padded into one class; fed the JAX CDFs, the port's
    flat batched build equals JAX's vmapped build in all six arrays."""
    rng = np.random.default_rng(len(sizes) * 1000 + sum(sizes))
    size = 1 << max(int(np.ceil(np.log2(max(sizes)))), 0)
    W = _padded_stack([_family_weights(kind, s, rng) for s in sizes], size)
    cdf = np.asarray(_jax_cdf_rows(jnp.asarray(W, jnp.float32)))
    want = jax_batched_from_cdf(jnp.asarray(cdf), m)
    got = build_forest_batched_from_cdf(torch.from_numpy(cdf), m, device="cpu")
    for k, a, b in zip(BatchedForest._fields, got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), k


@pytest.mark.parametrize("kind", _FAMILIES)
def test_batched_build_rows_equal_single_builds(kind):
    rng = np.random.default_rng(hash(kind) % 2**32)
    for n, B, m in ((1, 3, 1), (8, 4, 8), (96, 5, 96), (96, 3, 7)):
        W = np.stack([normalize_weights(_family_weights(kind, n, rng)) for _ in range(B)])
        bf = build_forest_batched(W, m, device="cpu")
        assert (bf.batch, bf.n, bf.m) == (B, n, m)
        for b in range(B):
            single = build_forest(W[b], m, device="cpu")
            for k, a, s in zip(BatchedForest._fields, bf.row(b), single):
                assert torch.equal(a, s), (n, m, b, k)
        validate_forest(bf.row(B - 1))


@pytest.mark.parametrize("B,n,m", [(1, 8, 8), (5, 64, 32), (3, 300, 300)])
def test_forest_sample_batched_plain_matches_jax_ref(B, n, m):
    """Mixed (dist_id, uniform) lanes with a tied (fallback) row, sentinel
    lanes and out-of-range ids: elementwise equal to JAX's
    ref_forest_sample_batched and to the per-row single descent."""
    rng = np.random.default_rng(B * n + m)
    W = np.stack([normalize_weights(_family_weights("powerlaw", n, rng)) for _ in range(B)])
    if B > 1:
        W[B - 1] = _tied(n)
    cdf = np.asarray(_jax_cdf_rows(jnp.asarray(W, jnp.float32)))
    # the port's build from JAX's CDF bits equals JAX's (test above)
    pf = build_forest_batched_from_cdf(torch.from_numpy(cdf), m, device="cpu")
    jf = BatchedForest(*(jnp.asarray(x.numpy()) for x in pf))
    Q = 3000
    did = rng.integers(-1, B + 1, Q).astype(np.int32)  # B: clamped to B-1
    xi = rng.random(Q).astype(np.float32)
    xi[:3] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5]
    want = np.asarray(_jax_ref_batched(
        jf.cdf, jf.table, jf.left, jf.right, jnp.asarray(did), jnp.asarray(xi),
        jf.cell_first, jf.fallback))
    for co in (True, False):
        got = ops.forest_sample_batched(pf, torch.from_numpy(did),
                                        torch.from_numpy(xi), coalesce=co).numpy()
        assert np.array_equal(got, want), co
    did = np.minimum(did, B - 1)
    assert np.all(got[did < 0] == 0)
    for b in range(B):
        sel = did == b
        single = sample_forest(pf.row(b), torch.from_numpy(xi[sel]), device="cpu")
        assert np.array_equal(got[sel], single.numpy())


def test_sentinel_lanes_never_read_a_row():
    """Sentinel lanes resolve to 0 even when the only row is garbage: a
    lane that read it would index out of range or loop."""
    n, m = 16, 16
    bad = BatchedForest(
        cdf=torch.full((1, n + 1), float("nan")),
        table=torch.full((1, m), 10**9, dtype=torch.int32),
        left=torch.zeros((1, n), dtype=torch.int32),
        right=torch.zeros((1, n), dtype=torch.int32),
        cell_first=torch.zeros((1, m + 1), dtype=torch.int32),
        fallback=torch.zeros((1, m), dtype=torch.bool))
    did = torch.full((64,), -1, dtype=torch.int32)
    xi = torch.rand(64, generator=torch.Generator().manual_seed(0))
    for co in (True, False):
        assert torch.equal(forest_sample_batched(*bad, did, xi, coalesce=co),
                           torch.zeros(64, dtype=torch.int32))


def test_pool_ragged_insert_rows_equal_single_builds():
    rng = np.random.default_rng(3)
    pool = ForestPool(device="cpu")
    tenants = [_family_weights(k, s, rng) for k, s in
               zip(_FAMILIES * 2, (3, 8, 9, 40, 100, 1, 30, 64, 65, 7))]
    handles = pool.insert_many(tenants)
    for h, w in zip(handles, tenants):
        assert h.size_class >= max(len(w), pool.min_class)
        padded = _padded_stack([w], h.size_class)[0]
        want = build_forest(padded, pool.classes[h.size_class].m, device="cpu")
        for k, a, b in zip(BatchedForest._fields, pool.forest_row(h), want):
            assert torch.equal(a, b), (h, k)


def test_slot_handle_invariants():
    """Rows recycle through the free list with a version bump; every
    stale-handle operation raises; arenas grow on demand."""
    rng = np.random.default_rng(7)
    pool = ForestPool(init_rows=2, device="cpu")
    h = [pool.insert(rng.random(12) + 1e-3) for _ in range(5)]
    sc = pool.classes[16]
    assert sc.rows == 8 and sc.grows == 2 and sc.forest.cdf.shape == (8, 17)
    assert pool.stats()["tenants"] == 5
    pool.evict(h[1])
    for op in (lambda: pool.evict(h[1]),
               lambda: pool.sample([h[1]], [0.5]),
               lambda: pool.update_weights(h[1], rng.random(12)),
               lambda: pool.forest_row(h[1])):
        with pytest.raises(StaleHandleError):
            op()
    h2 = pool.insert(rng.random(9) + 1e-3)
    assert h2.row == h[1].row and h2.version == h[1].version + 1
    out = pool.sample([h2] * 64, rng.random(64))
    assert np.all((0 <= out) & (out < 9))
    for bad in (dict(weights=rng.random(13)), dict(delta=np.zeros(1)),
                dict(delta=np.zeros(16)), dict(weights=rng.random(12), delta=np.zeros(12)),
                dict()):
        with pytest.raises(ValueError):
            pool.update_weights(h[0], **bad)


def test_update_weights_equals_fresh_build_and_skips():
    rng = np.random.default_rng(11)
    pool = ForestPool(device="cpu")
    h = pool.insert(rng.random(40) + 1e-3)
    sc = pool.classes[h.size_class]

    def fresh(raw):
        padded = _padded_stack([raw], h.size_class)[0]
        return build_forest(padded, sc.m, device="cpu")

    w1 = rng.random(40) + 1e-3
    pool.update_weights(h, w1)
    for a, b in zip(pool.forest_row(h), fresh(w1)):
        assert torch.equal(a, b)
    assert sc.delta_rebuilds == 1
    pool.update_weights(h, w1 * 2.0)  # normalizes away: no bit moves
    assert sc.delta_skips == 1 and sc.delta_rebuilds == 1
    d = np.zeros(40)
    d[3] = 0.5
    pool.update_weights(h, delta=d)
    for a, b in zip(pool.forest_row(h), fresh(w1 * 2.0 + d)):
        assert torch.equal(a, b)
    assert sc.delta_rebuilds == 2


def test_evicting_degenerate_tenant_clears_fallback_flags():
    rng = np.random.default_rng(23)
    pool = ForestPool(device="cpu")
    h_ok = pool.insert(rng.random(16) + 1e-3)
    h_deg = pool.insert(_tied(16))
    sc = pool.classes[16]
    assert bool(sc.forest.fallback.any()) and sc.degenerate_rows == {h_deg.row}
    pool.evict(h_deg)
    assert not bool(sc.forest.fallback.any()) and not sc.degenerate_rows
    out = pool.sample([h_ok] * 32, rng.random(32))
    assert np.all((0 <= out) & (out < 16))


def test_drains_after_evicting_deep_tied_row():
    """After a deep tied-chain tenant is evicted (its fallback flags
    cleared, its chain left in the stack), drains of the co-tenants are
    unchanged: no lane is routed into the freed row."""
    rng = np.random.default_rng(29)
    pool = ForestPool(device="cpu")
    chain = np.asarray([2.0 ** -(i + 1) for i in range(30)] + [2.0 ** -30])
    hs = pool.insert_many([rng.random(20) + 1e-3, chain, rng.random(31) + 1e-3])
    xi = rng.random(200).astype(np.float32)
    lanes = [hs[0], hs[2]] * 100
    before = pool.sample(lanes, xi)
    pool.evict(hs[1])
    assert np.array_equal(pool.sample(lanes, xi), before)
    with pytest.raises(StaleHandleError):
        pool.sample([hs[1]], xi[:1])


def test_mixed_batch_chi_square():
    rng = np.random.default_rng(13)
    pool = ForestPool(device="cpu")
    ps = [normalize_weights(rng.random(n) ** 2 + 1e-3) for n in (6, 16, 40)]
    handles = pool.insert_many(ps)
    per = 1 << 13
    order = rng.permutation(per * len(ps))
    qh = np.repeat(np.arange(len(ps)), per)[order]
    out = pool.sample([handles[t] for t in qh], rng.random(len(qh)).astype(np.float32))
    for t, p in enumerate(ps):
        counts = np.bincount(out[qh == t], minlength=len(p))
        expected = p.astype(np.float64) * per
        chi2 = float(np.sum((counts - expected) ** 2 / np.maximum(expected, 1e-9)))
        assert chi2 < len(p) + 8 * np.sqrt(2 * len(p)), (t, chi2)


def test_pool_snapshot_roundtrip_on_port():
    rng = np.random.default_rng(31)
    pool = ForestPool(device="cpu")
    hs = pool.insert_many([rng.random(n) + 1e-3 for n in (5, 12, 40)],
                          method=["forest", "alias", "forest"])
    back = ForestPool.restore(pool.snapshot(), device="cpu")
    xi = rng.random(300).astype(np.float32)
    lanes = [hs[i] for i in rng.integers(0, 3, 300)]
    assert np.array_equal(back.sample(lanes, xi), pool.sample(lanes, xi))
    assert forest_to_numpy(back.forest_row(hs[0]))["cdf"].tolist() == \
        forest_to_numpy(pool.forest_row(hs[0]))["cdf"].tolist()


def _mixed_classes(rng):
    """Forest stacks of three classes (8, 32, 128 leaves; the last row of
    each tied, with flagged cells) and alias stacks of two (16, 64), built
    from JAX's CDF bits; and a drain's lanes over them: forest groups 0-2,
    alias groups 3-4, rows -1 (sentinel) .. B (clamped), clip bounds below
    each class's size."""
    forests, tables = [], []
    for n, B in ((8, 2), (32, 3), (128, 2)):
        W = np.stack([normalize_weights(_family_weights("powerlaw", n, rng)) for _ in range(B)])
        W[-1] = _tied(n)
        cdf = np.asarray(_jax_cdf_rows(jnp.asarray(W, jnp.float32)))
        forests.append(build_forest_batched_from_cdf(torch.from_numpy(cdf), n, device="cpu"))
    for n in (16, 64):
        W = (rng.random((3, n)) ** 4 + 1e-6).astype(np.float32)
        tables.append(alias_build_batched(torch.from_numpy(W)))
    sizes = [f.n for f in forests] + [t[0].shape[1] for t in tables]
    rows = [f.batch for f in forests] + [t[0].shape[0] for t in tables]
    Q = 700
    gid = rng.integers(0, len(sizes), Q).astype(np.int32)
    row = np.asarray([rng.integers(-1, rows[g] + 1) for g in gid], np.int32)
    hi = np.asarray([rng.integers(0, sizes[g]) for g in gid], np.int32)
    return forests, tables, gid, row, hi


def _jax_groups_clipped(forests, tables, gid, row, hi, xi):
    """The JAX package's kernels (interpret mode) group by group, each
    result clipped to its lane's bound as ``repro.pool.ForestPool`` clips
    a drain."""
    want = np.full(len(gid), -7, np.int32)
    for g, f in enumerate(forests):
        sel = gid == g
        jf = [jnp.asarray(t.numpy()) for t in f]
        idx = jax_forest_sample_batched(jf[0], jf[1], jf[2], jf[3], jnp.asarray(row[sel]),
                                        jnp.asarray(xi[sel]), jf[4], jf[5], interpret=True)
        want[sel] = np.minimum(np.asarray(idx), hi[sel])
    for a, t in enumerate(tables):
        sel = gid == len(forests) + a
        idx = jax_alias_sample_batched(jnp.asarray(t[0].numpy()), jnp.asarray(t[1].numpy()),
                                       jnp.asarray(row[sel]), jnp.asarray(xi[sel]),
                                       interpret=True)
        want[sel] = np.minimum(np.asarray(idx), hi[sel])
    return want


def _grouped_cpu(forests, tables, lanes, xi, coalesce):
    out = torch.full((lanes[0].shape[0],), -7, dtype=torch.int32)
    forest_sample_grouped([tuple(f) for f in forests], *lanes, out, xi=xi, coalesce=coalesce)
    alias_sample_grouped(list(tables), *lanes, out, xi, g0=len(forests), coalesce=coalesce)
    return out.numpy()


def test_grouped_plain_matches_jax_kernels_clipped():
    """One B5 launch over three forest classes and one B8 launch over two
    alias classes (the grouped plain versions) equal the JAX package's
    forest_sample_batched and alias_sample_batched run group by group and
    clipped per lane, with tied rows, sentinel and out-of-range rows;
    coalesced or not."""
    rng = np.random.default_rng(41)
    forests, tables, gid, row, hi = _mixed_classes(rng)
    xi = rng.random(len(gid)).astype(np.float32)
    xi[:3] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5]
    want = _jax_groups_clipped(forests, tables, gid, row, hi, xi)
    lanes = tuple(torch.from_numpy(a) for a in (gid, row, hi))
    for co in (True, False):
        assert np.array_equal(_grouped_cpu(forests, tables, lanes, torch.from_numpy(xi), co), want)


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_group_cap_splits_launches_with_equal_results(cap, monkeypatch):
    """More groups than a launch holds: the wrappers launch once a
    ``GROUP_CAP`` groups, each with its own first group, and the drain is
    unchanged; a pool drain over five classes of each method too."""
    rng = np.random.default_rng(43)
    forests, tables, gid, row, hi = _mixed_classes(rng)
    xi = torch.from_numpy(rng.random(len(gid)).astype(np.float32))
    lanes = tuple(torch.from_numpy(a) for a in (gid, row, hi))
    want = _grouped_cpu(forests, tables, lanes, xi, False)
    pool = ForestPool(device="cpu")
    hs = pool.insert_many([rng.random(n) + 1e-3 for n in (5, 12, 40, 70, 200) * 2],
                          method=["forest"] * 5 + ["alias"] * 5)
    drain = [hs[i] for i in rng.integers(0, len(hs), 500)]
    pxi = rng.random(len(drain)).astype(np.float32)
    pool_want = pool.sample(drain, pxi)
    monkeypatch.setattr(groups, "GROUP_CAP", cap)
    assert np.array_equal(_grouped_cpu(forests, tables, lanes, xi, False), want)
    assert np.array_equal(pool.sample(drain, pxi), pool_want)


def test_group_descriptors_pack_the_live_stacks():
    """Each record holds the stack's base pointers and its (B, n, m); the
    sort key's bits cover every group's flat cell offsets and the group
    number, with the all-ones key left over; a stack that grows is packed
    at its new place."""
    rng = np.random.default_rng(47)
    forests, tables, *_ = _mixed_classes(rng)
    dims = [(f.batch, f.n, f.m) for f in forests]
    desc, flat_bits, end_bit = groups.pack([tuple(f) for f in forests], dims)
    assert desc.dtype.itemsize == 64 and len(desc) == 3
    for rec, f, d in zip(desc, forests, dims):
        assert list(rec["ptr"]) == [t.data_ptr() for t in f]
        assert (rec["B"], rec["n"], rec["m"]) == d
    assert flat_bits == max(int(B * m - 1).bit_length() for B, _n, m in dims)
    largest = (2 << flat_bits) | ((1 << flat_bits) - 1)  # group 2's last cell
    assert end_bit == flat_bits + 2 and largest < (1 << end_bit) - 1
    desc, _, _ = groups.pack([tuple(tables[0])], [(3, 16, 16)])
    assert list(desc[0]["ptr"][:2]) == [t.data_ptr() for t in tables[0]]
    assert not desc[0]["ptr"][2:].any()
    pool = ForestPool(init_rows=1, device="cpu")
    h = pool.insert(rng.random(12) + 1e-3)
    before = pool.classes[16].forest.cdf.data_ptr()
    pool.insert(rng.random(12) + 1e-3)  # the class grows: its stacks move
    f = pool.classes[16].forest
    assert f.cdf.data_ptr() != before
    desc, _, _ = groups.pack([tuple(f)], [(f.batch, f.n, f.m)])
    assert desc[0]["ptr"][0] == f.cdf.data_ptr()
    assert 0 <= pool.sample([h], [0.5])[0] < 12
    with pytest.raises(ValueError):
        groups.pack([tuple(f)] * (groups.GROUP_CAP + 1), [(f.batch, f.n, f.m)] * 33)


def test_drain_guard_screens_each_group_before_the_launch():
    """``guard=True`` leaves a clean drain unchanged and raises, before any
    launch, on a corrupted forest row or alias row of a touched class."""
    rng = np.random.default_rng(59)
    pool = ForestPool(device="cpu")
    hs = pool.insert_many([rng.random(n) + 1e-3 for n in (6, 40, 9, 70)],
                          method=["forest", "forest", "alias", "alias"])
    lanes = [hs[i] for i in rng.integers(0, 4, 200)]
    xi = rng.random(200).astype(np.float32)
    assert np.array_equal(pool.sample(lanes, xi, guard=True), pool.sample(lanes, xi))
    for h, field, bad in ((hs[1], "cdf", float("nan")), (hs[3], "q", 2.0)):
        stack = (pool.classes[h.size_class].forest if h.method == "forest"
                 else pool.alias_classes[h.size_class].table)
        getattr(stack, field)[h.row, 1] = bad
        with pytest.raises(ValueError, match=f"corrupted {h.method}"):
            pool.sample(lanes, xi, guard=True)
        streams = DeviceQmcStreams(8, seed=0, device="cpu")
        with pytest.raises(ValueError, match=f"corrupted {h.method}"):
            pool.sample_streams(lanes, rng.integers(0, 8, 200), streams, guard=True)
        getattr(stack, field)[h.row, 1] = 0.0 if field == "q" else 0.5
        pool.update_weights(h, rng.random(h.n) + 1e-3)
