"""The port's device QMC streams, stream-aware drain and pooled sampler
against the JAX package (plain versions, CPU).

Stream state is exact integer arithmetic, so offsets, counters and points
are held bit for bit to JAX's ``DeviceQmcStreams`` and to the host
``QmcStreams`` oracle, duplicate slots and churn included. The stream
drain's points are held bit for bit to ``qmc_point_np`` and its indices
elementwise to JAX's reference. A ``PooledForestSampler`` restored from a
JAX one gives equal next drains under QMC and PRNG streams.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.cdf import build_cdf as jax_build_cdf
from repro.core.cdf import normalize_weights
from repro.core.lds import qmc_offset_bits_np, qmc_point_np
from repro.kernels import ref as jax_ref
from repro.kernels.alias_sample import alias_sample_batched as jax_alias_sample_batched
from repro.kernels.forest_sample import (
    forest_sample_batched_streams as jax_forest_sample_batched_streams,
)
from repro.serve.sampler import DeviceQmcStreams as JaxDeviceQmcStreams
from repro.serve.sampler import PooledForestSampler as JaxPooledSampler
from repro.serve.sampler import QmcStreams as JaxQmcStreams
from repro_torch.interop import handle_from_numpy
from repro_torch.kernels.alias_build import alias_build_batched
from repro_torch.kernels.alias_sample import alias_sample_grouped
from repro_torch.kernels.forest_sample import (
    forest_sample_batched_streams,
    forest_sample_grouped,
)
from repro_torch.pool import BatchedForest, build_forest_batched_from_cdf
from repro_torch.serve.sampler import (
    DeviceQmcStreams,
    PooledForestSampler,
    QmcStreams,
    _stream_prepass,
)

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

_jax_ref_streams = jax.jit(jax_ref.ref_forest_sample_batched_streams)

_SCHEDULES = [
    [0, 1, 1, 2, 1, 7],      # one slot thrice in one drain
    [3, 3, 3, 3],            # a single slot, four occurrences
    [0, 1, 2, 3, 4, 5, 6, 7],
    [5],
    [7, 0, 7, 0, 7],         # interleaved duplicates
]


def _u32(t: torch.Tensor) -> np.ndarray:
    """The uint32 values held in an int32 bit view."""
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


def test_device_streams_bit_equal_jax_and_host():
    port = DeviceQmcStreams(8, seed=3, device="cpu")
    jdev = JaxDeviceQmcStreams(8, seed=3)
    host = QmcStreams(8, seed=3)
    jhost = JaxQmcStreams(8, seed=3)
    assert np.array_equal(_u32(port.offset_bits), np.asarray(jdev.offset_bits))
    assert np.array_equal(port.offsets, jhost.offsets)
    for sl in map(np.asarray, _SCHEDULES):
        got = port.next(sl)
        for want in (jdev.next(sl), host.next(sl), jhost.next(sl)):
            assert np.array_equal(got.view(np.uint32), np.asarray(want).view(np.uint32)), sl
        assert np.array_equal(_u32(port.counters), np.asarray(jdev.counters))
        assert np.array_equal(_u32(port.counters), jhost.counters)


def test_device_streams_churn_and_wrap():
    """Random drains with duplicates over many calls, starting from
    counters just below 2^32 so the uint32 wrap is exercised."""
    rng = np.random.default_rng(5)
    jdev = JaxDeviceQmcStreams(64, seed=9)
    state = jdev.snapshot()
    state["counters"] = (np.uint32(2**32 - 3) - np.arange(64, dtype=np.uint32) % 5)
    jdev = JaxDeviceQmcStreams.restore(state)
    port = DeviceQmcStreams.restore(state, device="cpu")
    for _ in range(6):
        sl = rng.integers(0, 64, int(rng.integers(1, 300)))
        c1, o1, x1 = port.draw(sl)
        c2, o2, x2 = jdev.draw(sl)
        assert np.array_equal(_u32(c1), np.asarray(c2))
        assert np.array_equal(_u32(o1), np.asarray(o2))
        assert np.array_equal(x1.numpy().view(np.uint32), np.asarray(x2).view(np.uint32))
        assert np.array_equal(_u32(port.counters), np.asarray(jdev.counters))
    assert port.snapshot()["counters"].dtype == np.uint32


def test_stream_prepass_sentinel_slots_advance_nothing():
    counters = torch.from_numpy(np.array([5, 0, 2**32 - 1, 2**31 - 1], np.uint32).view(np.int32))
    offsets = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    ctr, off, xi, new = _stream_prepass(counters, offsets,
                                        torch.tensor([2, -1, 2, 0, -1, 3, 3]))
    # rank 1 of slot 2 wraps to 0; slot 3 crosses the int32 sign bit
    assert _u32(ctr).tolist() == [2**32 - 1, 0, 0, 5, 0, 2**31 - 1, 2**31]
    assert _u32(off).tolist() == [3, 0, 3, 1, 0, 4, 4]
    assert _u32(new).tolist() == [6, 0, 1, 2**31 + 1]
    want = qmc_point_np(_u32(ctr), _u32(off))
    assert np.array_equal(xi.numpy(), want)


@pytest.mark.parametrize("B,n,m", [(1, 8, 8), (5, 24, 32), (3, 300, 300)])
def test_stream_drain_plain_matches_jax_ref(B, n, m):
    rng = np.random.default_rng(B + n)
    W = np.stack([normalize_weights(rng.random(n) ** 4 + 1e-9) for _ in range(B)])
    if B > 1:
        W[-1] = 0.0
        W[-1, n // 2] = 1.0  # tied row: fallback cells
    cdf = np.stack([np.asarray(jax_build_cdf(jnp.asarray(w, jnp.float32))) for w in W])
    pf = build_forest_batched_from_cdf(torch.from_numpy(cdf), m, device="cpu")
    jf = BatchedForest(*(jnp.asarray(x.numpy()) for x in pf))
    Q = 2000
    did = rng.integers(-1, B, Q).astype(np.int32)
    ctr = rng.integers(0, 2**32, Q, dtype=np.uint64).astype(np.uint32)
    off = qmc_offset_bits_np(rng.random(Q))
    want_i, want_x = _jax_ref_streams(
        jf.cdf, jf.table, jf.left, jf.right, jnp.asarray(did), jnp.asarray(ctr),
        jnp.asarray(off), jf.cell_first, jf.fallback)
    c = torch.from_numpy(ctr.view(np.int32))  # int32 bit views, as the streams keep
    o = torch.from_numpy(off.view(np.int32))
    for co in (True, False):
        idx, xi = forest_sample_batched_streams(*pf, torch.from_numpy(did), c, o,
                                                coalesce=co)
        assert np.array_equal(xi.numpy().view(np.uint32),
                              qmc_point_np(ctr, off).view(np.uint32))
        assert np.array_equal(xi.numpy(), np.asarray(want_x))
        assert np.array_equal(idx.numpy(), np.asarray(want_i)), co
    with pytest.raises(ValueError, match="counter"):
        forest_sample_batched_streams(*pf, torch.from_numpy(did), c.to(torch.int64), o)


@pytest.mark.parametrize("coalesce", [True, False])
def test_grouped_stream_drain_plain_matches_jax_kernels_clipped(coalesce):
    """A stream drain's lanes over three forest classes (one B6 launch,
    points made from the lanes' counters and rotations) and two alias
    classes (one B8 launch on the pre-pass points), by the grouped plain
    versions: equal to the JAX package's forest_sample_batched_streams and
    alias_sample_batched (interpret mode) group by group, clipped per lane
    as repro.pool.ForestPool clips a drain; the stream points bit-equal to
    qmc_point_np; sentinel and out-of-range rows included."""
    rng = np.random.default_rng(53)
    forests = []
    for n, B in ((8, 2), (24, 3), (300, 2)):
        W = np.stack([normalize_weights(rng.random(n) ** 4 + 1e-9) for _ in range(B)])
        W[-1] = 0.0
        W[-1, n // 2] = 1.0  # tied row: fallback cells
        cdf = np.stack([np.asarray(jax_build_cdf(jnp.asarray(w, jnp.float32))) for w in W])
        forests.append(build_forest_batched_from_cdf(torch.from_numpy(cdf), n, device="cpu"))
    tables = [alias_build_batched(torch.from_numpy((rng.random((3, n)) ** 4 + 1e-6)
                                                   .astype(np.float32))) for n in (16, 64)]
    sizes = [f.n for f in forests] + [t[0].shape[1] for t in tables]
    rows = [f.batch for f in forests] + [t[0].shape[0] for t in tables]
    Q = 600
    gid = rng.integers(0, len(sizes), Q).astype(np.int32)
    row = np.asarray([rng.integers(-1, rows[g] + 1) for g in gid], np.int32)
    hi = np.asarray([rng.integers(0, sizes[g]) for g in gid], np.int32)
    ctr = rng.integers(0, 2**32, Q, dtype=np.uint64).astype(np.uint32)
    off = qmc_offset_bits_np(rng.random(Q))
    pts = qmc_point_np(ctr, off)  # the pre-pass points the alias lanes take
    want = np.full(Q, -7, np.int32)
    want_pts = np.full(Q, -1.0, np.float32)
    for g, f in enumerate(forests):
        sel = gid == g
        jf = [jnp.asarray(t.numpy()) for t in f]
        idx, x = jax_forest_sample_batched_streams(
            jf[0], jf[1], jf[2], jf[3], jnp.asarray(row[sel]), jnp.asarray(ctr[sel]),
            jnp.asarray(off[sel]), jf[4], jf[5], interpret=True)
        want[sel] = np.minimum(np.asarray(idx), hi[sel])
        want_pts[sel] = np.asarray(x)
    for a, t in enumerate(tables):
        sel = gid == len(forests) + a
        idx = jax_alias_sample_batched(jnp.asarray(t[0].numpy()), jnp.asarray(t[1].numpy()),
                                       jnp.asarray(row[sel]), jnp.asarray(pts[sel]),
                                       interpret=True)
        want[sel] = np.minimum(np.asarray(idx), hi[sel])
    lanes = tuple(torch.from_numpy(a) for a in (gid, row, hi))
    out = torch.full((Q,), -7, dtype=torch.int32)
    got_pts = torch.full((Q,), -1.0)
    forest_sample_grouped([tuple(f) for f in forests], *lanes, out,
                          counter=torch.from_numpy(ctr.view(np.int32)),
                          offset_bits=torch.from_numpy(off.view(np.int32)), xi_out=got_pts,
                          coalesce=coalesce)
    alias_sample_grouped(list(tables), *lanes, out, torch.from_numpy(pts), g0=len(forests),
                         coalesce=coalesce)
    assert np.array_equal(out.numpy(), want)
    fl = gid < len(forests)
    assert np.array_equal(got_pts.numpy()[fl].view(np.uint32), want_pts[fl].view(np.uint32))
    assert np.array_equal(got_pts.numpy()[fl].view(np.uint32), pts[fl].view(np.uint32))
    assert bool((got_pts[torch.from_numpy(~fl)] == -1.0).all())


def _tenants(rng):
    return [normalize_weights(rng.random(n) ** 3 + 1e-4) for n in (5, 8, 40, 50)]


@pytest.mark.parametrize("streams,device_streams", [("qmc", True), ("qmc", False),
                                                    ("prng", True)])
def test_pooled_sampler_restored_from_jax_drains_equal(streams, device_streams):
    rng = np.random.default_rng(7)
    js = JaxPooledSampler(n_slots=16, seed=4, streams=streams,
                          device_streams=device_streams, use_pallas=False)
    jh = js.add_many(_tenants(rng), method=["auto", "forest", "alias", "auto"])
    slots = rng.integers(0, 16, 64)
    slots[:8] = slots[8:16]  # duplicate slots
    lanes = rng.integers(0, len(jh), 64)
    js.sample([jh[i] for i in lanes], slots)  # advance the streams first
    ps = PooledForestSampler.restore(js.snapshot(), device="cpu")
    ph = [handle_from_numpy(h) for h in jh]
    assert ps.stream_kind == streams and ps.device_streams == js.device_streams
    for _ in range(3):
        want = js.sample([jh[i] for i in lanes], slots)
        got = ps.sample([ph[i] for i in lanes], slots)
        assert np.array_equal(got, want)
    if streams == "qmc":
        assert np.array_equal(np.asarray(ps.streams.snapshot()["counters"]),
                              np.asarray(js.streams.snapshot()["counters"]))
    # the port's own snapshot restores into the port
    back = PooledForestSampler.restore(ps.snapshot(), device="cpu")
    assert np.array_equal(back.sample([ph[i] for i in lanes], slots),
                          ps.sample([ph[i] for i in lanes], slots))


def test_pooled_sampler_auto_method_and_churn():
    rng = np.random.default_rng(11)
    for kind, want in (("qmc", "forest"), ("prng", "alias")):
        ps = PooledForestSampler(n_slots=8, seed=1, streams=kind, device="cpu")
        hs = ps.add_many(_tenants(rng))
        assert {h.method for h in hs} == {want}
        slots = np.arange(8) % 4
        out = ps.sample(hs * 2, slots)
        assert np.all(out < [h.n for h in hs] * 2)
        ps.update(hs[0], rng.random(5) + 1e-3)
        ps.remove(hs[1])
        out = ps.sample([hs[0], hs[2], hs[3]], [0, 1, 2])
        assert np.all(out < [5, 40, 50])
