"""The port's 2-D map path (``spatial.Map2DSampler``, the 2-D QMC streams,
``SpatialSampler`` and the engine's ``prior2d`` requests) against the JAX
package (CPU).

The port's CDFs may differ from the reference's by a few ulp (ROADMAP C2),
so draws are held elementwise to the reference's ``Map2DSampler`` on
dyadic maps, where every row's weights and the row masses are exact in
float32 and both packages' CDFs are exact; on the reference's map families
they are held elementwise to the port's own per-row ``build_forest`` +
``sample_forest`` reference. Streams are exact integer arithmetic and held
bit for bit.
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.configs.paper_workloads import env_map_2d
from repro.serve import DeviceQmc2Streams as JaxDeviceQmc2Streams
from repro.serve import Qmc2Streams as JaxQmc2Streams
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import SpatialSampler as JaxSpatialSampler
from repro.spatial import Map2DSampler as JaxMap2DSampler
import repro_torch.configs as TC
from repro_torch.core import build_forest, sample_forest
from repro_torch.core.cdf import normalize_weights
from repro_torch.core.metrics import chi2_statistic
from repro_torch.models import init_params
from repro_torch.serve import (
    DeviceQmc2Streams,
    Qmc2Streams,
    Request,
    ServeEngine,
    SpatialSampler,
    restore_streams,
)
from repro_torch.serve.sampler import _stream_prepass2
from repro_torch.spatial import Map2DSampler

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

_FIELDS = ("cdf", "table", "left", "right", "cell_first", "fallback")


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------ dyadic maps


def _pow2_row(width: int, rng, hot: int | None = None) -> np.ndarray:
    """Integer weights summing to a power of two (one-hot at ``hot``)."""
    if hot is not None:
        w = np.zeros(width)
        w[hot] = 4.0
        return w
    w = rng.integers(0, 8, width).astype(np.float64)
    w[0] += w.sum() == 0
    total = 1 << int(np.ceil(np.log2(w.sum())))
    w[-1] += total - w.sum()
    return w


def _dyadic_map(spec, seed: int) -> list[np.ndarray]:
    """Rows from ``spec`` (width, kind) with kind "w" (random), "hot" or
    "zero"; each live row sums to a power of two, and filler rows (one a set
    bit of the deficit) bring the total mass to a power of two, so every
    normalized weight, row mass and CDF entry is exact in float32."""
    rng = np.random.default_rng(seed)
    rows = []
    for width, kind in spec:
        if kind == "zero":
            rows.append(np.zeros(width))
        else:
            rows.append(_pow2_row(width, rng, hot=width // 3 if kind == "hot" else None))
    total = int(sum(r.sum() for r in rows))
    deficit = (1 << int(np.ceil(np.log2(total)))) - total
    width = spec[0][0]
    for b in range(deficit.bit_length()):
        if deficit >> b & 1:
            w = np.zeros(width)
            w[b % width] = float(1 << b)
            rows.append(w)
    return rows


_RECT = [(16, "w")] * 5 + [(16, "zero"), (16, "hot"), (16, "w")]
_RAGGED = [(5, "w"), (17, "w"), (33, "w"), (8, "hot"), (64, "w"), (9, "zero"), (2, "w"),
           (1, "w"), (30, "hot"), (12, "w")]
_ONEHOT = [(17, "hot")] * 9
_DYADIC = {"rect": _RECT, "ragged": _RAGGED, "onehot": _ONEHOT}


@pytest.fixture(scope="module")
def dyadic_pairs():
    """name -> (rows, JAX sampler factory result, port sampler): one JAX
    ``Map2DSampler`` a shape, reused across cases."""
    out = {}
    for i, (name, spec) in enumerate(_DYADIC.items()):
        rows = _dyadic_map(spec, seed=i)
        out[name] = (rows, JaxMap2DSampler(rows, use_pallas=False),
                     Map2DSampler(rows, device="cpu"))
    return out


def _points(n: int, seed: int) -> np.ndarray:
    pts = np.random.default_rng(seed).random((n, 2)).astype(np.float32)
    pts[:4] = [[0.0, 0.0], [0.0, 1 - 2**-24], [1 - 2**-24, 0.0], [1 - 2**-24, 1 - 2**-24]]
    return pts


@pytest.mark.parametrize("name", list(_DYADIC))
def test_map2d_drains_equal_jax_on_dyadic_maps(dyadic_pairs, name):
    rows, jm, tm = dyadic_pairs[name]
    assert np.array_equal(_np(tm.forest.cdf), np.asarray(jm._marginal.cdf))
    pts = _points(4096, 7)
    jr, jc, _, _ = jm.sample_map(pts)
    tr, tc, u, v = tm.sample_map(pts)
    assert tr.dtype == tc.dtype == torch.int32
    assert np.array_equal(_np(tr), jr) and np.array_equal(_np(tc), jc)
    assert np.array_equal(_np(u), pts[:, 0]) and np.array_equal(_np(v), pts[:, 1])
    assert tm.last_drain["classes"] == jm.last_drain["classes"]
    assert tm.last_drain["fused"] == jm.last_drain["fused"]
    assert tm.last_drain["launches"] == 1
    if name == "ragged":
        assert len(tm.classes) >= 3 and not tm.last_drain["fused"]
    for r, row in enumerate(rows):
        if row.sum() == 0:
            assert not (_np(tr) == r).any(), "zero-mass row drawn"
    # the (u, v) pair form and the stacked form drain alike
    tr2, tc2, _, _ = tm.sample_map((torch.as_tensor(pts[:, 0]), pts[:, 1]))
    assert torch.equal(tr2, tr) and torch.equal(tc2, tc)


def _assert_bit_identical(a: Map2DSampler, b: Map2DSampler):
    assert sorted(a.classes) == sorted(b.classes)
    for wc in a.classes:
        ca, cb = a.classes[wc], b.classes[wc]
        assert ca.row_ids == cb.row_ids and ca.degenerate == cb.degenerate
        for fa, fb in zip(ca.forest, cb.forest):
            assert fa.dtype == fb.dtype and torch.equal(fa, fb), wc
    for fa, fb in zip(a.forest, b.forest):
        assert torch.equal(fa, fb)
    for pa, pb in zip(a._packed, b._packed):
        assert torch.equal(pa, pb)


@pytest.mark.parametrize("delta", [False, True])
def test_map2d_update_bit_equal_to_fresh_build_and_stats_equal_jax(delta):
    """Both forms of ``update_map``: the same stats as the reference's, the
    arrays (and the marginal's pack) bit-equal to a from-scratch build over
    the new map, the next drains equal to the reference's updated sampler."""
    rows = _dyadic_map(_RAGGED, seed=1)
    jm = JaxMap2DSampler(rows, use_pallas=False)
    tm = Map2DSampler(rows, device="cpu")
    rng = np.random.default_rng(3)
    new = {0: _pow2_row(5, rng), 3: rows[3].copy(), 4: _pow2_row(64, rng),
           5: _pow2_row(9, rng)}      # dirty, unchanged, dirty, a zero row revived
    new[0] *= rows[0].sum() / new[0].sum()   # keep the row masses dyadic
    new[4] *= rows[4].sum() / new[4].sum()
    new[5] *= 8 / new[5].sum()
    upd = {r: (w - rows[r] if delta else w) for r, w in new.items()}
    stats = tm.update_map(upd, delta=delta)
    assert stats == jm.update_map(upd, delta=delta)
    assert (stats["rebuilt_rows"], stats["skipped_rows"]) == (3, 1)
    fresh_rows = list(rows)
    for r, w in new.items():
        fresh_rows[r] = w
    _assert_bit_identical(tm, Map2DSampler(fresh_rows, device="cpu"))
    pts = _points(4096, 11)
    jr, jc, _, _ = jm.sample_map(pts)
    tr, tc, _, _ = tm.sample_map(pts)
    assert np.array_equal(_np(tr), jr) and np.array_equal(_np(tc), jc)
    assert (_np(tr) == 5).any(), "revived row never selected"
    assert tm.stats()["classes"] == jm.stats()["classes"]


def test_map2d_update_noop_and_errors():
    rows = _dyadic_map(_RECT, seed=0)
    tm = Map2DSampler(rows, device="cpu")
    before = [t.clone() for t in tm.forest]
    assert tm.update_map({2: rows[2].copy()}) == dict(
        rebuilt_rows=0, skipped_rows=1, cond_launches=0, marginal_rebuilt=False)
    assert all(torch.equal(a, b) for a, b in zip(before, tm.forest))
    with pytest.raises(ValueError):
        tm.update_map({2: np.ones(7)})
    with pytest.raises(ValueError):
        tm.update_map({99: np.ones(16)})
    with pytest.raises(NotImplementedError, match="A4"):
        Map2DSampler(rows, sharded=True, device="cpu")


# ------------------------------------------------------ the map families


def _family(name: str):
    """The map families of tests/test_spatial.py."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "env":
        return list(env_map_2d(12, 24))
    if name == "onehot":
        rows = []
        for r in range(9):
            w = np.zeros(17)
            w[(r * 5) % 17] = 1.0 + r
            rows.append(w)
        return rows
    if name == "constant":
        return list(np.ones((7, 33)))
    if name == "zipf":
        return [rng.permutation(1.0 / np.arange(1, 41) ** 1.2) for _ in range(11)]
    if name == "ragged":
        rows = [rng.random(w) ** 3 for w in (5, 17, 33, 8, 64, 9, 2)]
        rows.append(np.zeros(12))
        one = np.zeros(30)
        one[13] = 2.5
        rows.append(one)
        rows.append(np.array([4.0]))
        return rows
    raise AssertionError(name)


def _reference(rows_raw, sampler: Map2DSampler, u, v):
    """The per-row oracle on the port: a marginal ``build_forest`` over the
    row masses, then one ``build_forest`` a selected row at its padded class
    width, columns clipped to the true width."""
    mass = np.asarray([r.sum() for r in rows_raw], np.float64)
    f_marg = build_forest(normalize_weights(mass), sampler.m_marginal, device="cpu")
    rows = sample_forest(f_marg, u, device="cpu").numpy().astype(np.int64)
    cols = np.empty(len(rows), np.int64)
    for r in np.unique(rows):
        mask = rows == r
        w = rows_raw[r]
        wc = int(sampler._class_of[r])
        f = build_forest(np.pad(normalize_weights(w), (0, wc - len(w))), wc, device="cpu")
        cols[mask] = np.minimum(sample_forest(f, v[mask], device="cpu").numpy(), len(w) - 1)
    return rows, cols


@pytest.mark.parametrize("family", ["env", "onehot", "constant", "zipf", "ragged"])
def test_map2d_matches_per_row_reference(family):
    rows_raw = _family(family)
    sampler = Map2DSampler(rows_raw, device="cpu")
    pts = _points(4096, 7)
    ri, ci, _, _ = sampler.sample_map(pts)
    rr, cr = _reference(rows_raw, sampler, pts[:, 0], pts[:, 1])
    assert np.array_equal(rr, _np(ri)), "marginal diverged"
    assert np.array_equal(cr, _np(ci)), "conditional diverged"
    touched = sorted({int(sampler._class_of[r]) for r in np.unique(rr)})
    assert sampler.last_drain["classes"] == touched


def test_zero_mass_and_single_texel_rows():
    rows_raw = _family("ragged")
    sampler = Map2DSampler(rows_raw, device="cpu")
    ri, ci, _, _ = sampler.sample_map(_points(1 << 14, 3))
    ri, ci = _np(ri), _np(ci)
    assert not (ri == 7).any(), "zero-mass row was selected"
    assert (ci[ri == 8] == 13).all() and (ci[ri == 9] == 0).all()
    assert (ci >= 0).all() and (ci < sampler.widths[ri]).all()


def test_single_cell_map_min_class_one():
    sampler = Map2DSampler([np.array([3.0])], min_class=1, device="cpu")
    ri, ci, _, _ = sampler.sample_map(_points(256, 0))
    assert (_np(ri) == 0).all() and (_np(ci) == 0).all()


def test_all_zero_map_rejected():
    with pytest.raises(ValueError):
        Map2DSampler(np.zeros((4, 8)), device="cpu")
    with pytest.raises(ValueError):
        Map2DSampler([np.array([1.0, -2.0])], device="cpu")


def test_map_distribution_preserved_chi2():
    rng = np.random.default_rng(5)
    H, W = 8, 32
    img = rng.random((H, W)) ** 2 + 0.05
    sampler = Map2DSampler(img, device="cpu")
    ri, ci, _, _ = sampler.sample_map(rng.random((1 << 15, 2)).astype(np.float32))
    counts = np.bincount(sampler.flat_index(_np(ri), _np(ci)), minlength=H * W)
    assert np.array_equal(_np(sampler.flat_index(ri, ci)), sampler.flat_index(_np(ri), _np(ci)))
    # dof = 255: mean 255, sd ~22.6; 500 is a ~10-sigma guard
    assert chi2_statistic(counts, (img / img.sum()).ravel()) < 500


# ------------------------------------------------------------ 2-D streams

_SCHEDULES = ([0, 3, 3, 5, 3, 0], [7, 7, 7, 7], [1], list(range(8)), [6, 2, 6, 2, 6])


def test_qmc2_streams_bit_equal_to_jax_under_duplicates_and_churn():
    jh, jd = JaxQmc2Streams(8, seed=42), JaxDeviceQmc2Streams(8, seed=42)
    th, td = Qmc2Streams(8, seed=42), DeviceQmc2Streams(8, seed=42, device="cpu")
    for slots in _SCHEDULES * 2:
        s = np.asarray(slots)
        want = jh.next(s)
        jdu, jdv = jd.draw(s)
        for got in (th.next(s), td.next(s)):
            for a, b in zip(got, want):
                assert a.dtype == np.float32 and np.array_equal(a.view(np.uint32),
                                                                b.view(np.uint32))
        assert np.array_equal(np.asarray(jdu), want[0]) and np.array_equal(np.asarray(jdv), want[1])
    for got in (th.snapshot(), td.snapshot()):
        for k in ("offset_u", "offset_v", "counters"):
            assert np.array_equal(got[k], np.asarray(jh.snapshot()[k])), k
    assert td.snapshot()["kind"] == jd.snapshot()["kind"]


def test_stream_prepass2_sentinel_lanes_advance_nothing():
    td = DeviceQmc2Streams(4, seed=1, device="cpu")
    before = td.counters.clone()
    u, v, after = _stream_prepass2(td.counters, td.offset_u, td.offset_v,
                                   torch.tensor([-1, 2, -1, 2]))
    assert torch.equal(after - before, torch.tensor([0, 0, 2, 0], dtype=torch.int32))
    host = Qmc2Streams(4, seed=1)
    hu, hv = host.next(np.array([2, 2]))
    assert np.array_equal(u[[1, 3]].numpy(), hu) and np.array_equal(v[[1, 3]].numpy(), hv)


@pytest.mark.parametrize("kind", ["qmc2", "device_qmc2"])
def test_restore_streams_takes_jax_2d_snapshots(kind):
    j = JaxQmc2Streams(6, seed=3) if kind == "qmc2" else JaxDeviceQmc2Streams(6, seed=3)
    j.next(np.array([0, 0, 5]))
    s = restore_streams(j.snapshot(), device="cpu")
    assert type(s).__name__ == type(j).__name__
    for _ in range(2):
        slots = np.array([5, 1, 5])
        for a, b in zip(s.next(slots), j.next(slots)):
            assert np.array_equal(np.asarray(a), np.asarray(b))


# -------------------------------------------------------- SpatialSampler


def test_spatial_sampler_restores_jax_snapshot_and_drains_equal():
    """A JAX ``SpatialSampler`` snapshot taken after some drains restores
    into the port (its ``use_pallas`` ignored), and the next drains are
    equal; the port's own snapshot round trip continues bit for bit."""
    rows = _dyadic_map(_RECT, seed=4)
    j = JaxSpatialSampler(np.stack(rows), n_slots=6, seed=9, use_pallas=False)
    slots = np.array([0, 2, 2, 5, 1, 0])
    for _ in range(2):
        j.sample_flat(slots)
    t = SpatialSampler.restore(j.snapshot(), device="cpu")
    assert isinstance(t.streams, DeviceQmc2Streams)
    for _ in range(3):
        assert np.array_equal(t.sample_flat(slots), j.sample_flat(slots))
    r, c = t.sample(slots)
    jr, jc = j.sample(slots)
    assert np.array_equal(r, jr) and np.array_equal(c, jc)
    t2 = SpatialSampler.restore(t.snapshot(), device="cpu")
    for _ in range(2):
        assert np.array_equal(t.sample_flat(slots), t2.sample_flat(slots))


@pytest.mark.parametrize("streams", ["qmc", "prng"])
def test_spatial_sampler_streams_match_jax_and_update(streams):
    img = env_map_2d(10, 20)
    a = SpatialSampler(img, n_slots=4, seed=9, streams=streams, device="cpu")
    b = SpatialSampler(img, n_slots=4, seed=9, streams=streams, device_streams=False,
                       device="cpu")
    slots = np.array([0, 2, 2, 3])
    for _ in range(3):
        assert np.array_equal(a.sample_flat(slots), b.sample_flat(slots))
    stats = a.update({1: np.full(20, 0.5)})
    assert stats["rebuilt_rows"] == 1
    flat = a.sample_flat(slots)
    assert ((0 <= flat) & (flat < img.size)).all()


# ----------------------------------------------------------------- engine


def test_engine_serves_prior2d_requests_beside_prior_ones():
    """Pure 2-D and prior traffic (params=None): every 2-D token is a valid
    flat texel id outside the dead row, slots recycle, the prior requests
    finish, and a JAX engine on the same dyadic map emits the same 2-D
    tokens."""
    img = np.stack(_dyadic_map(_RECT, seed=2))
    dead = 5                          # _RECT's zero-mass row
    eng = ServeEngine(None, None, n_slots=4, device="cpu")
    jeng = JaxServeEngine(None, None, n_slots=4)
    reqs, jreqs = [], []
    for i in range(6):
        kw = dict(rid=i, prompt=np.zeros(0, np.int32), max_new=5, prior2d=img)
        reqs.append(Request(**kw))
        jreqs.append(JaxRequest(**kw))
    prior = Request(rid=9, prompt=np.zeros(0, np.int32), max_new=3, prior=np.ones(8))
    for r in reqs + [prior]:
        eng.submit(r)
    for r in jreqs:
        jeng.submit(r)
    eng.run(max_steps=50)
    jeng.run(max_steps=50)
    W = img.shape[1]
    for r, jr in zip(reqs, jreqs):
        out = np.asarray(r.out)
        assert r.done and len(out) == 5 and ((0 <= out) & (out < img.size)).all()
        assert not ((dead * W <= out) & (out < (dead + 1) * W)).any()
    assert prior.done and len(prior.out) == 3
    assert not eng.spatial_slots
    # without the prior request in the way, the 2-D tokens equal JAX's
    eng2 = ServeEngine(None, None, n_slots=4, device="cpu")
    reqs2 = [Request(rid=i, prompt=np.zeros(0, np.int32), max_new=5, prior2d=img)
             for i in range(6)]
    for r in reqs2:
        eng2.submit(r)
    eng2.run(max_steps=50)
    assert [r.out for r in reqs2] == [r.out for r in jreqs]


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


def test_engine_rejects_bad_prior2d_like_jax():
    img = np.asarray(env_map_2d(9, 16))
    other = img.copy()
    other[0, 0] += 1.0
    bad = {
        "bad_shape": [np.ones((2, 2))],
        "empty": [],
        "negative": [np.array([1.0, -1.0])],
        "non_finite": [np.array([1.0, np.nan])],
        "bad_dtype": [np.array(["a", "b"])],
    }
    for name, prior2d in bad.items():
        got = _error(lambda: ServeEngine(None, None, n_slots=2, device="cpu").submit(
            Request(rid=1, prompt=np.zeros(0, np.int32), prior2d=prior2d)))
        want = _error(lambda: JaxServeEngine(None, None, n_slots=2).submit(
            JaxRequest(rid=1, prompt=np.zeros(0, np.int32), prior2d=prior2d)))
        assert got is not None and got[0] == want[0] == "RequestError", name
        assert got[1].split(":")[:2] == want[1].split(":")[:2], (name, got, want)

    both = dict(rid=2, prompt=np.zeros(0, np.int32), prior=np.ones(8), prior2d=img)
    assert _error(lambda: ServeEngine(None, None, device="cpu").submit(Request(**both))) == \
        _error(lambda: JaxServeEngine(None, None).submit(JaxRequest(**both)))

    results = []
    for make, R, kw in ((lambda: ServeEngine(None, None, n_slots=2, device="cpu"), Request, {}),
                        (lambda: JaxServeEngine(None, None, n_slots=2), JaxRequest, {})):
        eng = make()
        eng.submit(R(rid=0, prompt=np.zeros(0, np.int32), prior2d=img))
        eng.submit(R(rid=1, prompt=np.zeros(0, np.int32), prior2d=other))
        results.append(_error(lambda: eng.run(max_steps=5)))
        # a shape mismatch is refused at submit once the engine has its map
        results.append(_error(lambda: eng.submit(
            R(rid=3, prompt=np.zeros(0, np.int32), prior2d=img[:, :8]))))
    assert results[0] == results[2] and results[0][0] == "RequestError"
    assert results[1] == results[3] and "map_mismatch" in results[1][1]


def test_engine_prior2d_retire_and_snapshot_restore():
    """A mismatched map retires under ``on_fault="retire"``; a snapshot with
    live 2-D slots restores (port and JAX snapshots alike) and continues
    with the same tokens."""
    img = np.stack(_dyadic_map(_RECT, seed=5))
    other = img.copy()
    other[0, 0] += 1.0
    eng = ServeEngine(None, None, n_slots=3, on_fault="retire", device="cpu")
    bad = Request(rid=1, prompt=np.zeros(0, np.int32), prior2d=other)
    good = [Request(rid=i, prompt=np.zeros(0, np.int32), max_new=6, prior2d=img)
            for i in (0, 2)]
    for r in (good[0], bad, good[1]):
        eng.submit(r)
    eng.step()
    assert bad.done and bad.error.startswith("bad_request")
    state = eng.snapshot()
    assert state["spatial_slots"] == {0, 2} and state["spatial_sampler"] is not None
    twin = ServeEngine.restore(state, device="cpu")
    twin_reqs = {r.rid: r for r in twin.slots if r}
    eng.run(max_steps=20)
    twin.run(max_steps=20)
    assert all(r.done and len(r.out) == 6 for r in good)
    assert [twin_reqs[r.rid].out for r in good] == [r.out for r in good]
    # JAX's engine snapshot with live 2-D slots restores into the port
    jeng = JaxServeEngine(None, None, n_slots=3)
    for i in range(3):
        jeng.submit(JaxRequest(rid=i, prompt=np.zeros(0, np.int32), max_new=6, prior2d=img))
    jeng.step()
    peng = ServeEngine.restore(jeng.snapshot(), device="cpu")
    for _ in range(3):
        jeng.step()
        peng.step()
        assert [r.out if r else None for r in peng.slots] == \
            [r.out if r else None for r in jeng.slots]


def test_engine_prior2d_wider_than_vocab_beside_model_request():
    """A 2-D map with more texels than the vocabulary serves beside a model
    request: the 2-D slot's flat texel ids stay out of the decode batch's
    tokens (it feeds token 0), so decode keeps running."""
    cfg = dataclasses.replace(TC.get_reduced("qwen1_5_0_5b"), dtype="float32", n_layers=2,
                              d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                              vocab=256)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    img = np.full((8, 4 * cfg.vocab), 1e-6)
    img[:, cfg.vocab:] = 1.0
    eng = ServeEngine(model, cfg, n_slots=2, max_seq=64, device="cpu")
    map_req = Request(rid=0, prompt=np.zeros(0, np.int64), max_new=3, prior2d=img)
    lm_req = Request(rid=1, prompt=np.random.default_rng(1).integers(0, cfg.vocab, 4),
                     max_new=8)
    eng.submit(map_req)
    eng.submit(lm_req)
    eng.run(max_steps=50)
    assert map_req.done and all(t % (4 * cfg.vocab) >= cfg.vocab for t in map_req.out)
    assert lm_req.done and len(lm_req.out) == 8
    assert all(0 <= t < cfg.vocab for t in lm_req.out)
