"""The port's robustness layer and serving state against the JAX package, on
the CPU: the tagged-JSON state codec, ``save_serving``/``load_serving``
across packages, ``verify_*``, the chaos harness, and trainer checkpoints
that resume in either package.

Tolerances and rules:
* the codec: a blob of every tag, written by both packages, gives
  byte-identical ``state.json``, manifests and ``.npy`` files (bfloat16
  leaves included: JAX writes them as ``<V2``, and so does the port);
* restored drains and stream counters: equal, element for element, on
  dyadic weights and maps (both packages' CDFs exact, ROADMAP C2);
* engine tokens after a restore: the CDF-boundary rule of ROADMAP C7
  (``tests/test_torch_serve.py``'s ``_compare_calls``);
* chaos: the same ``caught`` codes, ``injected`` and ``quarantined``;
* verify: JAX's verdicts and messages on dyadic pools; the batched pool
  check equal, message for message, to a per-row loop of the
  single-table checks;
* trainer checkpoints: restored leaves bit for bit, the next loss within
  ``rtol=1e-5`` (``test_train_steps_match_jax``'s tolerance).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.ckpt import load_state as jax_load_state
from repro.ckpt import restore as jax_restore
from repro.ckpt import save_state as jax_save_state
from repro.kernels.alias_build import alias_split_pack_rows
from repro.models import init_params as jax_init_params
from repro.pool import ForestPool as JaxPool
from repro.pool import Handle as JaxHandle
from repro.robust import load_serving as jax_load_serving
from repro.robust import save_serving as jax_save_serving
from repro.robust import verify_alias as jax_verify_alias
from repro.robust import verify_pool as jax_verify_pool
from repro.robust.faults import FaultPlan as JaxFaultPlan
from repro.robust.faults import run_chaos as jax_run_chaos
from repro.serve import DeviceQmc2Streams as JaxDeviceQmc2Streams
from repro.serve import DeviceQmcStreams as JaxDeviceQmcStreams
from repro.serve import Qmc2Streams as JaxQmc2Streams
from repro.serve import QmcStreams as JaxQmcStreams
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import SpatialSampler as JaxSpatialSampler
from repro.serve import TokenSampler as JaxTokenSampler
from repro.serve.sampler import restore_streams as jax_restore_streams
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
import repro_torch.configs as TC
from repro_torch.ckpt import CheckpointManager, latest_step, load_state, save, save_state
from repro_torch.core.cdf import normalize_weights
from repro_torch.interop import handle_from_numpy, params_from_jax, params_to_jax
from repro_torch.kernels.alias_build import alias_build_batched
from repro_torch.kernels.cdf_scan import SCAN_ATOL
from repro_torch.kernels.ref import ref_cdf_scan
from repro_torch.pool import ForestPool
from repro_torch.robust import (
    load_serving,
    save_serving,
    verify_alias,
    verify_forest,
    verify_pool,
)
from repro_torch.robust.faults import FaultPlan, run_chaos
from repro_torch.serve import Request, ServeEngine, SpatialSampler, restore_streams
from repro_torch.train import AdamWConfig, TrainConfig, Trainer

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

ROOT = Path(__file__).resolve().parents[1]


def _dyadic(n: int, rng) -> np.ndarray:
    """Integer weights in [1, 8) with a power-of-two total: every partial
    sum is exact in float32, so both packages' CDFs and alias tables agree
    bit for bit."""
    c = rng.integers(1, 8, n)
    extra = (1 << int(np.ceil(np.log2(c.sum())))) - c.sum()
    np.add.at(c, rng.integers(0, n, extra), 1)
    return c.astype(np.float64)


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# ----------------------------------------------------------------- codec


def _blob(port: bool):
    """Every tag of the codec; the port's array leaves as tensors where the
    JAX blob has numpy or JAX arrays with the same bits."""
    bf = np.asarray([1.5, -2.0, 3.25e-3, 7.0], np.float32)
    return dict(
        a=torch.arange(5, dtype=torch.int32) if port else np.arange(5, dtype=np.int32),
        u=np.arange(4, dtype=np.uint32),
        b=np.asarray([1.5, np.pi], np.float32),
        bf=torch.from_numpy(bf).to(torch.bfloat16) if port else jnp.asarray(bf, jnp.bfloat16),
        t=(1, "x", (2.5, None)),
        l=[np.int64(3), np.float32(0.5), False],
        s={("forest", 8, 0, 1), ("alias", 16, 2, 3)},
        d={0: "zero", 7: np.ones(2), "k": True},
        n=None,
        big=2**80,
    )


def test_state_codec_files_byte_identical_across_packages(tmp_path):
    """Both packages' ``save_state`` of the same blob write the same bytes,
    file for file; each package loads the other's directory, the port
    returning the bfloat16 leaf as a bf16 tensor with the same bits."""
    jax_save_state(tmp_path / "jax", _blob(port=False), 3)
    save_state(tmp_path / "port", _blob(port=True), 3)
    jd, pd = tmp_path / "jax" / "step_00000003", tmp_path / "port" / "step_00000003"
    assert _files(jd) == _files(pd)
    assert latest_step(tmp_path / "jax") == 3

    got, step = load_state(tmp_path / "jax")
    want = _blob(port=False)
    assert step == 3
    assert got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"].view(torch.int16),
                       _blob(port=True)["bf"].view(torch.int16))
    for k in ("a", "u", "b"):
        assert got[k].dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["t"] == want["t"] and isinstance(got["t"], tuple)
    assert got["l"] == [3, 0.5, False] and got["s"] == want["s"]
    assert set(got["d"]) == {0, 7, "k"} and got["d"][0] == "zero"
    np.testing.assert_array_equal(got["d"][7], np.ones(2))
    assert got["n"] is None and got["big"] == 2**80

    jgot, _ = jax_load_state(tmp_path / "port")
    assert jgot["bf"].dtype.str == np.load(jd / "leaf_00003.npy").dtype.str  # |V2
    assert jgot["t"] == want["t"] and jgot["s"] == want["s"]

    save(tmp_path / "tree", {"w": torch.ones(3)}, 1)
    with pytest.raises(ValueError, match="pytree checkpoint"):
        load_state(tmp_path / "tree")
    with pytest.raises(TypeError, match="cannot encode"):
        save_state(tmp_path / "bad", {"x": object()}, 1)


# ------------------------------------------------- serving state, on disk


def _jax_serving(rng):
    """A JAX pool of dyadic tenants over forest and alias classes, with a
    quarantined tenant riding along, and its stream twins of every kind."""
    pool = JaxPool(policy="quarantine")
    sizes = (9, 10, 11, 13, 12, 14)  # one class a method: few JAX compiles
    methods = ["forest", "alias", "forest", "alias", "forest", "forest"]
    hs = pool.insert_many([_dyadic(n, rng) for n in sizes], method=methods)
    bad = _dyadic(16, rng)
    bad[1] = np.nan
    pool.insert(bad)  # a uniform placeholder over 16: dyadic too (ROADMAP C2)
    streams = dict(qmc=JaxQmcStreams(8, seed=3), dev=JaxDeviceQmcStreams(8, seed=3),
                   qmc2=JaxQmc2Streams(8, seed=5), dev2=JaxDeviceQmc2Streams(8, seed=5))
    return pool, streams, list(hs)


def _churn(pool, streams, hs, step, sample_kw):
    """One deterministic churn step on either package: a dyadic update, the
    last tenant evicted or re-inserted, a stream drain of every live tenant
    and one draw of each other stream kind."""
    rng = np.random.default_rng(1000 + step)
    t = int(rng.integers(len(hs) - 1))
    pool.update_weights(hs[t], _dyadic(hs[t].n, rng))
    if step % 3 == 1 and hs[-1] is not None:
        pool.evict(hs[-1])
        hs[-1] = None
    elif step % 3 == 2 and hs[-1] is None:
        hs[-1] = pool.insert(_dyadic(13, rng))
    live = [h for h in hs if h is not None]
    slots = np.arange(16) % 8  # one drain shape: one JAX compile
    handles = [live[i % len(live)] for i in range(len(slots))]
    out = [np.asarray(pool.sample_streams(handles, slots, streams["dev"], **sample_kw))]
    for k in ("qmc", "qmc2", "dev2"):
        x = streams[k].next(np.array([0, 3, 3, 7]))
        out += [np.asarray(a) for a in (x if isinstance(x, tuple) else (x,))]
    return out


def _restore_port(states):
    pool = ForestPool.restore(states["pool"], device="cpu")
    streams = {k: restore_streams(states[k], device="cpu") for k in ("qmc", "dev", "qmc2", "dev2")}
    hs = [None if h is None else handle_from_numpy(h) for h in states["extra"]["hs"]]
    return pool, streams, hs


def test_jax_serving_dir_resumes_in_port_and_port_dir_in_jax(tmp_path):
    """A JAX ``save_serving`` directory taken mid-churn (pool with a
    quarantined tenant, all four stream kinds) loads into the port: the
    drains, draws and counters that follow equal JAX's; the port's own
    directory, saved later, loads back into JAX and both go on equal."""
    jpool, jstreams, jhs = _jax_serving(np.random.default_rng(0))
    kw_j = dict(use_pallas=False)
    for step in range(3):
        _churn(jpool, jstreams, jhs, step, kw_j)
    jax_save_serving(tmp_path / "jax", 3, pool=jpool, **jstreams,
                     extra=dict(hs=[None if h is None else tuple(h) for h in jhs]))
    states, step = load_serving(tmp_path / "jax")
    assert step == 3
    pool, streams, hs = _restore_port(states)
    assert verify_pool(pool) == [] and pool.stats()["quarantined"] == 1
    for step in range(3, 7):
        want = _churn(jpool, jstreams, jhs, step, kw_j)
        got = _churn(pool, streams, hs, step, {})
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for k in streams:
        np.testing.assert_array_equal(np.asarray(streams[k].counters),
                                      np.asarray(jstreams[k].counters))
    assert pool.stats() == jpool.stats()

    save_serving(tmp_path / "port", 7, pool=pool, **streams,
                 extra=dict(hs=[None if h is None else tuple(h) for h in hs]))
    jstates, _ = jax_load_serving(tmp_path / "port")
    jpool2 = JaxPool.restore(jstates["pool"])
    jstreams2 = {k: jax_restore_streams(jstates[k]) for k in streams}
    jhs2 = [None if h is None else JaxHandle(*h) for h in jstates["extra"]["hs"]]
    assert jax_verify_pool(jpool2) == []
    for step in range(7, 9):
        want = _churn(jpool2, jstreams2, jhs2, step, kw_j)
        got = _churn(pool, streams, hs, step, {})
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _pow2_map(H: int, W: int, seed: int) -> np.ndarray:
    """Integer texels, each row's sum a power of two and H rows of equal
    sum: every normalized weight, row mass and CDF entry is exact."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 8, (H, W)).astype(np.float64)
    img[:, -1] = 64 * W - img[:, :-1].sum(1)  # row sums 64 W
    return img


def test_jax_spatial_sampler_dir_resumes_in_port(tmp_path):
    img = _pow2_map(8, 16, seed=4)
    j = JaxSpatialSampler(img, n_slots=6, seed=9, use_pallas=False)
    slots = np.array([0, 2, 2, 5, 1, 0])
    for _ in range(2):
        j.sample_flat(slots)
    jax_save_serving(tmp_path, 2, spatial=j)
    states, _ = load_serving(tmp_path)
    t = SpatialSampler.restore(states["spatial"], device="cpu")
    for _ in range(3):
        np.testing.assert_array_equal(t.sample_flat(slots), j.sample_flat(slots))


# ------------------------------------------------- engine, bf16 KV cache

_TINY_BF16 = dict(dtype="bfloat16", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                  head_dim=16, d_ff=128, vocab=256)


def _jax_scan(x):
    from repro.kernels.ref import ref_cdf_scan as jax_ref_cdf_scan

    return np.asarray(jax_ref_cdf_scan(jnp.asarray(x)))


def _port_scan(x):
    return ref_cdf_scan(torch.tensor(x)).numpy()


class _Recorder:
    """Per sampler call: request ids, the CDF rows inverted (from the
    logits, with the side's own scan form), the uniforms and the tokens."""

    def __init__(self, eng, scan):
        self.calls = []
        inner, uniforms = eng.sampler.sample, eng.sampler.uniforms
        box = {}

        def rec_uniforms(slots):
            box["xi"] = np.asarray(uniforms(slots))
            return box["xi"]

        def rec_sample(logits, slots):
            rids = [eng.slots[s].rid for s in slots]
            toks = inner(logits, slots)
            x = logits.float().numpy() if isinstance(logits, torch.Tensor) else \
                np.asarray(logits, np.float32)
            self.calls.append((rids, scan(x / eng.sampler.temperature), box["xi"],
                               np.asarray(toks)))
            return toks

        eng.sampler.uniforms = rec_uniforms
        eng.sampler.sample = rec_sample


def test_jax_engine_dir_with_bf16_cache_resumes_in_port(tmp_path):
    """A model-backed JAX engine in bfloat16, saved mid-flight: its KV
    cache leaves are bfloat16 (2-byte void on disk, which JAX itself cannot
    read back: ROADMAP C10). The port reads them by the manifest, restores
    the cache bit for bit and serves on: tokens under the boundary rule of
    ROADMAP C7."""
    jcfg = dataclasses.replace(JC.get_reduced("qwen1_5_0_5b"), **_TINY_BF16)
    tcfg = dataclasses.replace(TC.get_reduced("qwen1_5_0_5b"), **_TINY_BF16)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(22)
    jeng = JaxServeEngine(jp, jcfg, n_slots=3, max_seq=32,
                          sampler=JaxTokenSampler(n_slots=3, use_pallas=False, seed=4))
    for i in range(4):
        jeng.submit(JaxRequest(rid=i, prompt=rng.integers(0, 256, size=(3, 5)[i % 2]),
                               max_new=6))
    for _ in range(3):
        jeng.step()
    jax_save_serving(tmp_path, jeng.steps, engine=jeng)
    states, _ = load_serving(tmp_path)
    leaves = states["engine"]["cache"]
    assert any(isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 for a in leaves)
    teng = ServeEngine.restore(states["engine"], params=model, cfg=tcfg, device="cpu")
    from repro_torch.interop import cache_leaf_order

    for (b, leaf), a in zip(cache_leaf_order(teng.cache), jax.tree_util.tree_leaves(jeng.cache)):
        want = np.asarray(a)
        got = teng.cache[b][leaf]
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    jreqs = {r.rid: r for r in [s for s in jeng.slots if s is not None] + list(jeng.queue)}
    treqs = {r.rid: r for r in [s for s in teng.slots if s is not None] + list(teng.queue)}
    assert set(jreqs) == set(treqs)
    jrec, trec = _Recorder(jeng, _jax_scan), _Recorder(teng, _port_scan)
    jeng.run(max_steps=100)
    teng.run(max_steps=100)
    diverged = set()
    assert len(jrec.calls) == len(trec.calls)
    for (jr, jc, jx, jt), (tr, tc, tx, tt) in zip(jrec.calls, trec.calls):
        assert jr == tr
        np.testing.assert_array_equal(jx, tx)
        for i, rid in enumerate(jr):
            if rid in diverged or jt[i] == tt[i]:
                continue
            a, b = sorted((int(jt[i]), int(tt[i])))
            for cdf in (jc[i], tc[i]):
                assert np.abs(cdf[a:b] - jx[i]).max() <= SCAN_ATOL, (rid, a, b)
            diverged.add(rid)
    for rid, jr in jreqs.items():
        assert jr.done and treqs[rid].done and len(jr.out) == len(treqs[rid].out)
        if rid not in diverged:
            assert jr.out == treqs[rid].out, rid


# ------------------------------------------------------------------ chaos


@pytest.mark.parametrize("policy", ["quarantine", "reject"])
def test_chaos_report_equals_jax(policy):
    """Same plan, same seed: the same faults caught with the same codes, the
    same quarantines, co-tenant drains equal and verify clean throughout
    (the policies of the JAX suite's chaos contract; the card runs all
    three)."""
    plan = FaultPlan.default(steps=8, seed=2)
    assert [dataclasses.astuple(f) for f in plan.faults] == \
        [dataclasses.astuple(f) for f in JaxFaultPlan.default(steps=8, seed=2).faults]
    got = run_chaos(plan, steps=8, policy=policy, seed=2, device="cpu")
    want = jax_run_chaos(JaxFaultPlan.default(steps=8, seed=2), steps=8, policy=policy,
                         seed=2)
    assert got["drains_equal"] and got["verify_errors"] == []
    for k in ("caught", "injected", "quarantined", "kills"):
        assert got[k] == want[k], k
    if policy == "reject":
        assert any(c[2] in ("non_finite", "negative", "zero_total") for c in got["caught"])


# ----------------------------------------------------------------- verify


def _corrupt(pool, jpool, size, row):
    """The same NaN in one forest row's CDF of both pools."""
    sc = pool.classes[size]
    sc.forest.cdf[row, 3] = float("nan")
    jc = jpool.classes[size]
    jc.forest = jc.forest._replace(cdf=jc.forest.cdf.at[row, 3].set(jnp.nan))


def test_verify_pool_gives_jax_verdicts_on_dyadic_pools():
    rng = np.random.default_rng(5)
    jpool = JaxPool(min_class=8)
    sizes = (3, 8, 12, 16, 9, 5, 14)  # two classes a method: few JAX compiles
    methods = ["forest", "alias"] * 3 + ["forest"]
    jh = jpool.insert_many([_dyadic(n, rng) for n in sizes], method=methods)
    pool = ForestPool.restore(jpool.snapshot(), device="cpu")
    assert verify_pool(pool) == jax_verify_pool(jpool) == []
    _corrupt(pool, jpool, jh[2].size_class, jh[2].row)
    ar = pool.alias_classes[jh[1].size_class]
    ar.table.q[jh[1].row, 0] = 1.5
    ja = jpool.alias_classes[jh[1].size_class]
    ja.table = ja.table._replace(q=ja.table.q.at[jh[1].row, 0].set(1.5))
    got = verify_pool(pool)
    assert got and got == jax_verify_pool(jpool)
    with pytest.raises(ValueError, match="non-finite"):
        verify_pool(pool, raise_on_error=True)
    assert verify_pool(pool, deep=False) == jax_verify_pool(jpool, deep=False) == []


def test_verify_pool_batched_equals_per_row_checks():
    """The pool check (one batched build_cdf and one tensor expression a
    class) names the same rows with the same messages as a per-row loop of
    verify_forest / verify_alias, over every kind of corruption."""
    rng = np.random.default_rng(6)
    pool = ForestPool(min_class=8, device="cpu")
    ws = [rng.random(n) + 1e-3 for n in (5, 7, 8, 30, 31, 17, 60, 12)]
    hs = pool.insert_many(ws, method=["forest", "forest", "alias", "forest",
                                      "alias", "forest", "alias", "alias"])
    def forest(i):
        return pool.classes[hs[i].size_class].forest

    def table(i):
        return pool.alias_classes[hs[i].size_class].table

    forest(3).cdf[hs[3].row, -1] = 0.5                # endpoint
    forest(3).left[hs[3].row, 2] = 999                # child ref
    forest(1).cell_first[hs[1].row, 4] = -1           # cells overlap
    forest(0).cdf[hs[0].row, 2] += 1e-7               # bits only
    forest(5).cdf[hs[5].row, 3] = float("inf")        # non-finite
    table(2).alias[hs[2].row, 1] = 8                  # target range
    table(6).q[hs[6].row, :] = 1.0                    # mass
    want = []
    for size, sc in sorted(pool.classes.items()):
        for row in sorted(sc.raw):
            w = normalize_weights(sc.raw[row])
            want += [f"forest[{size}] row {row}: {e}"
                     for e in verify_forest(sc.forest.row(row), np.pad(w, (0, size - len(w))))]
    for size, ar in sorted(pool.alias_classes.items()):
        for row in sorted(ar.raw):
            w = normalize_weights(ar.raw[row])
            want += [f"alias[{size}] row {row}: {e}"
                     for e in verify_alias(ar.table.row(row), np.pad(w, (0, size - len(w))))]
    got = verify_pool(pool)
    assert len(got) >= 7 and got == want


def test_verify_alias_flags_jax_65536_tables_not_the_ports():
    """ROADMAP C6: the JAX package's alias tables of 65536 cells lose
    almost a whole cell's mass; the port's verify_alias flags them and
    passes the port's table of the same row. JAX's own verify_alias passes
    both: its bound, on probabilities, is 65536 times looser there."""
    rng = np.random.default_rng(65537)
    n = 1 << 16
    w = (rng.random(n) ** 6 + 1e-9).astype(np.float32)
    w[n // 2:] = 0.0
    p = normalize_weights(w)
    jq, ja = (np.asarray(x)[0] for x in jax.jit(alias_split_pack_rows)(jnp.asarray(w[None])))

    class T:
        pass

    jt, pt = T(), T()
    jt.q, jt.alias = jq, ja
    q, a = alias_build_batched(torch.from_numpy(w[None]))
    pt.q, pt.alias = q[0], a[0]
    got = verify_alias(jt, p)
    assert got and "does not conserve mass" in got[0]
    assert verify_alias(pt, p) == []
    assert jax_verify_alias(jt, p) == jax_verify_alias(pt, p) == []


# ---------------------------------------------- trainer, across packages

_TINY = dict(dtype="float32", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
             head_dim=16, d_ff=128, vocab=128)


def _trainers(tmp, steps):
    jcfg = dataclasses.replace(JC.get_reduced("qwen1_5_0_5b"), **_TINY)
    tcfg = dataclasses.replace(TC.get_reduced("qwen1_5_0_5b"), **_TINY)
    kw = dict(steps=steps, global_batch=4, seq_len=16, ckpt_dir=str(tmp), ckpt_every=2,
              log_every=1)
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    j = JaxTrainer(jcfg, JaxTrainConfig(**kw), oc=JaxAdamWConfig(**oc), log_fn=lambda s: None)
    t = Trainer(tcfg, TrainConfig(**kw), oc=AdamWConfig(**oc), log_fn=lambda s: None,
                device="cpu")
    return j, t


def _losses(out) -> dict:
    return {m["step"]: m["loss"] for m in out["metrics"]}


def test_trainer_checkpoints_resume_across_packages(tmp_path):
    """A JAX trainer's step-2 checkpoint resumes in the port (leaves bit for
    bit, step 2's loss as JAX's own run's), and the port's resumes in JAX.
    Each side runs 3 steps uninterrupted, checkpointing at 2 and 3; the
    step-3 checkpoint is removed, so the other package resumes at 2."""
    import shutil

    j, t = _trainers(tmp_path / "jax", 3)
    want = _losses(j.run())
    shutil.rmtree(tmp_path / "jax" / "step_00000003")
    params, opt = t.init_state()
    opt = t._restore(params, opt)
    assert int(opt.step) == 2
    (jparams, jopt), _ = jax_restore(tmp_path / "jax", j.init_state())
    for (k, a), b in zip(jax.tree_util.tree_leaves_with_path(jparams),
                         jax.tree_util.tree_leaves(params_to_jax(params))):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(k))
    for (k, a), b in zip(jax.tree_util.tree_leaves_with_path(jopt.m),
                         jax.tree_util.tree_leaves(params_to_jax(opt.m, t.cfg))):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(k))
    got = _losses(t.run())
    assert list(got) == [2]  # resumed at step 2
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)

    j, t = _trainers(tmp_path / "port", 3)
    want = _losses(t.run())
    shutil.rmtree(tmp_path / "port" / "step_00000003")
    got = _losses(j.run())
    assert list(got) == [2]
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)


def test_async_trainer_checkpoint_restores_in_jax_and_failures_surface(tmp_path, monkeypatch):
    """The async writer commits the trainer's tree in JAX's layout, which
    JAX's ``restore`` reads; a worker that dies surfaces on the next
    ``wait``/``save`` and its step never becomes visible (the async-writer
    test of ``tests/test_fault_tolerance.py``)."""
    import repro_torch.ckpt.checkpoint as ck

    j, t = _trainers(tmp_path, 2)
    params, opt = t.init_state()
    mgr = CheckpointManager(tmp_path / "a", async_save=True)
    mgr.save(t._tree(params, opt), 1)
    mgr.wait()
    (jparams, jopt), step = jax_restore(tmp_path / "a", j.init_state())
    assert step == 1 and int(np.asarray(jopt.step)) == 0
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(params_to_jax(params))):
        np.testing.assert_array_equal(np.asarray(a), b)

    def boom(root, tree, step):
        raise OSError("injected: no space left on device")

    monkeypatch.setattr(ck, "save", boom)
    mgr.save(t._tree(params, opt), 2)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    assert latest_step(tmp_path / "a") == 1


# ------------------------------------------------ kill/resume, subprocess

_KILL_RESUME = textwrap.dedent("""
    import os, sys
    import numpy as np
    from repro_torch.pool import ForestPool, Handle
    from repro_torch.robust import load_serving, save_serving, verify_pool
    from repro_torch.serve import DeviceQmcStreams, restore_streams

    MODE, DIR = sys.argv[1], sys.argv[2]
    K, N = 4, 9

    def churn(pool, streams, hs, step, outs):
        rng = np.random.default_rng(1000 + step)
        t = int(rng.integers(len(hs)))
        if hs[t] is not None:
            pool.update_weights(hs[t], rng.random(hs[t].n) + 1e-3)
        if step % 5 == 2 and hs[-1] is not None:
            pool.evict(hs[-1])
            hs[-1] = None
        if step % 5 == 4 and hs[-1] is None:
            hs[-1] = pool.insert(rng.random(7) + 1e-3)
        live = [h for h in hs if h is not None]
        slots = np.arange(2 * len(live)) % 8
        outs.append(pool.sample_streams([live[i % len(live)] for i in range(len(slots))],
                                        slots, streams))

    outs = []
    if MODE in ("full", "part1"):
        pool = ForestPool(policy="quarantine", device="cpu")
        streams = DeviceQmcStreams(8, seed=3, device="cpu")
        rng = np.random.default_rng(0)
        hs = pool.insert_many([rng.random(n) + 1e-3 for n in (5, 9, 17, 33, 12, 7)],
                              method=["forest", "alias", "forest", "alias", "forest", "forest"])
        pool.insert(np.where(np.arange(4) == 1, np.nan, 1.0))
        for step in range(K):
            churn(pool, streams, hs, step, outs)
        if MODE == "part1":
            save_serving(DIR, K, pool=pool, streams=streams,
                         extra=dict(hs=[None if h is None else tuple(h) for h in hs]))
            os._exit(17)  # no cleanup, nothing flushed after the save
        for step in range(K, N):
            churn(pool, streams, hs, step, outs)
    else:
        states, step = load_serving(DIR)
        assert step == K
        pool = ForestPool.restore(states["pool"], device="cpu")
        streams = restore_streams(states["streams"], device="cpu")
        hs = [None if h is None else Handle(*h) for h in states["extra"]["hs"]]
        assert verify_pool(pool) == [] and pool.stats()["quarantined"] == 1
        for step in range(K, N):
            churn(pool, streams, hs, step, outs)
        outs = [None] * K + outs
    print("COUNTERS", ",".join(str(int(c)) for c in streams.counters.tolist()))
    for o in outs[K:]:
        print("OUT", ",".join(str(int(v)) for v in o))
""")


@pytest.mark.slow
def test_serving_kill_resume_bitwise_subprocess(tmp_path):
    """A port serving process killed with ``os._exit`` right after
    ``save_serving`` resumes in a fresh process with the same drains and
    final stream counters as a process that was never killed (the port
    alone: no JAX in the subprocesses)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(mode, rc=0):
        p = subprocess.run([sys.executable, "-c", _KILL_RESUME, mode, str(tmp_path)],
                           capture_output=True, text=True, env=env, timeout=300)
        assert p.returncode == rc, (mode, p.stdout, p.stderr)
        return p.stdout

    full = run("full")
    run("part1", rc=17)
    assert run("part2") == full and "OUT" in full and "COUNTERS" in full
