"""The port's serving path (``TokenSampler``, ``ServeEngine``, the launcher)
against the JAX package, on the CPU at a tiny width.

The port's CDF rows normalize first and then scan (the kernel's form); the
JAX engine's sampler divides a cumsum by its last entry. The two rows differ
by a few 1e-7, so the same uniform can fall on either side of a CDF
boundary. Tokens are therefore held bit for bit where both sides invert the
same CDF rows, and, where whole engines are compared, a differing token
passes only if every CDF boundary between the two tokens lies within
``SCAN_ATOL`` of the uniform on both sides' rows; that request is compared
no further (its later logits legitimately differ).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.core.alias import build_alias as jax_build_alias
from repro.core.alias import sample_alias as jax_sample_alias
from repro.kernels.ref import ref_cdf_scan as jax_ref_cdf_scan
from repro.models import init_params as jax_init_params
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import TokenSampler as JaxTokenSampler
import repro_torch.configs as TC
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.cdf_scan import SCAN_ATOL
from repro_torch.kernels.ref import ref_cdf_scan
from repro_torch.robust.errors import RequestError
from repro_torch.serve import PooledForestSampler, Request, ServeEngine, TokenSampler

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

ROOT = Path(__file__).resolve().parents[1]
_TINY = dict(dtype="float32", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
             head_dim=16, d_ff=128, vocab=256)


@pytest.fixture(scope="module")
def tiny_lm():
    """(JAX cfg, port cfg, JAX params, port model): the JAX serving tests'
    tiny Qwen1.5 width, JAX's init carried across."""
    jcfg = dataclasses.replace(JC.get_reduced("qwen1_5_0_5b"), **_TINY)
    tcfg = dataclasses.replace(TC.get_reduced("qwen1_5_0_5b"), **_TINY)
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")


def _sampler(n_slots, **kw):
    return TokenSampler(n_slots=n_slots, device="cpu", **kw)


def _engine(model, cfg, n_slots, max_seq=64, **kw):
    return ServeEngine(model, cfg, n_slots=n_slots, max_seq=max_seq,
                       sampler=kw.pop("sampler", None) or _sampler(n_slots),
                       device="cpu", **kw)


# ------------------------------------------------ mirrors of the JAX suite


def test_serve_engine_continuous_batching(tiny_lm):
    _, cfg, _, model = tiny_lm
    rng = np.random.default_rng(0)
    eng = _engine(model, cfg, 4)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=rng.integers(3, 9)),
                    max_new=rng.integers(4, 12)) for i in range(7)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=200)
    for r in reqs:
        assert r.done
        assert len(r.out) >= min(r.max_new, 4)
        assert all(0 <= t < cfg.vocab for t in r.out)


def test_serve_engine_isolation_under_load(tiny_lm):
    """A near-greedy request decodes the same tokens alone and co-batched
    with other traffic: continuous batching leaks no state across slots."""
    _, cfg, _, model = tiny_lm
    prompt = np.asarray([5, 9, 2, 7], np.int64)
    outs = []
    for load in (0, 3):
        eng = _engine(model, cfg, 4, sampler=_sampler(4, temperature=1e-4, seed=1))
        target = Request(rid=0, prompt=prompt, max_new=8)
        eng.submit(target)
        rng = np.random.default_rng(5)
        for i in range(load):
            eng.submit(Request(rid=1 + i, prompt=rng.integers(0, cfg.vocab, size=6),
                               max_new=6))
        eng.run(max_steps=100)
        outs.append(target.out)
    assert outs[0] == outs[1], outs


def test_serve_engine_mixed_model_and_prior_traffic(tiny_lm):
    _, cfg, _, model = tiny_lm
    rng = np.random.default_rng(3)
    eng = _engine(model, cfg, 4)
    lm_reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=5), max_new=5)
               for i in range(2)]
    prior_reqs = [Request(rid=10 + i, prompt=np.zeros(1, np.int64), max_new=5,
                          prior=rng.random(12) + 1e-3) for i in range(3)]
    for r in lm_reqs + prior_reqs:
        eng.submit(r)
    eng.run(max_steps=100)
    for r in lm_reqs:
        assert r.done and all(0 <= t < cfg.vocab for t in r.out)
    for r in prior_reqs:
        assert r.done and all(0 <= t < 12 for t in r.out)
    assert eng.prior_sampler.pool.stats()["tenants"] == 0


def test_prior_slot_pos_stays_bounded_alongside_model_traffic(tiny_lm):
    """Prior-backed slots keep pos at 0 (pos is decode's write index for
    every row), so a long-lived prior outlives the KV budget."""
    _, cfg, _, model = tiny_lm
    rng = np.random.default_rng(8)
    eng = _engine(model, cfg, 3, max_seq=16)
    prior_req = Request(rid=0, prompt=np.zeros(1, np.int64), max_new=40,
                        prior=rng.random(9) + 1e-3)
    lm_req = Request(rid=1, prompt=rng.integers(0, cfg.vocab, size=4), max_new=10)
    eng.submit(prior_req)
    eng.submit(lm_req)
    prior_slot = None
    for _ in range(60):
        eng.step()
        if prior_slot is None and eng.prior_handles:
            prior_slot = next(iter(eng.prior_handles))
        if prior_slot is not None and prior_slot in eng.prior_handles:
            assert eng.pos[prior_slot] == 0
        assert np.all(eng.pos < eng.max_seq)
        if prior_req.done and lm_req.done:
            break
    assert prior_req.done and len(prior_req.out) == 40
    assert lm_req.done and len(lm_req.out) == 10


def test_retired_prior_wider_than_vocab_leaves_decode_running(tiny_lm):
    """A prior with more categories than the vocabulary retires while a
    model request still decodes: its idle slot keeps a pool index beyond
    the vocabulary in ``last_tok``, which decode must never embed."""
    _, cfg, _, model = tiny_lm
    rng = np.random.default_rng(11)
    n = 4 * cfg.vocab
    weights = np.full(n, 1e-6)
    weights[cfg.vocab:] = 1.0
    prior_req = Request(rid=0, prompt=np.zeros(1, np.int64), max_new=2, prior=weights)
    lm_req = Request(rid=1, prompt=rng.integers(0, cfg.vocab, size=4), max_new=8)
    eng = _engine(model, cfg, 2)
    eng.submit(prior_req)
    eng.submit(lm_req)
    eng.run(max_steps=50)
    assert prior_req.done and all(t >= cfg.vocab for t in prior_req.out)
    assert lm_req.done and len(lm_req.out) == 8
    assert all(0 <= t < cfg.vocab for t in lm_req.out)


@pytest.mark.parametrize("mode", ["inverse_qmc", "inverse_rng", "alias"])
def test_token_sampler_modes_agree_on_peaked_logits(mode):
    logits = np.full((3, 256), -20.0, np.float32)
    logits[0, 7], logits[1, 100], logits[2, 1] = 20.0, 20.0, 20.0
    got = _sampler(3, mode=mode).sample(torch.tensor(logits), np.arange(3))
    np.testing.assert_array_equal(got, [7, 100, 1])


def _alias_oracle(p: np.ndarray, xi: np.ndarray) -> list[int]:
    """JAX's per-row build_alias + sample_alias at the given uniforms."""
    return [int(np.asarray(jax_sample_alias(jax_build_alias(p[i]), jnp.float32(xi[i]))))
            for i in range(len(xi))]


def test_token_sampler_alias_routes_through_slot_uniforms():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (4, 32)).astype(np.float32)
    fixed = np.array([0.05, 0.93, 0.42, 0.61], np.float32)
    ts = _sampler(4, mode="alias", seed=0)
    ts.uniforms = lambda slots: fixed[: len(slots)]
    got = ts.sample(torch.tensor(logits), np.arange(4))
    p = torch.softmax(torch.tensor(logits), dim=-1).double().numpy()
    np.testing.assert_array_equal(got, _alias_oracle(p, fixed))


def test_token_sampler_seeded_cross_mode_same_uniforms():
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 1.5, (6, 48)).astype(np.float32)
    seed = 123
    xi = np.random.default_rng(seed).random(6).astype(np.float32)
    got = _sampler(6, mode="alias", seed=seed).sample(torch.tensor(logits), np.arange(6))
    p = torch.softmax(torch.tensor(logits), dim=-1).double().numpy()
    np.testing.assert_array_equal(got, _alias_oracle(p, xi))
    s_inv = _sampler(6, mode="inverse_rng", seed=seed)
    np.testing.assert_array_equal(s_inv.uniforms(np.arange(6)), xi)


# --------------------------------------------------- against the JAX side


@pytest.mark.parametrize("mode", ["inverse_qmc", "inverse_rng"])
@pytest.mark.parametrize("V", [512, 151936])
def test_token_sampler_on_jax_cdf_rows_equals_jax_tokens(mode, V):
    """Same seed, same slots: the port draws JAX's uniforms bit for bit,
    and the port's inverse on JAX's CDF rows gives JAX's tokens bit for
    bit; the port's own rows stay within SCAN_ATOL of JAX's."""
    rng = np.random.default_rng(V)
    logits = rng.normal(0.0, 3.0, (8, V)).astype(np.float32)
    slots = np.asarray([0, 3, 3, 5, 1, 0, 7, 2])
    jax_s = JaxTokenSampler(mode=mode, n_slots=8, temperature=0.7, seed=3, use_pallas=False)
    port = _sampler(8, mode=mode, temperature=0.7, seed=3)
    for _ in range(3):
        want = jax_s.sample(jnp.asarray(logits), slots)
        xi = port.uniforms(slots)
        jcdf = np.asarray(jax_ref_cdf_scan(jnp.asarray(logits) / 0.7))
        got = ops.sample_rows(torch.tensor(jcdf), torch.tensor(xi)[:, None])[:, 0].numpy()
        np.testing.assert_array_equal(got, want)
        mine = ref_cdf_scan(torch.tensor(logits) / 0.7).numpy()
        assert np.abs(mine - jcdf).max() <= SCAN_ATOL
    assert port.snapshot()["streams"]["counters"].tolist() == \
        jax_s.snapshot()["streams"]["counters"].tolist()


@pytest.mark.parametrize("mode", ["inverse_qmc", "inverse_rng", "alias"])
def test_token_sampler_restores_jax_snapshot(mode):
    """A JAX TokenSampler snapshotted mid-stream restores into the port:
    same mode and temperature, and the next uniforms equal JAX's."""
    jax_s = JaxTokenSampler(mode=mode, n_slots=5, temperature=0.5, seed=9, use_pallas=False)
    slots = np.asarray([4, 0, 4, 2])
    jax_s.uniforms(slots)
    port = TokenSampler.restore(jax_s.snapshot(), device="cpu")
    assert (port.mode, port.temperature) == (mode, 0.5)
    for _ in range(3):
        np.testing.assert_array_equal(port.uniforms(slots), jax_s.uniforms(slots))


def test_engine_retire_isolates_per_request_faults():
    """on_fault="retire": a prior whose pool handle went stale retires
    with a structured error; the co-tenants finish normally."""
    rng = np.random.default_rng(5)
    eng = ServeEngine(None, None, n_slots=3, on_fault="retire", device="cpu")
    reqs = [Request(rid=i, prompt=np.zeros(0, np.int64), max_new=6,
                    prior=rng.random(10) + 1e-3) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    victim_slot, victim_handle = next(iter(eng.prior_handles.items()))
    victim = eng.slots[victim_slot]
    eng.prior_sampler.pool.evict(victim_handle)
    eng.run(max_steps=40)
    assert victim.done and victim.error.startswith("stale_handle")
    for r in reqs:
        if r is not victim:
            assert r.done and r.error is None and len(r.out) == 6
    assert eng.prior_sampler.pool.stats()["tenants"] == 0


class _Recorder:
    """Wraps an engine's sampler: records, per call, the rows' request ids,
    the CDF rows the call inverted (recomputed with the sampler's own scan
    form), the uniforms, and the tokens."""

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
            cdf = scan(np.asarray(logits, np.float32) / eng.sampler.temperature)
            self.calls.append((rids, cdf, box["xi"], np.asarray(toks)))
            return toks

        eng.sampler.uniforms = rec_uniforms
        eng.sampler.sample = rec_sample


def _jax_scan(x):
    return np.asarray(jax_ref_cdf_scan(jnp.asarray(x)))


def _port_scan(x):
    return ref_cdf_scan(torch.tensor(x)).numpy()


def _compare_calls(jrec: _Recorder, trec: _Recorder) -> set:
    """Token by token, call by call; returns the request ids that diverged
    at a boundary token (each checked against the boundary rule)."""
    assert len(jrec.calls) == len(trec.calls)
    diverged = set()
    for (jr, jc, jx, jt), (tr, tc, tx, tt) in zip(jrec.calls, trec.calls):
        assert jr == tr
        np.testing.assert_array_equal(jx, tx)  # same uniforms, bit for bit
        for i, rid in enumerate(jr):
            if rid in diverged or jt[i] == tt[i]:
                continue
            a, b = sorted((int(jt[i]), int(tt[i])))
            for cdf in (jc[i], tc[i]):
                gap = np.abs(cdf[a:b] - jx[i]).max()
                assert gap <= SCAN_ATOL, (rid, a, b, gap)
            diverged.add(rid)
    return diverged


def _traffic(cfg, rng, n_lm=6, n_prior=2):
    lens = (3, 5)  # two prompt lengths: two JAX prefill compiles
    specs = [dict(rid=i, prompt=rng.integers(0, cfg.vocab, size=lens[i % 2]),
                  max_new=int(rng.integers(4, 9))) for i in range(n_lm)]
    specs += [dict(rid=100 + i, prompt=np.zeros(1, np.int64), max_new=6,
                   prior=rng.random(10 + i) + 1e-3) for i in range(n_prior)]
    return specs


def _check_outputs(jreqs, treqs, diverged):
    for rid, jr in jreqs.items():
        tr = treqs[rid]
        assert jr.done and tr.done and len(jr.out) == len(tr.out)
        if rid not in diverged:
            assert jr.out == tr.out, rid


def test_engine_streams_match_jax_engine(tiny_lm):
    jcfg, tcfg, jp, model = tiny_lm
    specs = _traffic(jcfg, np.random.default_rng(21))
    jeng = JaxServeEngine(jp, jcfg, n_slots=4, max_seq=32,
                          sampler=JaxTokenSampler(n_slots=4, use_pallas=False, seed=2))
    teng = _engine(model, tcfg, 4, max_seq=32, sampler=_sampler(4, seed=2))
    jrec, trec = _Recorder(jeng, _jax_scan), _Recorder(teng, _port_scan)
    jreqs = {s["rid"]: JaxRequest(**s) for s in specs}
    treqs = {s["rid"]: Request(**s) for s in specs}
    for r in jreqs.values():
        jeng.submit(r)
    for r in treqs.values():
        teng.submit(r)
    jeng.run(max_steps=100)
    teng.run(max_steps=100)
    diverged = _compare_calls(jrec, trec)
    _check_outputs(jreqs, treqs, diverged)
    assert teng.steps == jeng.steps
    assert teng.prior_sampler.pool.stats()["tenants"] == 0


def test_jax_engine_snapshot_restores_into_port(tiny_lm):
    """A model-backed JAX engine snapshotted mid-run (live slots, cache,
    a queued request, prior tenants) continues in the port as in JAX."""
    jcfg, tcfg, jp, model = tiny_lm
    specs = _traffic(jcfg, np.random.default_rng(22))
    jeng = JaxServeEngine(jp, jcfg, n_slots=3, max_seq=32,
                          sampler=JaxTokenSampler(n_slots=3, use_pallas=False, seed=4))
    for s in specs:
        jeng.submit(JaxRequest(**s))
    for _ in range(3):
        jeng.step()
    state = jeng.snapshot()
    assert state["has_model"] and state["cache"] is not None and state["queue"]
    teng = ServeEngine.restore(state, params=model, cfg=tcfg, device="cpu")
    jreqs = {r.rid: r for r in [s for s in jeng.slots if s is not None] + list(jeng.queue)}
    treqs = {r.rid: r for r in [s for s in teng.slots if s is not None] + list(teng.queue)}
    assert set(jreqs) == set(treqs)
    jrec, trec = _Recorder(jeng, _jax_scan), _Recorder(teng, _port_scan)
    jeng.run(max_steps=100)
    teng.run(max_steps=100)
    _check_outputs(jreqs, treqs, _compare_calls(jrec, trec))


def test_port_engine_snapshot_restore_continues_bit_identical(tiny_lm):
    _, cfg, _, model = tiny_lm
    specs = _traffic(cfg, np.random.default_rng(23))
    eng = _engine(model, cfg, 3, max_seq=32, on_fault="retire")
    for s in specs:
        eng.submit(Request(**s))
    for _ in range(4):
        eng.step()
    twin = ServeEngine.restore(eng.snapshot(), params=model, cfg=cfg, device="cpu")
    live = {r.rid: r for r in [s for s in eng.slots if s is not None] + list(eng.queue)}
    copy = {r.rid: r for r in [s for s in twin.slots if s is not None] + list(twin.queue)}
    eng.run(max_steps=100)
    twin.run(max_steps=100)
    for rid, r in copy.items():
        assert r.done and r.out == live[rid].out


def test_engine_submit_validation(tiny_lm):
    _, cfg, _, model = tiny_lm
    z = np.zeros(0, np.int64)
    eng = ServeEngine(None, None, n_slots=2, device="cpu")
    with pytest.raises(RequestError):  # no model, no prior
        eng.submit(Request(rid=1, prompt=z))
    with pytest.raises(RequestError, match="bad_dtype"):
        eng.submit(Request(rid=2, prompt=z, prior=np.asarray(["x", "y"])))
    with pytest.raises(RequestError, match="non_finite"):
        eng.submit(Request(rid=3, prompt=z, prior=np.asarray([1.0, np.nan])))
    with pytest.raises(RequestError, match="prior2d bad_shape"):
        eng.submit(Request(rid=4, prompt=z, prior2d=[np.ones((2, 3))]))
    with pytest.raises(RequestError, match="prior2d negative"):
        eng.submit(Request(rid=5, prompt=z, prior2d=np.asarray([[1.0, -1.0]])))
    assert len(eng.queue) == 0
    eng.submit(Request(rid=4, prompt=z, prior2d=np.ones((2, 3))))  # a 2-D map request
    assert len(eng.queue) == 1
    lenient = ServeEngine(None, None, n_slots=2, device="cpu",
                          prior_sampler=PooledForestSampler(n_slots=2, policy="clamp",
                                                            device="cpu"))
    r = Request(rid=6, prompt=z, prior=np.asarray([1.0, np.nan, 2.0]), max_new=3)
    lenient.submit(r)
    lenient.run(max_steps=20)
    assert r.done and r.error is None and len(r.out) == 3
    with pytest.raises(ValueError, match="model-backed"):
        ServeEngine.restore(_engine(model, cfg, 2).snapshot(), device="cpu")


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen1.5-0.5b",
         "--requests", "3", "--slots", "2", "--max-new", "4", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "served 3/3 requests, 12 tokens" in out.stdout
