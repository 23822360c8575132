"""The port's training path against the JAX package, on the CPU: gradients,
AdamW, the train step, the data mixture and pipeline, checkpoints and the
trainer.

Tolerances, float32 throughout:
* gradients of ``loss_fn`` leaf by leaf (through ``interop.params_to_jax``)
  within ``rtol=1e-4`` plus ``atol=1e-5`` times the leaf's largest entry
  (sums in other orders; on this CPU the worst gap was 1.2e-6 of the
  leaf's maximum);
* ``apply_updates`` on identical parameters, gradients and state within
  ``rtol=1e-6, atol=1e-9`` of JAX's (the same float32 formula; only the
  global norm sums in another order), the schedule within ``rtol=1e-6``;
* three train steps from one JAX state: losses and gradient norms within
  ``rtol=1e-5``;
* microbatches=4 against 1 (port against port): ``atol=1e-5``, as the JAX
  suite's own test;
* the mixture's corpus ids and ``make_batch``'s arrays equal, element for
  element (dyadic weights: exact CDF bits on both sides);
* kill-and-resume (port against port): parameters bit for bit.
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
from repro.data.mixture import MixtureSampler as JaxMixture
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.train import optimizer as jopt
from repro.train.step import make_train_step as jax_make_train_step
import repro_torch.configs as TC
from repro_torch.ckpt import CheckpointManager, latest_step, restore, save
from repro_torch.data import MixtureSampler, make_batch
from repro_torch.interop import named_from_jax, opt_state_from_jax, params_from_jax, params_to_jax
from repro_torch.models import loss_fn
from repro_torch.train import AdamWConfig, TrainConfig, Trainer, apply_updates, init_opt
from repro_torch.train.optimizer import decays, schedule
from repro_torch.train.step import make_train_step

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen1_5_0_5b", "qwen3_4b"]


def _cfgs(arch, **over):
    over = dict(dict(dtype="float32", n_layers=2), **over)
    return (dataclasses.replace(JC.get_reduced(arch), **over),
            dataclasses.replace(TC.get_reduced(arch), **over))


def _tiny(**over):
    """The JAX fault-tolerance suite's tiny config (port side)."""
    return dataclasses.replace(
        TC.get_reduced("qwen1_5_0_5b"), dtype="float32", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=128, **over)


def _carried(arch):
    jcfg, tcfg = _cfgs(arch)
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu",
                            param_dtype=torch.float32)
    return jcfg, tcfg, params, model


def _leaves(tree):
    return [(jax.tree_util.keystr(k), np.asarray(x, np.float32))
            for k, x in jax.tree_util.tree_leaves_with_path(tree)]


def _batch(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[:, :3] = -1
    return {"tokens": toks, "labels": labels}


# ---------------------------------------------------------------- gradients


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch):
    jcfg, tcfg, jp, model = _carried(arch)
    batch = _batch(jcfg.vocab, 2, 32, 0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jax.jit(jax.grad(lambda p: jax_loss_fn(p, jcfg, jbatch)[0]))(jp)
    model.requires_grad_(True)
    loss, _ = loss_fn(model, tcfg, batch)
    loss.backward()
    tg = params_to_jax({n: p.grad for n, p in model.named_parameters()}, tcfg)
    want, got = _leaves(jg), _leaves(tg)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * float(np.abs(a).max()), err_msg=k)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_values(remat):
    """Recomputing in the backward changes nothing: loss and gradients bit
    for bit equal to ``remat="none"``."""
    _, tcfg = _cfgs("qwen3_4b")
    batch = _batch(tcfg.vocab, 2, 16, 1)
    out = []
    for mode in ("none", remat):
        from repro_torch.models import init_params

        model = init_params(tcfg, torch.Generator().manual_seed(0), "cpu").requires_grad_()
        loss, _ = loss_fn(model, tcfg, batch, remat=mode)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- optimizer


def test_decayed_set_matches_jax():
    """AdamW decays exactly JAX's ``ndim >= 2`` leaves: every parameter but
    ``final_norm.scale`` (the stacked per-layer norm scales and QKV biases
    included), though the port's per-layer tensors are unstacked."""
    for arch in ARCHS:
        _, tcfg, jp, model = _carried(arch)
        jax_decayed = {k for k, x in _leaves(jp) if x.ndim >= 2}
        assert jax_decayed == {k for k, _ in _leaves(jp)} - {"['final_norm']['scale']"}
        flags = [(_jax_path_of(n), decays(n, p)) for n, p in model.named_parameters()]
        assert {k for k, _ in flags} == {k for k, _ in _leaves(jp)}
        assert {k for k, d in flags if d} == jax_decayed
        assert not {k for k, d in flags if d} & {k for k, d in flags if not d}


def _jax_path_of(name: str) -> str:
    """The JAX leaf path (``keystr``) a port parameter name belongs to."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = ["layers"] + parts[2:]
    return "".join(f"['{p}']" for p in parts)


def test_apply_updates_matches_jax():
    jcfg, tcfg, jp, model = _carried("qwen3_4b")
    rng = np.random.default_rng(4)
    jg = jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 0.05, x.shape), jnp.float32), jp)
    oc = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10, grad_clip=0.5)
    st = jopt.init_opt(oc, jp)
    st = st._replace(  # non-zero moments at step 3
        step=jnp.asarray(3, jnp.int32),
        m=jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 0.01, x.shape), jnp.float32), jp),
        v=jax.tree.map(lambda x: jnp.asarray(rng.random(x.shape) * 1e-3, jnp.float32), jp))
    tst = opt_state_from_jax(jax.tree.map(np.asarray, st), tcfg, "cpu")
    tgrads = {k: torch.tensor(np.ascontiguousarray(a))
              for k, a in named_from_jax(jax.tree.map(np.asarray, jg), tcfg).items()}
    jnew, jst, jm = jopt.apply_updates(oc, jp, jg, st)  # eager: op for op, no fusion
    _, tst, tm = apply_updates(oc, model, tgrads, tst)
    assert int(tst.step) == int(jst.step) == 4
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for want, got in ((jnew, model), (jst.m, tst.m), (jst.v, tst.v)):
        for (k, a), (_, b) in zip(_leaves(want), _leaves(params_to_jax(got, tcfg))):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9, err_msg=k)


def test_apply_updates_bf16_moments_keep_dtype():
    _, tcfg, _, model = _carried("qwen1_5_0_5b")
    oc = AdamWConfig(opt_dtype="bfloat16")
    st = init_opt(oc, model)
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, st, m = apply_updates(oc, model, grads, st)
    assert all(t.dtype == torch.bfloat16 for t in [*st.m.values(), *st.v.values()])
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert not torch.equal(before["embed"], model.embed)
    assert int(st.step) == 1 and float(m["grad_norm"]) > 1


def test_schedule_matches_jax():
    for oc in (AdamWConfig(), AdamWConfig(warmup_steps=5, total_steps=40, lr=1e-3),
               AdamWConfig(warmup_steps=0, total_steps=1)):
        for s in range(51):
            want = float(jopt.schedule(oc, jnp.asarray(s, jnp.int32)))
            got = float(schedule(oc, torch.tensor(s, dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=f"{oc} step {s}")


# --------------------------------------------------------------- train step


def test_train_steps_match_jax():
    """Three steps from one JAX state on the same make_batch batches: loss
    and gradient norm of each step within rtol 1e-5."""
    jcfg, tcfg, jp, model = _carried("qwen1_5_0_5b")
    model.requires_grad_(True)
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jst = jopt.init_opt(oc, jp)
    tst = opt_state_from_jax(jax.tree.map(np.asarray, jst), tcfg, "cpu")
    jstep = jax.jit(jax_make_train_step(jcfg, oc, remat="none"))
    tstep = make_train_step(tcfg, oc, remat="none")
    mixture = MixtureSampler((0.5, 0.25, 0.125, 0.125), device="cpu")
    for step in range(3):
        batch = make_batch(tcfg, step, 4, 32, mixture=mixture)
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in batch.items()})
        model, tst, tm = tstep(model, tst, batch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=f"step {step} {key}")
    assert int(tst.step) == int(jst.step) == 3


def test_microbatch_accumulation_matches_full_batch():
    """grad-accum over 4 microbatches == single-batch step (float reorder
    noise only): the JAX suite's test, port against port."""
    cfg = _tiny()
    from repro_torch.models import init_params

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 128, (8, 16)), "labels": rng.integers(0, 128, (8, 16))}
    oc = AdamWConfig()
    out = []
    for k in (1, 4):
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            param_dtype=torch.float32).requires_grad_()
        model, _, m = make_train_step(cfg, oc, remat="none", microbatches=k)(
            model, init_opt(oc, model), batch)
        out.append((model, m))
    (p1, m1), (p4, m4) = out
    for a, b in zip(p1.parameters(), p4.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-5


# -------------------------------------------------------------------- data


@pytest.mark.parametrize("qmc", [True, False])
def test_mixture_ids_equal_jax(qmc):
    w = (0.5, 0.25, 0.125, 0.125)
    jm, tm = JaxMixture(w, seed=3), MixtureSampler(w, seed=3, device="cpu")
    assert tm.offset == jm.offset
    for step in range(21):
        np.testing.assert_array_equal(tm.sample(step, 37, qmc=qmc),
                                      np.asarray(jm.sample(step, 37, qmc=qmc)))


def test_mixture_update_weights_equal_jax():
    jm = JaxMixture((0.5, 0.25, 0.125, 0.125), seed=1)
    tm = MixtureSampler((0.5, 0.25, 0.125, 0.125), seed=1, device="cpu")
    for kw in (dict(weights=(1.0, 1.0, 1.0, 5.0)), dict(delta=(4.0, 0.0, 0.0, -4.0))):
        jm.update_weights(**kw)
        tm.update_weights(**kw)
        np.testing.assert_array_equal(tm.weights, jm.weights)
        for step in (0, 7):
            np.testing.assert_array_equal(tm.sample(step, 64), np.asarray(jm.sample(step, 64)))
    with pytest.raises(ValueError):
        tm.update_weights()


def test_make_batch_equal_jax():
    jcfg, tcfg = _cfgs("qwen1_5_0_5b")
    w = (0.5, 0.25, 0.125, 0.125)
    jm, tm = JaxMixture(w, seed=0), MixtureSampler(w, seed=0, device="cpu")
    for step in range(3):
        want = jax_make_batch(jcfg, step, 8, 24, mixture=jm, seed=5)
        got = make_batch(tcfg, step, 8, 24, mixture=tm, seed=5)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_mixture_refusals():
    with pytest.raises(RuntimeError, match="process group"):
        MixtureSampler((0.5, 0.5), sharded=True, device="cpu")  # no group initialized
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MixtureSampler((0.5, 0.5))


# ------------------------------------------------------ checkpoints, trainer


def _tc(tmp, **kw):
    d = dict(steps=12, global_batch=4, seq_len=16, ckpt_dir=str(tmp / "ck"),
             ckpt_every=5, log_every=100)
    d.update(kw)
    return TrainConfig(**d)


def _trainer(cfg, tc, **kw):
    return Trainer(cfg, tc, log_fn=lambda s: None, device="cpu", **kw)


def test_kill_and_resume_bitwise(tmp_path):
    """Crash at step 7, resume from the step-5 checkpoint: final parameters
    and moments bit for bit equal to an uninterrupted run."""
    cfg = _tiny()
    ref = _trainer(cfg, _tc(tmp_path / "a")).run()
    crashy = _trainer(cfg, _tc(tmp_path / "b"), fail_at_step=7)
    with pytest.raises(RuntimeError, match="injected failure"):
        crashy.run()
    assert latest_step(str(tmp_path / "b" / "ck")) == 5
    resumed = _trainer(cfg, _tc(tmp_path / "b")).run()
    assert int(resumed["opt"].step) == int(ref["opt"].step) == 12
    for (n, a), (_, b) in zip(ref["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), n
    for k in ref["opt"].m:
        assert torch.equal(ref["opt"].m[k], resumed["opt"].m[k])
        assert torch.equal(ref["opt"].v[k], resumed["opt"].v[k])


def test_atomic_save_never_corrupts(tmp_path):
    tree = {"w": torch.arange(16.0), "b": torch.ones((4, 4), dtype=torch.bfloat16),
            "n": np.arange(3)}
    save(tmp_path, tree, 1)
    # a stale tmp dir from a crashed save must be ignored by latest_step
    (tmp_path / "step_00000002.tmp").mkdir()
    assert latest_step(tmp_path) == 1
    got, step = restore(tmp_path, tree)
    assert step == 1
    assert torch.equal(got["w"], torch.arange(16.0))
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"], tree["b"])
    np.testing.assert_array_equal(got["n"], np.arange(3))
    with pytest.raises(ValueError, match="shape"):
        restore(tmp_path, {"w": torch.zeros(3), "b": tree["b"], "n": tree["n"]})


def test_keep_last_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(tree, s)
    steps = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]


def test_async_save_worker_failure_surfaces(tmp_path, monkeypatch):
    """An async checkpoint writer that dies must not fail silently: the
    exception is re-raised on the next save()/wait()."""
    import repro_torch.ckpt.checkpoint as ck

    mgr = ck.CheckpointManager(tmp_path, async_save=True)
    tree = {"x": torch.zeros(3)}
    mgr.save(tree, 1)
    mgr.wait()  # healthy write: no error
    assert latest_step(tmp_path) == 1

    real_save = ck.save

    def boom(root, t, step):
        raise OSError("injected: no space left on device")

    monkeypatch.setattr(ck, "save", boom)
    mgr.save(tree, 2)  # worker fails in the background
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    # ...and the pending error also surfaces through the next save()
    mgr.save(tree, 3)
    monkeypatch.setattr(ck, "save", real_save)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.save(tree, 4)
    assert latest_step(tmp_path) == 1  # the failed steps never became visible
    mgr.save(tree, 5)  # recovered: the error was consumed, not sticky
    mgr.wait()
    assert latest_step(tmp_path) == 5


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    x = torch.zeros(1 << 16)
    mgr.save({"x": x}, 1)
    x += 1.0   # the trainer's next step updates in place
    mgr.wait()
    got, _ = restore(tmp_path, {"x": x})
    assert float(got["x"].abs().max()) == 0.0


def test_loss_decreases(tmp_path):
    cfg = _tiny()
    oc = AdamWConfig(lr=2e-3, total_steps=40, warmup_steps=4)
    out = _trainer(cfg, _tc(tmp_path, steps=40, ckpt_every=1000), oc=oc).run()
    first = out["metrics"][0]["loss"]
    last = out["metrics"][-1]["loss"]
    assert last < first - 0.1, (first, last)


def test_launcher_runs_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
         "--preset", "reduced", "--steps", "2", "--batch", "2", "--seq", "16",
         "--ckpt", str(tmp_path / "ck"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done: final loss" in out.stdout
    assert latest_step(tmp_path / "ck") == 2
