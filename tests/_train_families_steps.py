"""The checks of the families' train steps, microbatches, Trainer and
checkpoints against the JAX package, on the CPU at reduced widths in
float32 (Jamba one period: ``PERIOD_CUT``), shared by the test files that
run them: ``tests/test_torch_train_families_steps.py`` (Llama 4, Whisper,
InternVL, xLSTM), ``..._kimi.py`` (Kimi K2, with the MoE microbatch
tests), ``..._jamba.py`` (Jamba's steps and checkpoint tree) and
``..._jamba_trainer.py`` (Jamba's Trainer pair). They are files of
similar cost, so pytest-xdist's ``--dist loadfile`` runs them side by side;
the two tests that share one family's ``_trainer_runs`` stay in one file,
since its cache lives in one process. The model helpers are
``tests/test_torch_train_families.py``'s.

Tolerances:
* three ``make_train_step`` steps from one JAX state: losses, gradient
  norms and learning rates within ``rtol=1e-5``, at ``lr=1e-3``, Jamba at
  ``lr=1e-4`` (``LR``). AdamW's first update is about ``lr * sign(g)`` for
  every entry, so an entry whose gradient lies at float32's noise moves by
  ``2 lr`` one way in one package and the other way in the other, and MoE
  routing switches on such moves; at ``lr=1e-3`` reduced Jamba's (16
  layers) third step read a gradient norm 8.0e-5 apart and its Trainer's
  fifth loss 3.0e-4 apart (their first steps 5.6e-7 and 7.5e-8), at
  ``lr=1e-4`` within 1e-6;
* ``microbatches=2`` against 1 for Kimi K2 (port against port, one dispatch
  group a row on both sides, so the capacity groups and the aux loss are
  the same sums): ``atol=1e-5``; against JAX's ``microbatches=2``:
  ``rtol=1e-5``;
* the Trainer against JAX's Trainer, and resumed from a JAX checkpoint
  killed at step 2: losses within ``rtol=1e-5`` (dyadic mixture weights,
  so the corpus ids are equal);
* the Trainer's checkpoint tree of a JAX state: equal leaf for leaf.
"""
import functools
import shutil
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.train import optimizer as jopt
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.trainer import TrainConfig as JaxTrainConfig
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.data import MixtureSampler, make_batch
from repro_torch.interop import opt_state_from_jax
from repro_torch.models import moe as M
from repro_torch.train import AdamWConfig, TrainConfig, Trainer, init_opt
from repro_torch.train.step import make_train_step
from test_torch_train_families import MIXTURE, S, _jax_state, _model

# (JAX's backend starts at collection, in the module imported above.)

TB, STEPS = 4, 4             # the steps' and the trainers' batch rows, trainer steps
LR = {"jamba_1_5_large_398b": 1e-4}  # else 1e-3; see the module docstring


def _oc(arch: str) -> AdamWConfig:
    return AdamWConfig(lr=LR.get(arch, 1e-3), warmup_steps=1, total_steps=10)


@functools.cache
def _jax_step(arch: str):
    """JAX's jitted train step (remat none), shared by the step and trainer
    tests so each family compiles once."""
    jcfg, _, _ = _jax_state(arch, cut=True)
    return jax.jit(jax_make_train_step(jcfg, _oc(arch), remat="none"))


# --------------------------------------------------------------- train step


def check_train_steps_match_jax(arch):
    """Three steps from one JAX state on the same make_batch batches: loss,
    gradient norm and learning rate of each step within rtol 1e-5."""
    _, tcfg, jp = _jax_state(arch, cut=True)
    model = _model(arch, cut=True)
    jst = jopt.init_opt(_oc(arch), jp)
    tst = opt_state_from_jax(jax.tree.map(np.asarray, jst), tcfg, "cpu")
    jstep, tstep = _jax_step(arch), make_train_step(tcfg, _oc(arch), remat="none")
    mixture = MixtureSampler(MIXTURE, device="cpu")
    for step in range(3):
        batch = make_batch(tcfg, step, TB, S, mixture=mixture)
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in batch.items()})
        model, tst, tm = tstep(model, tst, batch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=f"step {step} {key}")
    assert int(tst.step) == int(jst.step) == 3


def _micro_batch(tcfg):
    return make_batch(tcfg, 2, TB, S, mixture=MixtureSampler(MIXTURE, device="cpu"))


def check_microbatches_match_full_batch_moe(monkeypatch):
    """Kimi K2 (MoE with the aux loss): two microbatches against one batch,
    port against port. One dispatch group a row on both sides
    (``GROUP_TOKENS`` = S), so each group's capacity and aux terms are the
    same; the batch mean of the aux is then the mean of the microbatches'."""
    _, tcfg, _ = _jax_state("kimi_k2_1t_a32b", cut=True)
    monkeypatch.setattr(M, "GROUP_TOKENS", S)
    batch = _micro_batch(tcfg)
    oc = _oc("kimi_k2_1t_a32b")
    out = []
    for k in (1, 2):
        model = _model("kimi_k2_1t_a32b", cut=True)
        model, _, m = make_train_step(tcfg, oc, remat="none", microbatches=k)(
            model, init_opt(oc, model), batch)
        out.append((model, m))
    (p1, m1), (p2, m2) = out
    for (n, a), b in zip(p1.named_parameters(), p2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5, err_msg=n)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) < 1e-5


def check_microbatches_match_jax_moe():
    """Kimi K2 with ``microbatches=2`` against JAX's: loss and gradient norm
    within rtol 1e-5."""
    jcfg, tcfg, jp = _jax_state("kimi_k2_1t_a32b", cut=True)
    batch = _micro_batch(tcfg)
    oc = _oc("kimi_k2_1t_a32b")
    jstep = jax.jit(jax_make_train_step(jcfg, oc, remat="none", microbatches=2))
    _, _, jm = jstep(jp, jopt.init_opt(oc, jp), {k: jnp.asarray(v) for k, v in batch.items()})
    model = _model("kimi_k2_1t_a32b", cut=True)
    model, _, tm = make_train_step(tcfg, oc, remat="none", microbatches=2)(
        model, init_opt(oc, model), batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)


# ------------------------------------------------------- trainers, layouts


@functools.cache
def _trainer_runs(arch: str, root: str):
    """JAX's Trainer killed at step 2 (after its step-2 checkpoint) and
    resumed, with every step's loss recorded; the port's Trainer from
    JAX's init through all steps; and the port's Trainer resumed from a
    copy of the killed run's checkpoint directory."""
    jcfg, tcfg, jp = _jax_state(arch, cut=True)
    base, oc = Path(root) / arch, _oc(arch)

    def tc(cls, name, every=2):
        return cls(steps=STEPS, global_batch=TB, seq_len=S, ckpt_dir=str(base / name),
                   ckpt_every=every, keep=STEPS, log_every=1, remat="none",
                   mixture_weights=MIXTURE)

    jt = JaxTrainer(jcfg, tc(JaxTrainConfig, "jax"), oc=oc, fail_at_step=2, log_fn=lambda s: None)
    jstep, jax_losses = _jax_step(arch), []

    def recorded(*args):
        out = jstep(*args)
        jax_losses.append(float(out[2]["loss"]))
        return out

    jt.step_fn = recorded
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        jt.run()
    shutil.copytree(base / "jax", base / "port_resumed")
    jt.fail_at_step = None
    jt.run()

    port = Trainer(tcfg, tc(TrainConfig, "port", every=STEPS), oc=oc, log_fn=lambda s: None,
                   device="cpu")
    port.init_state = lambda: (lambda m: (m, init_opt(oc, m)))(_model(arch, cut=True))
    full = [m["loss"] for m in port.run()["metrics"]]
    logs = []
    resumed = Trainer(tcfg, tc(TrainConfig, "port_resumed"), oc=oc, log_fn=logs.append,
                      device="cpu").run()
    assert "resumed from step 2" in logs
    return jax_losses, full, [m["loss"] for m in resumed["metrics"]]


def check_trainer_matches_jax_trainer(arch, tmp_path_factory):
    """The port's Trainer from JAX's init: every step's loss within rtol
    1e-5 of JAX's Trainer's (whose run was killed at step 2 and resumed,
    which JAX's own suite holds equal to an unbroken run)."""
    jax_losses, full, _ = _trainer_runs(arch, str(tmp_path_factory.getbasetemp()))
    assert len(jax_losses) == len(full) == STEPS
    np.testing.assert_allclose(full, jax_losses, rtol=1e-5)


def check_jax_checkpoint_resumes_in_port(arch, tmp_path_factory):
    """A JAX trainer checkpoint killed at step 2 resumes in the port: the
    remaining losses within rtol 1e-5 of JAX's own resumed run."""
    jax_losses, _, resumed = _trainer_runs(arch, str(tmp_path_factory.getbasetemp()))
    assert len(resumed) == STEPS - 2
    np.testing.assert_allclose(resumed, jax_losses[2:], rtol=1e-5)


def check_trainer_tree_is_jax_layout(arch, tmp_path):
    """The Trainer's checkpoint tree of a JAX state carried across equals
    the JAX state leaf for leaf: the same paths (expert stacks, Mamba,
    mLSTM/sLSTM, cross-attention, the encoder stack, no embed under the
    embed frontend), shapes, dtypes and values."""
    jcfg, tcfg, jp = _jax_state(arch)
    st = jopt.init_opt(_oc(arch), jp)
    st = st._replace(step=jnp.asarray(7, jnp.int32),
                     m=jax.tree.map(lambda x: x * 0.5, jp), v=jax.tree.map(jnp.square, jp))
    tst = opt_state_from_jax(jax.tree.map(np.asarray, st), tcfg, "cpu")
    tr = Trainer(tcfg, TrainConfig(ckpt_dir=str(tmp_path)), log_fn=lambda s: None, device="cpu")
    tree_p, tree_o = tr._tree(_model(arch), tst)
    got, want = (tree_p, tuple(tree_o)), (jp, tuple(st))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (k, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(want),
                              jax.tree_util.tree_leaves_with_path(got)):
        b = b.detach().numpy()
        assert b.dtype == np.asarray(a).dtype and b.shape == a.shape, jax.tree_util.keystr(k)
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=jax.tree_util.keystr(k))
