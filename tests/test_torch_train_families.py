"""Training of every LM family in the port against the JAX package, on the
CPU at reduced widths in float32: gradients, remat, the Mamba scan's
backward, AdamW's in-place update, the analytic FLOP model and the shapes,
the launcher. The train steps, microbatches, trainers and checkpoints are
in ``tests/test_torch_train_families_steps.py``, ``..._kimi.py``,
``..._jamba.py`` and ``..._jamba_trainer.py`` (checks in
``tests/_train_families_steps.py``), which share the helpers here (files
of similar cost, so pytest-xdist's workers run them side by side).

Tolerances:
* ``loss_fn`` gradients leaf by leaf (through ``interop.params_to_jax``)
  within ``rtol=1e-4`` plus ``atol`` times the leaf's largest entry:
  ``1e-5`` for the 2- and 4-layer families, as
  ``tests/test_torch_train.py``; ``3e-5`` for Jamba, whose reduced config
  is 16 layers deep. There both packages' float32 gradients stray up to
  ~1.7e-5 of a leaf's largest entry from a float64 evaluation of the same
  model (``tools/grad_noise_f64.py``), so two float32 evaluations can
  differ by ~2e-5; the scan is not the cause (with the port's scan in
  float64 the gap stays);
* ``remat`` ``"dots"``/``"full"`` against ``"none"`` (port against port):
  loss and gradients bit for bit;
* the Mamba scan: ``gradcheck`` in float64; the forward bit for bit equal
  to the in-place scan the port served with before it had a backward; the
  backward against autograd through an out-of-place scan, float32,
  ``rtol=1e-5``, ``atol=1e-6`` of the largest entry;
* AdamW's in-place update: bit for bit the out-of-place formula;
* the analytic model, the cell matrix and the shapes: equal.

Reduced Jamba is 16 layers, two periods; the remat test and the steps file
train one period (``PERIOD_CUT``), every block kind still in it, to keep
the suite's run short. The gradient test keeps both periods.
"""
import dataclasses
import functools
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
from repro.launch import analytic as jax_analytic
from repro.launch import shapes as jax_shapes
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
import repro_torch.configs as TC
from repro_torch.ckpt import latest_step
from repro_torch.data import make_batch
from repro_torch.interop import params_from_jax, params_to_jax
from repro_torch.launch import analytic, shapes
from repro_torch.models.layout import leaf_map, named_to_jax, stacked
from repro_torch.models.ssm import ssm_scan
from repro_torch.train import AdamWConfig, apply_updates, init_opt
from repro_torch.train.optimizer import decays, schedule
from repro_torch.train.step import loss_and_grads
from _torch_threads import one_torch_thread  # noqa: F401 (pytestmark uses it)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["jamba_1_5_large_398b", "llama4_maverick_400b_a17b", "kimi_k2_1t_a32b",
            "whisper_small", "internvl2_76b", "xlstm_1_3b"]
GRAD_ATOL = {"jamba_1_5_large_398b": 3e-5}  # of the leaf's largest entry; else 1e-5
PERIOD_CUT = {"jamba_1_5_large_398b": dict(n_layers=8)}  # one period (see above)
B, S = 2, 16                 # the gradient batch
MIXTURE = (0.5, 0.25, 0.125, 0.125)


def _cfgs(arch: str, **over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(JC.get_reduced(arch), **over),
            dataclasses.replace(TC.get_reduced(arch), **over))


@functools.cache
def _jax_state(arch: str, cut: bool = False):
    """(JAX cfg, port cfg, JAX init params); ``cut``: ``PERIOD_CUT``'s
    depth."""
    jcfg, tcfg = _cfgs(arch, **(PERIOD_CUT.get(arch, {}) if cut else {}))
    return jcfg, tcfg, jax_init_params(jax.random.PRNGKey(0), jcfg)


def _model(arch: str, cut: bool = False):
    """A fresh port model holding JAX's init, float32 masters, trainable."""
    _, tcfg, jp = _jax_state(arch, cut)
    return params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu",
                           param_dtype=torch.float32).requires_grad_(True)


def _leaves(tree):
    return [(jax.tree_util.keystr(k), np.asarray(x, np.float32))
            for k, x in jax.tree_util.tree_leaves_with_path(tree)]


# ---------------------------------------------------------------- gradients


@pytest.mark.parametrize("arch", FAMILIES)
def test_grads_match_jax(arch):
    jcfg, tcfg, jp = _jax_state(arch)
    batch = make_batch(tcfg, 0, B, S)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jax.jit(jax.grad(lambda p: jax_loss_fn(p, jcfg, jbatch)[0]))(jp)
    _, grads = loss_and_grads(_model(arch), tcfg, batch)
    want, got = _leaves(jg), _leaves(params_to_jax(grads, tcfg))
    assert [k for k, _ in got] == [k for k, _ in want]
    atol = GRAD_ATOL.get(arch, 1e-5)
    for (k, a), (_, b) in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=atol * float(np.abs(a).max()),
                                   err_msg=k)


@functools.cache
def _no_remat(arch: str):
    """Loss and gradients with ``remat="none"`` on the cut model and batch
    of :func:`test_remat_keeps_gradients` (shared by both remat modes)."""
    _, tcfg, _ = _jax_state(arch, cut=True)
    return loss_and_grads(_model(arch, cut=True), tcfg, make_batch(tcfg, 1, B, S))


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_keeps_gradients(arch, remat):
    """Recomputing in the backward changes nothing: loss and gradients bit
    for bit equal to ``remat="none"``."""
    _, tcfg, _ = _jax_state(arch, cut=True)
    batch = make_batch(tcfg, 1, B, S)
    l0, g0 = _no_remat(arch)
    l1, g1 = loss_and_grads(_model(arch, cut=True), tcfg, batch, remat=remat)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_apply_updates_in_place_keeps_the_formula(opt_dtype, param_dtype):
    """AdamW updates float32 state in place; the result is bit for bit the
    out-of-place formula (JAX's, as ``test_torch_train.py`` holds it), and
    the caller's gradients are left as they were."""
    c = AdamWConfig(opt_dtype=opt_dtype, grad_clip=0.5)
    gen = torch.Generator().manual_seed(0)
    ps = {"layers.0.w": torch.randn(64, 33, generator=gen).to(param_dtype),
          "final_norm.scale": torch.randn(33, generator=gen).to(param_dtype)}
    grads = {k: torch.randn(p.shape, generator=gen) for k, p in ps.items()}
    st = init_opt(c, ps)._replace(step=torch.tensor(3, dtype=torch.int32))
    for k, p in ps.items():
        st.m[k].copy_(torch.randn(p.shape, generator=gen) * 0.1)
        st.v[k].copy_(torch.rand(p.shape, generator=gen) * 0.01)
    want = {k: p.clone() for k, p in ps.items()}
    wm, wv = {k: t.clone() for k, t in st.m.items()}, {k: t.clone() for k, t in st.v.items()}
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
    scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    sf = torch.tensor(4.0)
    b1c, b2c = 1 - torch.pow(torch.tensor(c.b1), sf), 1 - torch.pow(torch.tensor(c.b2), sf)
    lr = schedule(c, torch.tensor(4, dtype=torch.int32))
    for k, p in want.items():
        g = grads[k] * scale
        m32 = wm[k].to(torch.float32) * c.b1 + g * (1 - c.b1)
        v32 = wv[k].to(torch.float32) * c.b2 + g * g * (1 - c.b2)
        u = (m32 / b1c) / (torch.sqrt(v32 / b2c) + c.eps)
        u = u + c.weight_decay * p.to(torch.float32) if decays(k, p) else u
        p.copy_(p.to(torch.float32) - lr * u)
        wm[k].copy_(m32)
        wv[k].copy_(v32)
    before = {k: g.clone() for k, g in grads.items()}
    apply_updates(c, ps, grads, st)
    for k in ps:
        assert torch.equal(ps[k], want[k]) and torch.equal(grads[k], before[k]), k
        assert torch.equal(st.m[k], wm[k]) and torch.equal(st.v[k], wv[k]), k


# ----------------------------------------------------------- the Mamba scan


def _inplace_scan(a, bx):
    """The scan as the port ran it before it had a backward (in place)."""
    a, h = a.clone(), bx.clone()
    n, d = a.shape[1], 1
    while d < n:
        h[:, d:] = torch.addcmul(h[:, d:], a[:, d:], h[:, :-d])
        a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return h


def _outofplace_scan(a, bx):
    """The same rounds out of place: autograd differentiates it round by
    round, keeping every round's state."""
    n, d, h = a.shape[1], 1, bx
    while d < n:
        h = torch.cat([h[:, :d], h[:, d:] + a[:, d:] * h[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return h


def _scan_inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(shape, generator=g, dtype=dtype) * 0.5 + 0.5   # decays in (0.5, 1)
    return a, torch.randn(shape, generator=g, dtype=dtype)


def test_ssm_scan_gradcheck():
    a, bx = _scan_inputs((2, 7, 3, 2), torch.float64, 0)
    assert torch.autograd.gradcheck(ssm_scan, (a.requires_grad_(), bx.requires_grad_()))


@pytest.mark.parametrize("n", [1, 2, 5, 16, 33])
def test_ssm_scan_forward_bits_unchanged(n):
    a, bx = _scan_inputs((2, n, 5, 4), torch.float32, n)
    assert torch.equal(ssm_scan(a, bx), _inplace_scan(a, bx))


def test_ssm_scan_backward_matches_autograd():
    a, bx = _scan_inputs((2, 37, 6, 4), torch.float32, 1)
    dh = torch.randn(a.shape, generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(ssm_scan(a.requires_grad_(), bx.requires_grad_()), (a, bx), dh)
    want = torch.autograd.grad(_outofplace_scan(a, bx), (a, bx), dh)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6 * float(y.abs().max()))


# --------------------------------------------------- analytic and shapes


ALL_ARCHS = list(TC.ARCHS)


def test_arch_lists_equal():
    assert list(TC.ARCHS) == list(JC.ARCHS)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_analytic_matches_jax(arch):
    for cfgs in ((JC.get(arch), TC.get(arch)), _cfgs(arch)):
        jcfg, tcfg = cfgs
        for sh in jax_shapes.SHAPES.values():
            for remat in ("dots", "none", "full"):
                assert analytic.step_flops(tcfg, sh.kind, sh.seq_len, sh.global_batch, remat) \
                    == jax_analytic.step_flops(jcfg, sh.kind, sh.seq_len, sh.global_batch, remat)
            assert analytic.step_bytes(tcfg, sh.kind, sh.seq_len, sh.global_batch) \
                == jax_analytic.step_bytes(jcfg, sh.kind, sh.seq_len, sh.global_batch)


def test_shapes_and_cells_match_jax():
    assert shapes.cell_matrix() == jax_shapes.cell_matrix()
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jax_shapes.SHAPES.items()}


def _struct(x):
    """(shape, dtype name) of a JAX struct or a meta tensor."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    return tuple(x.shape), str(x.dtype)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_structs_match_jax(arch):
    """``params_struct`` (the LM on ``meta``), mapped to JAX's layout,
    equals JAX's ``eval_shape`` leaves, so the byte counts are equal; the
    batch, cache and decode-input structs of every shape too."""
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    model = shapes.params_struct(tcfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    got = named_to_jax(dict(model.named_parameters()), tcfg)
    want = jax_shapes.params_struct(jcfg)
    assert jax.tree.map(_struct, got) == jax.tree.map(_struct, want)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert nbytes == sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(want))
    for sh in jax_shapes.SHAPES.values():
        assert jax.tree.map(_struct, shapes.batch_specs_struct(tcfg, sh)) \
            == jax.tree.map(_struct, jax_shapes.batch_specs_struct(jcfg, sh))
    sh = jax_shapes.SHAPES["decode_32k"]
    got = shapes.decode_inputs_struct(tcfg, sh)
    want = jax_shapes.decode_inputs_struct(jcfg, sh)
    assert {k: _struct(v) for k, v in got.items() if k != "cache"} \
        == {k: _struct(v) for k, v in want.items() if k != "cache"}
    assert jax.tree.map(_struct, got["cache"]) == jax.tree.map(_struct, want["cache"])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decay_mask_matches_jax(arch):
    """AdamW decays exactly JAX's ``p.ndim >= 2`` leaves in every arch
    (ROADMAP C8), read off the published configs' structs."""
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    want = jax_shapes.params_struct(jcfg)
    params = dict(shapes.params_struct(tcfg).named_parameters())
    seen = set()
    for path, name, _, _ in leaf_map(tcfg):
        leaf = want
        for k in path:
            leaf = leaf[k]
        n = stacked(tcfg, path)
        for p in range(n or 1):
            nm = name.format(p=p) if n else name
            assert decays(nm, params[nm]) == (len(leaf.shape) >= 2), nm
            seen.add(nm)
    assert seen == set(params)


# ---------------------------------------------------------------- launcher


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "whisper-small", "internvl2-76b"])
def test_launcher_trains_every_frontend(arch, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--preset", "reduced", "--steps", "2", "--batch", "2", "--seq", "8",
         "--ckpt", str(tmp_path / "ck"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done: final loss" in out.stdout
    assert latest_step(tmp_path / "ck") == 2
