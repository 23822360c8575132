"""The port's LM ``dist`` layer at world sizes 2 and 4: gloo ranks on the
CPU, one subprocess per size whose ranks ``torch.multiprocessing.spawn``
starts (the script is written to a file, which spawn re-imports by path),
as ``tests/test_torch_dist_forest.py`` runs its ranks. JAX's references are
computed here and handed over in a pickle; the subprocesses import no JAX.
JAX's ``gpipe`` and pod all-reduce need a mesh of several devices, so they
run in one more subprocess with 4 fake host devices (``gpipe``'s gradient
taken inside ``jax.set_mesh``: ROADMAP C5).

Meshes: (data 1, model 2) at world size 2, (data 2, model 2) at 4. Each
world size's subprocess runs once; its checks are in sections (each
train policy and case, each decode case, ``gpipe``, the all-reduce, the
restore, the trainer), rank 0 prints a line when every rank has passed
one, and each section is a test (``exit``: every rank ended cleanly). A
failure ends every rank, so it fails its section and those after. At
each world size:

* On reduced Qwen1.5-0.5B in float32 (dense, 4 heads over 4 KV heads) and
  a grouped-query variant of it with 6 query heads over 3 KV heads (the KV
  heads do not divide the TP size, so ``_sanitize`` leaves k/v whole while
  q's heads shard), under ``Policy.for_mesh``, ``Policy.recommended(...,
  "train")`` and, at 4, a 2-D TP policy: gradients within ``rtol=1e-4``
  plus ``1e-5`` of the leaf's largest entry of the unsharded port's and of
  ``jax.grad``'s (the tolerance of ``tests/test_torch_train.py``); one
  ``make_train_step`` step's loss and gradient norm within ``rtol=1e-5``
  of both, its AdamW moments at the gradient tolerance of both, and its
  parameters within ``atol=1e-5`` of both. Sharded sums reorder, so none
  of it is bitwise. The step runs at ``lr=2e-6``: AdamW's first update
  moves every entry by about ``lr`` whatever its gradient, so an entry
  whose gradient sits at float32 noise moves ``lr`` one way in one run and
  the other way in another; at ``2e-6`` that is inside ``1e-5``. The update
  itself is held where the gradient is above ``1e-3`` of its leaf's
  largest (over half of all entries): there every parameter is within two
  float32 spacings plus ``1e-3 lr`` of both, so an update skipped, of the
  wrong sign or written to another shard (each off by about ``lr``) fails.
  The unsharded port's answers are computed once, here.
* The forward with ``gather_weights``/``seq_shard`` hints within ``1e-5``
  of the unhinted sharded forward and of JAX's; the hinted gradients with
  ``remat="full"`` (each period recomputed in the backward, after the
  hints' block has closed) at the gradient tolerance above.
* Four decode steps on a cache placed by ``cache_spec_tree`` (batch over
  ``data``, KV heads over ``model`` where they divide): logits and the
  whole cache within ``1e-5`` of the unsharded steps; every rank's local
  cache shard holds the rows and heads the placement gives it.
* ``gpipe`` at S = world size: the sequential loop exactly, its gradient
  (summed over the stages) within ``2e-5`` of the sequential gradient; both
  within ``2e-5`` of JAX's ``gpipe``; layers that do not divide raise.
* ``make_pod_allreduce``: uncompressed within ``1e-7`` of the mean;
  compressed bit for bit JAX's shared-scale result on the same shards and
  within 2% (largest error over largest entry) of the mean.
* ``ckpt.restore(shardings=)`` of a JAX-layout tree saved unsharded: every
  rank's local shards equal the slices of the saved arrays; a sharded
  ``Trainer`` resumes an unsharded run's checkpoint with its losses within
  ``rtol=1e-5``.
"""
import dataclasses
import functools
import os
import pickle
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
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.train import optimizer as jopt
from repro.train.step import make_train_step as jax_make_train_step
import repro_torch.configs as TC
from repro_torch import ckpt
from repro_torch.interop import params_from_jax
from repro_torch.models import forward
from repro_torch.models.layout import named_from_jax
from repro_torch.train import AdamWConfig, TrainConfig, Trainer, init_opt
from repro_torch.train.step import loss_and_grads, make_train_step

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

ROOT = Path(__file__).resolve().parents[1]
CASES = {"dense": {}, "gqa": dict(n_heads=6, n_kv_heads=3)}
B, S, LR = 4, 16, 2e-6
# the policies of the train sections at each world size (meshes (1, 2), (2, 2))
POLICIES = {2: ("for_mesh", "recommended"), 4: ("for_mesh", "recommended", "tp2d")}
PIPE = dict(M=3, mb=2, D=8)


def _sections(D: int) -> list[str]:
    """The script's sections at world size ``D``, in its order, and ``exit``."""
    out = []
    for case in CASES:
        out += [f"train-{case}-{k}" for k in POLICIES[D]] + [f"decode-{case}"]
    return out + ["gpipe", "allreduce", "restore", "trainer", "exit"]


def _oc(lr: float = LR) -> AdamWConfig:
    return AdamWConfig(lr=lr, warmup_steps=1, total_steps=10)


def _np(named: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named.items()}


def _grads_close(got: dict, want: dict, what) -> None:
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=str((what, k)))


def _port_unsharded(cfg, host: dict, batch: dict) -> dict:
    """The unsharded port on the same parameters and batch: logits,
    gradients, and one step's metrics, parameters and moments."""
    plain = params_from_jax(host, cfg, "cpu", param_dtype=torch.float32)
    plain.requires_grad_()
    _, grads = loss_and_grads(plain, cfg, batch)
    with torch.no_grad():
        logits, _ = forward(plain, cfg, batch)
    _, opt, m = make_train_step(cfg, _oc(), remat="none")(plain, init_opt(_oc(), plain), batch)
    return dict(logits=logits.numpy(), grads=_np(grads), loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]), after=_np(dict(plain.named_parameters())),
                m=_np(opt.m), v=_np(opt.v))


def _batch(cfg, seed: int = 0) -> dict:
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": tok, "labels": tok}


def _jax_pipe_and_allreduce(tmp: Path, inputs: dict) -> dict:
    """JAX's gpipe (forward and gradient inside ``jax.set_mesh``) and pod
    all-reduces at 2 and 4 stages, on 4 fake host devices."""
    np.savez(tmp / "jin.npz", **{k: v for k, v in inputs.items()})
    script = textwrap.dedent("""
        import sys
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.dist.compression import make_pod_allreduce
        from repro.dist.pipeline import gpipe

        inp = dict(np.load(sys.argv[1] + "/jin.npz"))
        out = {}
        for n in (2, 4):
            mesh = jax.make_mesh((n,), ("pipe",), devices=jax.devices()[:n])
            Ws, xs = jnp.asarray(inp[f"Ws{n}"]), jnp.asarray(inp["xs"])
            f = gpipe(lambda W, h: jnp.tanh(h @ W), mesh, "pipe")
            with jax.set_mesh(mesh):
                out[f"pipe{n}"] = np.asarray(jax.jit(f)(Ws, xs))
                out[f"grad{n}"] = np.asarray(jax.grad(lambda W: jnp.sum(jax.jit(f)(W, xs) ** 2))(Ws))
            sh = jax.device_put(jnp.asarray(inp[f"shards{n}"]), NamedSharding(mesh, P("pipe")))
            with jax.set_mesh(mesh):
                out[f"allreduce{n}"] = np.asarray(jax.jit(make_pod_allreduce(mesh, compress=True))(sh))
        np.savez(sys.argv[1] + "/jout.npz", **out)
        print("JAX_REFS_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    p = subprocess.run([sys.executable, "-c", script, str(tmp)], capture_output=True, text=True,
                       env=env, timeout=600)
    assert "JAX_REFS_OK" in p.stdout, p.stderr[-4000:]
    return dict(np.load(tmp / "jout.npz"))


@functools.lru_cache(maxsize=1)
def _references(tmp: str) -> dict:
    """Every input and JAX answer the ranks compare with (the same for
    both world sizes; computed once a process)."""
    tmp = Path(tmp)
    ref = {"cases": {}}
    for name, over in CASES.items():
        jcfg = dataclasses.replace(JC.get_reduced("qwen1_5_0_5b"), dtype="float32", **over)
        tcfg = dataclasses.replace(TC.get_reduced("qwen1_5_0_5b"), dtype="float32", **over)
        jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
        batch = _batch(tcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, _ = jax_forward(jp, jcfg, jb)
        grads = jax.grad(lambda p: jax_loss_fn(p, jcfg, jb)[0])(jp)
        step = jax.jit(jax_make_train_step(jcfg, _oc(), remat="none"))
        p1, o1, m = step(jp, jopt.init_opt(_oc(), jp), jb)
        host = jax.tree.map(np.asarray, jp)

        def named(tree):
            return named_from_jax(jax.tree.map(np.asarray, tree), tcfg)

        ref["cases"][name] = c = dict(
            cfg=tcfg, params=host, batch=batch, logits=np.asarray(logits),
            grads=named(grads), loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
            after=named(p1), m=named(o1.m), v=named(o1.v),
            port=_port_unsharded(tcfg, host, batch))
        _grads_close(c["port"]["grads"], c["grads"], (name, "unsharded port"))
    rng = np.random.default_rng(9)
    inputs = {"xs": rng.normal(0, 1, (PIPE["M"], PIPE["mb"], PIPE["D"])).astype(np.float32)}
    for n in (2, 4):
        inputs[f"Ws{n}"] = rng.normal(0, 0.3, (2 * n, PIPE["D"], PIPE["D"])).astype(np.float32)
        inputs[f"shards{n}"] = rng.normal(0, 1e-3, (n, 64)).astype(np.float32)
    ref["pipe_inputs"] = inputs
    ref["jax"] = _jax_pipe_and_allreduce(tmp, inputs)
    # an unsharded JAX-layout checkpoint, and an unsharded trainer's runs
    ckpt.save(tmp / "tree", ref["cases"]["dense"]["params"], 1)
    tcfg = ref["cases"]["dense"]["cfg"]

    def tc(d, steps):
        return TrainConfig(steps=steps, global_batch=B, seq_len=S, ckpt_dir=str(tmp / d),
                           ckpt_every=2, keep=3, log_every=1)

    full = Trainer(tcfg, tc("trainer_full", 3), oc=_oc(1e-3), device="cpu",
                   log_fn=lambda s: None).run()
    ref["trainer"] = dict(losses=[m["loss"] for m in full["metrics"]],
                          params=_np(dict(full["params"].named_parameters())),
                          m=_np(full["opt"].m), v=_np(full["opt"].v))
    return ref


# The checks, run on every rank of a group of ``D`` gloo ranks. No JAX here.
_SCRIPT = r'''
import contextlib
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch import ckpt
from repro_torch.dist import compression as Q
from repro_torch.dist import hints as H
from repro_torch.dist import sharding as TS
from repro_torch.dist.local import whole
from repro_torch.dist.pipeline import gpipe
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import decode_step, forward, prefill
from repro_torch.train import AdamWConfig, TrainConfig, Trainer, init_opt
from repro_torch.train.step import loss_and_grads, make_train_step

LR = {LR!r}
POLICIES = {POLICIES!r}


def close(a, b, atol, what, rtol=0.0):
    np.testing.assert_allclose(np.asarray(whole(a).detach()), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=str(what))


def grads_close(got, want, what):
    for k, w in want.items():
        w = np.asarray(w)
        close(got[k], w, 1e-5 * float(np.abs(w).max()), (what, k), rtol=1e-4)


def update_close(got, want, gate, lr, what):
    """A parameter after a step within two float32 spacings plus ``1e-3
    lr`` of ``want`` on the entries whose ``gate`` (the step's gradient or
    first moment) is above ``1e-3`` of its largest: there the update is
    about ``lr`` times a sign, so an update skipped, of the wrong sign or
    written to another shard is off by about ``lr``. Returns (entries
    held, entries)."""
    a, w = np.asarray(whole(got).detach()), np.asarray(want)
    gate = np.abs(np.asarray(gate))
    keep = gate > 1e-3 * gate.max()
    err = np.abs(a - w)[keep]
    tol = (2 * np.spacing(np.abs(w)) + 1e-3 * lr)[keep]
    assert (err <= tol).all(), (what, int((err > tol).sum()), float(err.max(initial=0)))
    return int(keep.sum()), keep.size


def local_slice(t: DTensor, full: np.ndarray) -> np.ndarray:
    shape, off = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return full[tuple(slice(o, o + s) for o, s in zip(off, shape))]


@contextlib.contextmanager
def section(name):
    """A section of the checks: once every rank has passed it, rank 0
    prints ``SECTION_OK <world size> <name>``. A failure raises (spawn
    then ends every rank), so no later section runs."""
    yield
    dist.barrier()
    if dist.get_rank() == 0:
        print(f"SECTION_OK {dist.get_world_size()} {name}", flush=True)


def policy(key, cfg, mesh):
    return {"for_mesh": lambda: TS.Policy.for_mesh(mesh),
            "recommended": lambda: TS.Policy.recommended(cfg, mesh, "train"),
            "tp2d": lambda: TS.Policy(dp=(), tp=("data", "model"), fsdp=(), sp="model")}[key]()


def check_train(c, cfg, mesh, pol, what):
    """Forward (hinted and not), gradients (hinted with remat too) and one
    train step of the model distributed by ``pol``."""
    port = c["port"]
    oc = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    model = TS.distribute_params(
        params_from_jax(c["params"], cfg, "cpu", param_dtype=torch.float32), mesh, pol)
    model.requires_grad_()
    with torch.no_grad():
        got, _ = forward(model, cfg, c["batch"])
        with H.sharding_hints(H.Hints(pol, gather_weights=True, seq_shard=True)):
            hinted, _ = forward(model, cfg, c["batch"])
    close(got, port["logits"], 1e-5, what)
    close(hinted, whole(got), 1e-5, what)
    close(hinted, c["logits"], 1e-5, what)
    _, g = loss_and_grads(model, cfg, c["batch"])
    grads_close(g, port["grads"], what)
    grads_close(g, c["grads"], what)
    # hinted, with each period recomputed in the backward
    with H.sharding_hints(H.Hints(pol, gather_weights=True, seq_shard=True)):
        _, g = loss_and_grads(model, cfg, c["batch"], remat="full")
    grads_close(g, c["grads"], (what, "hinted remat"))
    _, opt, m = make_train_step(cfg, oc, remat="none")(model, init_opt(oc, model), c["batch"])
    for k in ("loss", "grad_norm"):
        assert not isinstance(m[k], DTensor)
        np.testing.assert_allclose(float(m[k]), port[k], rtol=1e-5, err_msg=str(what))
        np.testing.assert_allclose(float(m[k]), c[k], rtol=1e-5, err_msg=str(what))
    held = total = 0
    for n, b in model.named_parameters():
        assert isinstance(b, DTensor)
        assert tuple(b.placements) == tuple(opt.m[n].placements) == tuple(
            opt.v[n].placements), n
        close(b, port["after"][n], 1e-5, (what, n))
        close(b, c["after"][n], 1e-5, (what, n, "jax"))
        h, t = update_close(b, port["after"][n], port["grads"][n], LR, (what, n))
        update_close(b, c["after"][n], c["grads"][n], LR, (what, n, "jax"))
        held, total = held + h, total + t
    assert held > total // 2, (what, held, total)
    for mom in ("m", "v"):
        grads_close(getattr(opt, mom), port[mom], (what, mom))
        grads_close(getattr(opt, mom), c[mom], (what, mom, "jax"))


def check_decode(name, c, mesh):
    """Four decode steps on a cache placed by cache_spec_tree."""
    D, cfg = dist.get_world_size(), c["cfg"]
    pol = TS.Policy.for_mesh(mesh, "decode")
    plain = params_from_jax(c["params"], cfg, "cpu")
    dm = TS.distribute_params(params_from_jax(c["params"], cfg, "cpu"), mesh, pol)
    tok = torch.from_numpy(c["batch"]["tokens"][:, :8]).long()
    logits, cache, _ = prefill(plain, cfg, {"tokens": tok}, max_seq=16)
    dcache = TS.distribute_cache(cfg, {b: {n: t.clone() for n, t in cc.items()}
                                       for b, cc in cache.items()}, mesh, pol)
    nxt, pos = logits.argmax(-1), torch.full((tok.shape[0],), 8)
    for _ in range(4):
        a, cache = decode_step(plain, cfg, cache, nxt, pos)
        b, dcache = decode_step(dm, cfg, dcache, nxt, pos)
        close(b, a.numpy(), 1e-5, (name, "decode"))
        nxt, pos = a.argmax(-1), pos + 1
    specs = TS.cache_spec_tree(cfg, cache, pol, mesh)
    for bk, cc in cache.items():
        for n, t in cc.items():
            d = dcache[bk][n]
            assert tuple(d.placements) == tuple(TS.placements(specs[bk][n], mesh))
            close(d, t.numpy(), 1e-5, (name, bk, n))
            np.testing.assert_allclose(d.to_local().numpy(), local_slice(d, t.numpy()),
                                       atol=1e-5, err_msg=str((name, bk, n, "local")))
    if name == "dense" and D == 4:
        k = dcache["b0"]["k"]
        assert k.to_local().shape[1] == k.shape[1] // 2    # rows over data
        assert k.to_local().shape[3] == k.shape[3] // 2    # KV heads over model


def check_gpipe(ref):
    """gpipe over all ranks against the sequential loop and JAX."""
    D = dist.get_world_size()
    pipe = init_device_mesh("cpu", (D,), mesh_dim_names=("pipe",))
    inp, jx = ref["pipe_inputs"], ref["jax"]
    Ws, xs = torch.from_numpy(inp[f"Ws{D}"]), torch.from_numpy(inp["xs"])

    def block(W, h):
        return torch.tanh(h @ W)

    f = gpipe(block, pipe, "pipe")
    W1, W2 = Ws.clone().requires_grad_(), Ws.clone().requires_grad_()
    want = []
    for m in range(xs.shape[0]):
        h = xs[m]
        for W in W1:
            h = block(W, h)
        want.append(h)
    want = torch.stack(want)
    got = f(W2, xs)
    assert torch.equal(got, want)
    g1, = torch.autograd.grad((want ** 2).sum(), W1)
    g2, = torch.autograd.grad((got ** 2).sum(), W2)
    g2 = g2.clone()
    dist.all_reduce(g2)
    close(g2, g1.numpy(), 2e-5, "gpipe grad")
    close(got, jx[f"pipe{D}"], 2e-5, "gpipe vs jax")
    close(g2, jx[f"grad{D}"], 2e-5, "gpipe grad vs jax")
    try:
        f(Ws[:D + 1], xs)
        raise AssertionError("layers that do not divide must raise")
    except ValueError:
        pass


def check_allreduce(ref):
    D, rank = dist.get_world_size(), dist.get_rank()
    shards = ref["pipe_inputs"][f"shards{D}"]
    x = torch.from_numpy(shards[rank].copy())
    mean = shards.astype(np.float64).mean(0)
    close(Q.make_pod_allreduce()(x), mean, 1e-7, "allreduce")
    y = Q.make_pod_allreduce(compress=True)(x)
    assert np.array_equal(y.numpy(), ref["jax"][f"allreduce{D}"][rank]), "compressed vs jax"
    assert np.abs(y.numpy() - mean).max() / np.abs(mean).max() < 0.02


def check_restore(c, mesh, tmp):
    """restore(shardings=) of an unsharded JAX-layout tree."""
    cfg, pol = c["cfg"], TS.Policy.for_mesh(mesh)
    tree, _ = ckpt.restore(tmp + "/tree", c["params"], shardings=TS.jax_tree_shardings(cfg, mesh, pol))
    flat = ckpt.checkpoint._flatten(tree)
    saved = dict(ckpt.checkpoint._flatten(c["params"]))
    assert len(flat) == len(saved)
    for key, t in flat:
        assert isinstance(t, DTensor), key
        assert np.array_equal(t.to_local().numpy(), local_slice(t, saved[key])), key


def check_trainer(ref, c, mesh, tmp):
    """A sharded Trainer restores and resumes an unsharded run."""
    D, cfg, pol = dist.get_world_size(), c["cfg"], TS.Policy.for_mesh(mesh)
    if dist.get_rank() == 0:   # the unsharded run's directory as it stood after step 2
        shutil.copytree(tmp + "/trainer_full", tmp + f"/resume{D}")
        shutil.rmtree(tmp + f"/resume{D}/step_00000003")
    dist.barrier()
    logs = []
    tc = TrainConfig(steps=3, global_batch=4, seq_len=16, ckpt_dir=tmp + f"/resume{D}",
                     ckpt_every=2, keep=3, log_every=1)
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    sharded = Trainer(cfg, tc, oc=oc, device="cpu", mesh=mesh, policy=pol, log_fn=logs.append)
    plain = Trainer(cfg, tc, oc=oc, device="cpu")
    sp, so = sharded.init_state()
    so = sharded._restore(sp, so)
    pp, po = plain.init_state()
    po = plain._restore(pp, po)
    assert int(so.step) == int(po.step) == 2
    for got, want in ((dict(sp.named_parameters()), dict(pp.named_parameters())),
                      (so.m, po.m), (so.v, po.v)):
        for n, t in got.items():
            assert isinstance(t, DTensor), n
            assert np.array_equal(t.to_local().detach().numpy(),
                                  local_slice(t, want[n].detach().numpy())), n
    out = sharded.run()
    assert "resumed from step 2" in logs
    full = ref["trainer"]
    np.testing.assert_allclose([m["loss"] for m in out["metrics"]], full["losses"][2:],
                               rtol=1e-5)
    for mom in ("m", "v"):
        grads_close(getattr(out["opt"], mom), full[mom], ("resumed", mom))
    for n, b in out["params"].named_parameters():
        update_close(b, full["params"][n], full["m"][n], oc.lr, ("resumed", n))


def run_checks(ref, tmp):
    D = dist.get_world_size()
    mesh = make_host_mesh(D, 2, device="cpu")
    for name, c in ref["cases"].items():
        for key in POLICIES[D]:
            pol = policy(key, c["cfg"], mesh)
            with section(f"train-{name}-{key}"):
                check_train(c, c["cfg"], mesh, pol, (name, D, pol))
        with section(f"decode-{name}"):
            check_decode(name, c, mesh)
    with section("gpipe"):
        check_gpipe(ref)
    with section("allreduce"):
        check_allreduce(ref)
    with section("restore"):
        check_restore(ref["cases"]["dense"], mesh, tmp)
    with section("trainer"):
        check_trainer(ref, ref["cases"]["dense"], mesh, tmp)


def worker(rank, D, store_path, ref_path, tmp):
    import pickle

    dist.init_process_group("gloo", store=dist.FileStore(store_path, D), rank=rank,
                            world_size=D)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    run_checks(ref, tmp)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import sys
    import torch.multiprocessing as mp

    D, tmp = int(sys.argv[1]), sys.argv[2]
    mp.spawn(worker, args=(D, tmp + f"/store{D}", tmp + "/ref.pkl", tmp), nprocs=D)
    print("DIST_LM_OK", D)
'''.replace("{LR!r}", repr(LR)).replace("{POLICIES!r}", repr(POLICIES))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``run(D)``: the script's subprocess of ``D`` gloo ranks, run once a
    world size (its sections' tests share it)."""
    tmp = tmp_path_factory.mktemp("dist_lm")
    runs = {}

    def run(D):
        if D not in runs:
            ref = _references(str(tmp))
            with open(tmp / "ref.pkl", "wb") as f:
                pickle.dump(ref, f)
            (tmp / f"checks{D}.py").write_text(_SCRIPT)  # spawn re-imports it by path
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
            runs[D] = subprocess.run([sys.executable, str(tmp / f"checks{D}.py"), str(D),
                                      str(tmp)], capture_output=True, text=True, env=env,
                                     timeout=600)
        return runs[D]

    return run


@pytest.mark.slow
@pytest.mark.parametrize("D,section", [(D, s) for D in POLICIES for s in _sections(D)])
def test_dist_lm_on_gloo_ranks_subprocess(D, section, ranks):
    """One section of the script's checks at world size ``D`` (2 and 4);
    ``exit``: every rank ended cleanly."""
    p = ranks(D)
    if section == "exit":
        assert p.returncode == 0 and f"DIST_LM_OK {D}" in p.stdout, p.stderr[-6000:]
    else:
        assert f"SECTION_OK {D} {section}\n" in p.stdout, p.stderr[-6000:]
