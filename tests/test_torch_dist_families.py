"""Every LM family of the port sharded at world sizes 2 and 4: gloo ranks
on the CPU, one subprocess per size whose ranks
``torch.multiprocessing.spawn`` starts (the script is written to a file,
which spawn re-imports by path), as ``tests/test_torch_dist_lm.py`` runs
its ranks. JAX's references and the unsharded port's answers are computed
once here and handed over in a pickle; the subprocesses import no JAX.

Meshes: (data 1, model 2) at world size 2, (data 2, model 2) at 4. Each
world size's subprocess runs once, both started together; its checks are
in sections, rank 0
prints a line when every rank has passed one, and each section is a test
(``exit``: every rank ended cleanly). A failure ends every rank, so it
fails its section and those after.

Cases, reduced float32: Kimi K2 (MoE with a shared expert) at its
capacity factor and at ``capacity_factor=0.5``, where pairs drop; Jamba
at one period (8 layers: Mamba, attention, MoE); xLSTM (mLSTM and sLSTM);
Whisper (encoder and cross-attention); InternVL (embedding frontend).

* ``train-<case>``, under ``Policy.for_mesh`` (the experts, the Mamba
  channels and the xLSTM heads over ``model``; batch and FSDP over
  ``data``): the forward with and without the ``gather_weights`` /
  ``seq_shard`` hints within ``1e-5`` of the unsharded port's logits;
  gradients within ``rtol=1e-4`` plus ``1e-5`` of the leaf's largest entry
  of the unsharded port's and of ``jax.grad``'s; one AdamW step at
  ``lr=2e-6`` on those gradients (``apply_updates``, the step
  ``make_train_step`` takes after them): loss and gradient norm within
  ``rtol=1e-5`` of
  both, the AdamW moments at the gradient tolerance of both, and the
  update held where the gradient is above ``1e-3`` of its leaf's largest
  (the tolerances of ``tests/test_torch_dist_lm.py``, which says why).
* ``decode-<case>`` (not the dropping Kimi), under ``Policy.for_mesh(...,
  "decode")``: the sharded prefill's logits and cache, then four decode
  steps on the cache placed by ``cache_spec_tree``, logits and the whole
  cache within ``1e-5`` of the unsharded port's and of JAX's ``prefill``
  and ``decode_step`` on the same prompt and step inputs (a cache leaf
  against JAX within ``1e-5`` of its largest entry where that is above 1:
  the sLSTM states reach ~30 and the unsharded port's already sit up to
  3.3e-5 from JAX's); every rank's local cache shard equals its slice.
* ``moe-drop``: one MoE layer of the dropping Kimi on a batch-sharded
  input: each rank's tokens' ``keep``/``pos`` equal JAX's (the capacity
  slots counted over the whole group, which spans the batch shards at
  world size 4); the output within ``1e-5`` of its largest entry (the
  input is unnormalized, so entries reach ~70) and the aux loss within
  ``1e-5`` of JAX's.
* ``decode2d-qwen``, ``decode2d-kimi``: JAX's 2-D decode preset
  (``Policy(dp=(), tp=(data, model), shard_seq=True, sp="model")``): the
  K/V cache's sequence over ``model``, so each step writes the new key and
  value on the rank that holds its position and merges the slices by
  log-sum-exp; logits and cache against the unsharded port and JAX as
  above.
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import moe as JM
from repro.models import prefill as jax_prefill
from repro.train import optimizer as jopt
import repro_torch.configs as TC
from repro_torch.interop import params_from_jax
from repro_torch.models import decode_step, forward, prefill
from repro_torch.models.layout import named_from_jax
from repro_torch.train import AdamWConfig, init_opt
from repro_torch.train.step import loss_and_grads, make_train_step

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

ROOT = Path(__file__).resolve().parents[1]
B, S, LR, PROMPT, STEPS = 4, 16, 2e-6, 8, 4
CASES = {
    "kimi": ("kimi_k2_1t_a32b", {}),
    "kimi_drop": ("kimi_k2_1t_a32b", dict(capacity_factor=0.5)),
    "jamba": ("jamba_1_5_large_398b", dict(n_layers=8)),
    "xlstm": ("xlstm_1_3b", {}),
    "whisper": ("whisper_small", {}),
    "internvl": ("internvl2_76b", {}),
}
DECODE = [c for c in CASES if c != "kimi_drop"]
DECODE_2D = {"qwen": ("qwen1_5_0_5b", {}), "kimi": ("kimi_k2_1t_a32b", {})}
SECTIONS = ([f"train-{c}" for c in CASES] + [f"decode-{c}" for c in DECODE] + ["moe-drop"]
            + [f"decode2d-{c}" for c in DECODE_2D] + ["exit"])


def _oc() -> AdamWConfig:
    return AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)


def _np(named: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named.items()}


def _cfgs(arch: str, over: dict):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(JC.get_reduced(arch), **over),
            dataclasses.replace(TC.get_reduced(arch), **over))


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"labels": tok}
    if cfg.frontend == "embed":
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = tok
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(size=(B, 12, cfg.d_model)).astype(np.float32)
    return batch


def _decode_ref(cfg, host: dict, batch: dict, jcfg, jp) -> dict:
    """The unsharded port's prefill of the batch's first ``PROMPT``
    positions and ``STEPS`` decode steps: the prompt, each step's input and
    logits, the prefill's logits and cache and the final cache; ``jax``:
    JAX's on the same prompt and inputs (:func:`_jax_decode`)."""
    plain = params_from_jax(host, cfg, "cpu")
    prompt = {k: batch[k][:, :PROMPT] for k in ("tokens", "embeds") if k in batch}
    if "frames" in batch:
        prompt["frames"] = batch["frames"]
    with torch.no_grad():
        logits, cache, enc = prefill(plain, cfg, prompt, max_seq=S)
        out = dict(prompt=prompt, prefill=logits.numpy(),
                   cache0={b: _np(c) for b, c in cache.items()}, inputs=[], logits=[])
        rng = np.random.default_rng(7)
        nxt, pos = logits.argmax(-1), torch.full((B,), PROMPT)
        for _ in range(STEPS):
            tok = (torch.from_numpy(rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32))
                   if cfg.frontend == "embed" else nxt)
            a, cache = decode_step(plain, cfg, cache, tok, pos, enc)
            out["inputs"].append(tok.numpy())
            out["logits"].append(a.numpy())
            nxt, pos = a.argmax(-1), pos + 1
    out["cache"] = {b: _np(c) for b, c in cache.items()}
    out["jax"] = _jax_decode(jcfg, jp, out)
    return out


def _jax_decode(jcfg, jp, port: dict) -> dict:
    """JAX's ``prefill`` of the port's prompt and its ``decode_step`` on the
    port's step inputs: the prefill's logits and cache, each step's logits
    and the final cache."""
    logits, cache, enc = jax_prefill(jp, jcfg, {k: jnp.asarray(v)
                                                for k, v in port["prompt"].items()}, max_seq=S)
    out = dict(prefill=np.asarray(logits), cache0=jax.tree.map(np.asarray, cache), logits=[])
    pos = jnp.full((B,), PROMPT, jnp.int32)
    for tok in port["inputs"]:
        a, cache = jax_decode_step(jp, jcfg, cache, jnp.asarray(tok), pos, enc)
        out["logits"].append(np.asarray(a))
        pos = pos + 1
    out["cache"] = jax.tree.map(np.asarray, cache)
    return out


def _moe_drop_ref(jcfg, jp) -> dict:
    """JAX's MoE layer (the first period's ``m0``) on a random input: its
    output, aux loss and the plan, ``keep`` (T, k, E) and ``pos`` (T, k),
    by JAX's grouping and routing (``repro.models.moe``)."""
    x = np.random.default_rng(3).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    mp = jax.tree.map(lambda a: a[0], jp["layers"]["m0"])
    y, aux = JM.moe(mp, jcfg, jnp.asarray(x))
    E, k = jcfg.n_experts, jcfg.top_k
    G = JM._pick_groups(B * S)
    g = B * S // G
    gates = jax.nn.softmax(jnp.einsum("gtd,de->gte", jnp.asarray(x).reshape(G, g, -1),
                                      mp["router"]), axis=-1)
    ids, _ = JM._route(gates, k, None)
    cap = max(int(np.ceil(g * k / E * jcfg.capacity_factor)), 1)
    onehot = jax.nn.one_hot(ids, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(G, g * k, E), axis=1).reshape(G, g, k, E) - onehot
    keep = (pos < cap) * onehot
    pos = jnp.sum(pos * keep, axis=-1).astype(jnp.int32)
    return dict(x=x, y=np.asarray(y), aux=float(aux), keep=np.asarray(keep).reshape(B * S, k, E),
                pos=np.asarray(pos).reshape(B * S, k))


@functools.lru_cache(maxsize=1)
def _references() -> dict:
    """Every input, JAX answer and unsharded port answer the ranks compare
    with (the same for both world sizes; computed once a process)."""
    ref = {"cases": {}, "decode2d": {}}
    oc = _oc()
    jstep = jax.jit(jopt.apply_updates, static_argnums=0)
    joc = jopt.AdamWConfig(**dataclasses.asdict(oc))
    for name, (arch, over) in CASES.items():
        jcfg, tcfg = _cfgs(arch, over)
        jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
        batch = _batch(tcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        # op by op: at these sizes JAX's compile of the whole gradient costs more
        (loss, _), grads = jax.value_and_grad(
            lambda p: jax_loss_fn(p, jcfg, jb), has_aux=True)(jp)
        p1, o1, m = jstep(joc, jp, grads, jopt.init_opt(joc, jp))
        host = jax.tree.map(np.asarray, jp)

        def named(tree):
            return named_from_jax(jax.tree.map(np.asarray, tree), tcfg)

        plain = params_from_jax(host, tcfg, "cpu", param_dtype=torch.float32)
        plain.requires_grad_()
        _, pgrads = loss_and_grads(plain, tcfg, batch)
        with torch.no_grad():
            logits, _ = forward(plain, tcfg, batch)
        _, opt, pm = make_train_step(tcfg, oc, remat="none")(plain, init_opt(oc, plain), batch)
        c = ref["cases"][name] = dict(
            cfg=tcfg, params=host, batch=batch, loss=float(loss),
            grad_norm=float(m["grad_norm"]), grads=named(grads), after=named(p1),
            m=named(o1.m), v=named(o1.v),
            port=dict(logits=logits.numpy(), grads=_np(pgrads), loss=float(pm["loss"]),
                      grad_norm=float(pm["grad_norm"]),
                      after=_np(dict(plain.named_parameters())), m=_np(opt.m), v=_np(opt.v)))
        if name in DECODE:
            c["decode"] = _decode_ref(tcfg, host, batch, jcfg, jp)
        if name == "kimi_drop":
            ref["moe_drop"] = _moe_drop_ref(jcfg, jp)
    for name, (arch, over) in DECODE_2D.items():
        jcfg, tcfg = _cfgs(arch, over)
        jp = jax_init_params(jax.random.PRNGKey(1), jcfg)
        host = jax.tree.map(np.asarray, jp)
        batch = _batch(tcfg, seed=1)
        ref["decode2d"][name] = dict(cfg=tcfg, params=host,
                                     decode=_decode_ref(tcfg, host, batch, jcfg, jp))
    return ref


# The checks, run on every rank of a group of ``D`` gloo ranks. No JAX here.
_SCRIPT = r'''
import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.dist import hints as H
from repro_torch.dist import sharding as TS
from repro_torch.dist.local import replicate, whole
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import decode_step, forward, prefill
from repro_torch.models import moe as M
from repro_torch.train import AdamWConfig, init_opt
from repro_torch.train.optimizer import apply_updates
from repro_torch.train.step import loss_and_grads

LR, S, PROMPT = {LR!r}, {S!r}, {PROMPT!r}


def close(a, b, atol, what, rtol=0.0):
    np.testing.assert_allclose(np.asarray(whole(a).detach()), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=str(what))


def grads_close(got, want, what):
    for k, w in want.items():
        w = np.asarray(w)
        close(got[k], w, 1e-5 * float(np.abs(w).max()), (what, k), rtol=1e-4)


def update_close(got, want, gate, lr, what):
    """A parameter after a step within two float32 spacings plus ``1e-3
    lr`` of ``want`` where ``gate`` (the step's gradient) is above ``1e-3``
    of its largest. Returns (entries held, entries)."""
    a, w = np.asarray(whole(got).detach()), np.asarray(want)
    gate = np.abs(np.asarray(gate))
    keep = gate > 1e-3 * gate.max()
    err = np.abs(a - w)[keep]
    tol = (2 * np.spacing(np.abs(w)) + 1e-3 * lr)[keep]
    assert (err <= tol).all(), (what, int((err > tol).sum()), float(err.max(initial=0)))
    return int(keep.sum()), keep.size


def local_slice(t, full):
    shape, off = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return full[tuple(slice(o, o + s) for o, s in zip(off, shape))]


@contextlib.contextmanager
def section(name):
    """Once every rank has passed the block, rank 0 prints ``SECTION_OK
    <world size> <name>``; a failure raises and spawn ends every rank."""
    yield
    dist.barrier()
    if dist.get_rank() == 0:
        print(f"SECTION_OK {dist.get_world_size()} {name}", flush=True)


def check_train(name, c, mesh):
    cfg, port = c["cfg"], c["port"]
    pol = TS.Policy.for_mesh(mesh)
    oc = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
    model = TS.distribute_params(
        params_from_jax(c["params"], cfg, "cpu", param_dtype=torch.float32), mesh, pol)
    model.requires_grad_()
    with torch.no_grad():
        got, _ = forward(model, cfg, c["batch"])
        with H.sharding_hints(H.Hints(pol, gather_weights=True, seq_shard=True)):
            hinted, _ = forward(model, cfg, c["batch"])
    close(got, port["logits"], 1e-5, name)
    close(hinted, port["logits"], 1e-5, (name, "hinted"))
    loss, g = loss_and_grads(model, cfg, c["batch"])
    grads_close(g, port["grads"], name)
    grads_close(g, c["grads"], (name, "jax"))
    # the step make_train_step runs after loss_and_grads, on these gradients
    _, opt, m = apply_updates(oc, model, g, init_opt(oc, model))
    m["loss"] = loss
    for k in ("loss", "grad_norm"):
        assert not isinstance(m[k], DTensor)
        np.testing.assert_allclose(float(m[k]), port[k], rtol=1e-5, err_msg=str(name))
        np.testing.assert_allclose(float(m[k]), c[k], rtol=1e-5, err_msg=str((name, "jax")))
    held = total = 0
    for n, b in model.named_parameters():
        assert isinstance(b, DTensor)
        close(b, port["after"][n], 1e-5, (name, n))
        close(b, c["after"][n], 1e-5, (name, n, "jax"))
        h, t = update_close(b, port["after"][n], port["grads"][n], LR, (name, n))
        update_close(b, c["after"][n], c["grads"][n], LR, (name, n, "jax"))
        held, total = held + h, total + t
    assert held > total // 2, (name, held, total)
    for mom in ("m", "v"):
        grads_close(getattr(opt, mom), port[mom], (name, mom))
        grads_close(getattr(opt, mom), c[mom], (name, mom, "jax"))


def cache_close(cache, want, what, jax=False):
    """Every leaf of ``want`` within 1e-5 of the cache's; against JAX
    (``jax``) within 1e-5 of the leaf's largest entry where that is
    above 1."""
    for b, cc in want.items():
        for n, t in cc.items():
            scale = max(1.0, float(np.abs(t).max())) if jax else 1.0
            close(cache[b][n], t, 1e-5 * scale, (what, b, n))


def check_decode(name, cfg, params, ref, mesh, pol):
    """The sharded prefill, then decode steps on the placed cache, against
    the unsharded port's (``ref``) and JAX's (``ref["jax"]``)."""
    dm = TS.distribute_params(params_from_jax(params, cfg, "cpu"), mesh, pol)
    logits, cache, enc = prefill(dm, cfg, ref["prompt"], max_seq=S)
    for want, src in ((ref, "port"), (ref["jax"], "jax")):
        close(logits, want["prefill"], 1e-5, (name, "prefill", src))
        cache_close(cache, want["cache0"], (name, "prefill cache", src), src == "jax")
    cache = TS.distribute_cache(cfg, {b: {n: torch.from_numpy(t.copy()) for n, t in cc.items()}
                                      for b, cc in ref["cache0"].items()}, mesh, pol)
    pos = torch.full((logits.shape[0],), PROMPT)
    for tok, want, jwant in zip(ref["inputs"], ref["logits"], ref["jax"]["logits"],
                                strict=True):
        got, cache = decode_step(dm, cfg, cache, torch.from_numpy(tok), pos, enc)
        close(got, want, 1e-5, (name, "decode"))
        close(got, jwant, 1e-5, (name, "decode", "jax"))
        pos = pos + 1
    cache_close(cache, ref["cache"], name)
    cache_close(cache, ref["jax"]["cache"], (name, "jax"), jax=True)
    specs = TS.cache_spec_tree(cfg, cache, pol, mesh)
    for b, cc in ref["cache"].items():
        for n, t in cc.items():
            d = cache[b][n]
            assert tuple(d.placements) == tuple(TS.placements(specs[b][n], mesh)), (name, b, n)
            np.testing.assert_allclose(d.to_local().numpy(), local_slice(d, t), atol=1e-5,
                                       err_msg=str((name, b, n, "local")))
    return cache


def check_moe_drop(c, ref, mesh):
    """One MoE layer of the dropping case: the plan of each rank's tokens
    equals JAX's, the output and the aux loss within 1e-5."""
    cfg = c["cfg"]
    pol = TS.Policy.for_mesh(mesh)
    model = TS.distribute_params(params_from_jax(c["params"], cfg, "cpu",
                                                 param_dtype=torch.float32), mesh, pol)
    p = model.layers[0].m0
    x = torch.from_numpy(ref["x"])
    xd = replicate(x, mesh).redistribute(mesh, TS.batch_placements(x, "embeds", cfg, mesh, pol))
    with torch.no_grad():
        r = M._local_route(p, cfg, xd)
        y, aux = M.moe(p, cfg, xd)
    t0, Tl, k, E = r.sp.b0 * x.shape[1], r.Tl, cfg.top_k, cfg.n_experts
    keep = r.keep.reshape(-1, k, E)[r.lo:r.lo + Tl].numpy()
    pos = r.pos.reshape(-1, k)[r.lo:r.lo + Tl].numpy()
    assert np.array_equal(keep, ref["keep"][t0:t0 + Tl]), "keep"
    assert np.array_equal(pos, ref["pos"][t0:t0 + Tl]), "pos"
    assert (ref["keep"].sum((1, 2)) < k).any(), "the case drops pairs"
    if dist.get_world_size() == 4:
        assert r.sp.Bd and r.G == 1 and Tl < x.shape[0] * x.shape[1], "a group spans shards"
    close(y, ref["y"], 1e-5 * float(np.abs(ref["y"]).max()), "moe y")
    close(aux, ref["aux"], 1e-5, "moe aux")


def run_checks(ref):
    D = dist.get_world_size()
    mesh = make_host_mesh(D, 2, device="cpu")
    for name, c in ref["cases"].items():
        with section(f"train-{name}"):
            check_train(name, c, mesh)
    with torch.no_grad():
        for name, c in ref["cases"].items():
            if "decode" in c:
                with section(f"decode-{name}"):
                    check_decode(name, c["cfg"], c["params"], c["decode"], mesh,
                                 TS.Policy.for_mesh(mesh, "decode"))
    with section("moe-drop"):
        check_moe_drop(ref["cases"]["kimi_drop"], ref["moe_drop"], mesh)
    pol = TS.Policy(dp=(), tp=("data", "model"), fsdp=(), shard_seq=True, sp="model")
    with torch.no_grad():
        for name, c in ref["decode2d"].items():
            with section(f"decode2d-{name}"):
                cache = check_decode(name, c["cfg"], c["params"], c["decode"], mesh, pol)
                k = cache["b0"]["k"]
                assert k.to_local().shape[2] == k.shape[2] // 2    # the sequence over model


def worker(rank, D, store_path, ref_path):
    import pickle

    dist.init_process_group("gloo", store=dist.FileStore(store_path, D), rank=rank,
                            world_size=D)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    run_checks(ref)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import sys
    import torch.multiprocessing as mp

    D, tmp = int(sys.argv[1]), sys.argv[2]
    mp.spawn(worker, args=(D, tmp + f"/store{D}", tmp + "/ref.pkl"), nprocs=D)
    print("DIST_FAMILIES_OK", D)
'''.replace("{LR!r}", repr(LR)).replace("{S!r}", repr(S)).replace("{PROMPT!r}", repr(PROMPT))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``run(D)``: the script's subprocess of ``D`` gloo ranks (its stdout,
    stderr and exit code). The first call pickles the references and
    starts the subprocesses of both world sizes at once; each runs once
    and its sections' tests share it."""
    tmp = tmp_path_factory.mktemp("dist_families")
    procs, runs = {}, {}

    def start():
        with open(tmp / "ref.pkl", "wb") as f:
            pickle.dump(_references(), f)
        (tmp / "checks.py").write_text(_SCRIPT)  # spawn re-imports it by path
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        for D in (2, 4):
            out, err = open(tmp / f"out{D}", "w"), open(tmp / f"err{D}", "w")
            procs[D] = (subprocess.Popen([sys.executable, str(tmp / "checks.py"), str(D),
                                          str(tmp)], stdout=out, stderr=err, text=True,
                                         env=env), out, err)

    def run(D):
        if not procs:
            start()
        if D not in runs:
            p, out, err = procs[D]
            try:
                p.wait(timeout=600)
            finally:
                p.kill()
                out.close()
                err.close()
            runs[D] = subprocess.CompletedProcess(p.args, p.returncode,
                                                  (tmp / f"out{D}").read_text(),
                                                  (tmp / f"err{D}").read_text())
        return runs[D]

    yield run
    for p, out, err in procs.values():
        p.kill()
        out.close()
        err.close()


@pytest.mark.slow
@pytest.mark.parametrize("D,section", [(D, s) for D in (2, 4) for s in SECTIONS])
def test_dist_families_on_gloo_ranks_subprocess(D, section, ranks):
    """One section of the script's checks at world size ``D`` (2 and 4);
    ``exit``: every rank ended cleanly."""
    p = ranks(D)
    if section == "exit":
        assert p.returncode == 0 and f"DIST_FAMILIES_OK {D}" in p.stdout, p.stderr[-6000:]
    else:
        assert f"SECTION_OK {D} {section}\n" in p.stdout, p.stderr[-6000:]
