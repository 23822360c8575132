"""The port's last public surface against the JAX package's, on the CPU.

* The four functions: ``Map2DSampler.marginal_weights`` bit for bit
  JAX's on the same map, before and after an update; ``configs.
  all_configs`` field by field; ``dist.sharding.param_shardings`` of an
  LM, of its AdamW moments and of one period (and Whisper's encoder layer)
  against the placements JAX's ``param_shardings`` specs give on the same
  leaves, on a fake-backend mesh of 8 ranks ((4, 2), as
  ``tests/test_torch_dist.py``); ``dist.forest.default_mesh``'s shape and
  axis name against JAX's.
* The seven walkthroughs ``examples/torch_*.py``, each run with ``--device
  cpu`` in a subprocess under one torch thread, with JAX and the JAX
  package unimportable (and none imported in their source): every
  example's own asserts hold, and its printed checks equal its JAX twin's
  where they are deterministic. Both packages' forests and drains agree
  bit for bit at these sizes (quickstart, density map, pool serving: every
  line; the density map's at a small size); the LM walkthroughs draw their
  weights from other generators (torch's against JAX's PRNG), so their
  losses and tokens differ and the comparison keeps what does not depend
  on the weights: request and token counts, decode steps, prompts, the
  logged steps, learning rates and the resume point. The JAX twins but
  the quickstart's run in ``slow`` tests (a subprocess each, a fresh JAX
  init and its compiles: ~60 s together, ~50 of them ``pool_serving.py``),
  each torch run once per module. The twin of ``sharded_forest.py`` runs
  on gloo groups of 1 and (``slow``) of 2 and 4 ranks, and at 2 and 4 its
  lines before the timing sweep equal ``sharded_forest.py``'s on as many
  fake XLA devices: cell ranges, owned leaves per shard, drain plans,
  rebalanced bounds and capacity, rebuilt windows and dirty chunks.
"""
import ast
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

import repro.configs as JC
from repro.configs.paper_workloads import env_map_2d
from repro.dist import forest as JDF
from repro.dist import sharding as JS
from repro.launch import shapes as JSH
from repro.spatial import Map2DSampler as JMap2DSampler
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_opt as jax_init_opt
import repro_torch.configs as TC
from repro_torch.core.cdf import normalize_weights
from repro_torch.dist import forest as DF
from repro_torch.dist import sharding as TS
from repro_torch.models import init_params
from repro_torch.spatial import Map2DSampler
from repro_torch.train import AdamWConfig, init_opt
from _torch_threads import one_torch_thread  # noqa: F401 (pytestmark uses it)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart.py", "torch_density_map_sampling.py", "torch_pool_serving.py",
            "torch_sharded_forest.py", "torch_failover_demo.py", "torch_serve_batched.py",
            "torch_train_lm.py")


def _no_jax_runner() -> str:
    """chip_smoke's runner of an example (argv: its path and arguments) as
    ``__main__`` with JAX and the JAX package unimportable."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.NO_JAX_RUNNER + "run_example()\n"


NO_JAX_RUNNER = _no_jax_runner()


# ------------------------------------------------------------ the functions


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_marginal_weights_bitwise_jax():
    """The served row marginal, float32, bit for bit JAX's on the same map
    (a zero-mass row included), and again after an update that revives
    that row and re-weights another."""
    img = env_map_2d(24, 40)
    img[3] = 0.0
    jm, tm = JMap2DSampler(img), Map2DSampler(img, device="cpu")
    assert tm.marginal_weights().dtype == np.float32
    assert np.array_equal(_bits(tm.marginal_weights()), _bits(jm.marginal_weights()))
    assert tm.marginal_weights()[3] == 0.0
    upd = {1: np.arange(40, dtype=np.float64) + 1.0, 3: np.ones(40)}
    jm.update_map(upd)
    tm.update_map(upd)
    assert np.array_equal(_bits(tm.marginal_weights()), _bits(jm.marginal_weights()))
    assert tm.marginal_weights()[3] > 0.0


def test_marginal_weights_ragged_map():
    """On a ragged map (rows in several size classes, one all-zero) the
    marginal is the normalized row sums, and the rows it serves."""
    rng = np.random.default_rng(0)
    rows = [rng.random(int(k)) ** 3 for k in rng.integers(1, 70, 20)]
    rows[5][:] = 0.0
    tm = Map2DSampler(rows, device="cpu")
    want = normalize_weights(np.asarray([r.sum() for r in rows]))
    assert np.array_equal(_bits(tm.marginal_weights()), _bits(want))
    row, _, _, _ = tm.sample_map(rng.random((4096, 2)).astype(np.float32))
    assert set(np.unique(row.numpy())) <= set(np.flatnonzero(want > 0))


def test_all_configs_field_by_field():
    got, want = TC.all_configs(), JC.all_configs()
    assert list(got) == list(want) == TC.ARCHS
    for arch, cfg in got.items():
        assert cfg is TC.get(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want[arch]), arch


@pytest.fixture
def fake_world():
    """A fake-backend process group of 8 ranks (this process plays rank 5),
    destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
    yield 8
    dist.destroy_process_group()


def _jax_placements(tree, jpol, am, mesh, leaf_of) -> dict:
    """``{port name: placements}`` of JAX's ``param_shardings(am, tree,
    jpol)`` specs carried onto the port's layout; ``leaf_of`` maps a JAX
    path (tuple of keys) to ``(port name, Leaf)``, the spec's period axis
    (absent in a per-period tree) put back as the port's ``Leaf`` has it."""
    sh = JS.param_shardings(am, tree, jpol)
    out = {}
    for (path, x), s in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree_util.tree_leaves(
                                sh, is_leaf=lambda v: hasattr(v, "spec"))):
        spec = tuple(s.spec) + (None,) * (len(x.shape) - len(s.spec))
        for name, lf in leaf_of(tuple(k.key for k in path)):
            full = spec if len(lf.shape) == len(spec) else (None,) + spec
            out[name] = TS.placements(TS.port_spec(lf, full), mesh)
    return out


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_param_shardings_match_jax(arch, fake_world):
    """Placements of an LM's parameters, of its AdamW moments and of one
    period (and an encoder layer) on a (4, 2) mesh of the fake backend
    equal JAX's ``param_shardings`` on its params struct, its moments'
    struct and its per-period subtree, for the train, decode and 2-D TP
    policies; the LM's are ``distribute_params``'."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    am = AbstractMesh((4, 2), ("data", "model"))
    cfg = TC.get_reduced(arch)
    model = init_params(cfg, device="cpu", param_dtype=torch.float32)
    moments = init_opt(AdamWConfig(), model).m
    lv = TS.leaves(cfg)
    by_path: dict = {}
    for name, lf in lv.items():
        by_path.setdefault(lf.path, []).append((name, lf))
    jp = JSH.params_struct(JC.get_reduced(arch))
    jm = jax.eval_shape(lambda t: jax_init_opt(JAdamWConfig(), t), jp).m

    def one_slice(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), tree)

    subs = [(model.layers[0], "layers")]
    if cfg.encoder_layers:
        subs.append((model.encoder[0], "encoder"))
    for pol in (TS.Policy.for_mesh(mesh), TS.Policy.for_mesh(mesh, "decode"),
                TS.Policy(dp=(), tp=("data", "model"), fsdp=(), shard_seq=True, sp="model")):
        jpol = JS.Policy(**dataclasses.asdict(pol))
        want = _jax_placements(jp, jpol, am, mesh, lambda p: by_path[p])
        got = TS.param_shardings(mesh, model, pol)
        assert set(got) == {n for n, _ in model.named_parameters()} == set(want)
        assert got == want == TS.param_placements(model, mesh, pol), (arch, pol)
        assert TS.param_shardings(mesh, moments, pol, cfg=cfg) == want
        assert _jax_placements(jm, jpol, am, mesh, lambda p: by_path[p]) == want
        for mod, key in subs:
            rel = {name[len(f"{key}.0."):]: (name, lf) for name, lf in lv.items()
                   if name.startswith(f"{key}.0.")}
            by_rel = {lf.path[1:]: (r, lf) for r, (_, lf) in rel.items()}
            jwant = _jax_placements(one_slice(jp[key]), jpol, am, mesh,
                                    lambda p: [by_rel[p]])
            sub = TS.param_shardings(mesh, mod, pol, cfg=cfg)
            assert set(sub) == {n for n, _ in mod.named_parameters()} == set(jwant)
            assert sub == jwant, (arch, key, pol)
            assert sub == {r: got[n] for r, (n, _) in rel.items()}
    with pytest.raises(ValueError, match="cfg"):
        TS.param_shardings(mesh, moments, TS.Policy.for_mesh(mesh))


def test_default_mesh_matches_jax(fake_world):
    """A 1-D mesh named as asked over every rank, as JAX's is over every
    device."""
    jm = JDF.default_mesh()
    tm = DF.default_mesh(device="cpu")
    assert tm.mesh_dim_names == tuple(jm.axis_names) == ("data",)
    assert tm.ndim == jm.devices.ndim == 1
    assert tuple(tm.shape) == (fake_world,) and jm.devices.shape == (len(jax.devices()),)
    assert DF.default_mesh("shards", device="cpu").mesh_dim_names == ("shards",)


def test_default_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        DF.default_mesh(device="cpu")


# ------------------------------------------------------------- the examples


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
            "OMP_NUM_THREADS": "1"}


def _run(cmd: list, cwd: Path, timeout: int = 300, **env: str) -> list[str]:
    p = subprocess.run(cmd, cwd=cwd, env={**_env(), **env}, capture_output=True, text=True,
                       timeout=timeout)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-6000:]
    return p.stdout.strip().splitlines()


def _torch_example(name: str, cwd: Path, *args: str) -> list[str]:
    return _run([sys.executable, "-c", NO_JAX_RUNNER, str(ROOT / "examples" / name),
                 "--device", "cpu", *args], cwd)


def _jax_example(name: str, cwd: Path, *args: str, **env: str) -> list[str]:
    return _run([sys.executable, str(ROOT / "examples" / name), *args], cwd, **env)


@pytest.fixture(scope="module")
def torch_run(tmp_path_factory):
    """A torch example's lines, run once per (name, arguments) in this
    module, each run in a directory of its own."""
    seen: dict = {}

    def run(name: str, *args: str) -> list[str]:
        if (name,) + args not in seen:
            seen[(name,) + args] = _torch_example(name, tmp_path_factory.mktemp("ex"), *args)
        return seen[(name,) + args]

    return run


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_source_imports_only_the_port(name):
    tree = ast.parse((ROOT / "examples" / name).read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    roots = {m.split(".")[0] for m in mods}
    assert "repro_torch" in roots and not roots & {"jax", "jaxlib", "repro"}, roots


def test_quickstart_example_equals_jax(torch_run, tmp_path):
    got = torch_run("torch_quickstart.py")
    assert "sampling: forest == searchsorted oracle on 65536 draws" in got
    assert got == _jax_example("quickstart.py", tmp_path)


def test_density_map_example(tmp_path):
    """The walkthrough's differential gate (the bulk drain against the
    per-row reference, elementwise) holds at its default sizes."""
    got = _torch_example("torch_density_map_sampling.py", tmp_path, "--out", "t")
    assert got[0].startswith("n=65536: quadratic error inverse=")
    assert got[1] == "forest drain: {'launches': 1, 'fused': True, 'classes': [256], " \
                     "'marginal': 'fused'}"
    assert all((tmp_path / "t" / f).stat().st_size > 0
               for f in ("target.pgm", "inverse.pgm", "alias.pgm"))


DENSITY_SMALL = ("--n", "4096", "--h", "32", "--w", "64")


@pytest.mark.slow
def test_density_map_example_equals_jax(torch_run, tmp_path):
    """Errors, the drain record and the three images JAX's at a small map."""
    got = torch_run("torch_density_map_sampling.py", *DENSITY_SMALL, "--out", str(tmp_path / "t"))
    want = _jax_example("density_map_sampling.py", tmp_path, *DENSITY_SMALL, "--out", "j")
    assert got[:2] == want[:2]
    for f in ("target.pgm", "inverse.pgm", "alias.pgm"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


# What ``pool_serving.py`` prints (its JAX run, compared live in the slow
# test below): every line is a check the walkthrough asserts or a count.
POOL_SERVING_LINES = [
    "admitted 48 tenants into 6 size classes: [8, 16, 32, 64, 128, 256]",
    "tenant row == standalone build, bit for bit",
    "mixed-batch drain over 4096 draws agrees with per-tenant descent",
    "updates: 1 rebuilt, 1 skipped (no bits moved)",
    "evicted handle raises; slot recycled with a version bump",
    "stream-aware drain == host-oracle drain, counters bit-equal (8 distinct slots over "
    "512 draws)",
    "served 16 prior-backed requests in 14 engine steps over 8 slots",
    "mixed pool: 4 forest classes + 4 alias classes over 24 tenants",
    "alias lanes match the O(1) table oracle; forest lanes untouched",
    "auto under prng streams -> alias; auto under qmc streams -> forest",
    "served 12 mixed-method requests in 6 steps",
    "rejected at admission with code 'negative'",
    "quarantine: flagged on admit, cleared by a clean update (0 still flagged)",
    "snapshot/restore: resumed drains bit-identical (verify_pool clean after restore)",
]


def test_pool_serving_example(torch_run):
    assert torch_run("torch_pool_serving.py") == POOL_SERVING_LINES


@pytest.mark.slow
def test_pool_serving_example_equals_jax(tmp_path):
    assert _jax_example("pool_serving.py", tmp_path) == POOL_SERVING_LINES


_STEP = re.compile(r"^step +(\d+) loss [\d.]+ gnorm [\d.]+ lr (\S+) \(")


def _weight_free(lines: list[str]) -> list[str]:
    """A training log without what depends on the weights: a step line
    keeps its step and learning rate."""
    out = []
    for ln in lines:
        m = _STEP.match(ln)
        out.append(f"step {m[1]} lr {m[2]}" if m else re.sub(r"final loss: [\d.]+",
                                                             "final loss", ln))
    return out


def test_failover_example(torch_run):
    """Killed at step 13, resumed from the step-12 checkpoint, bitwise equal
    to the uninterrupted run, whose losses the resumed run logs."""
    got = torch_run("torch_failover_demo.py")
    assert "CRASH: injected failure at step 13" in got and "resumed from step 12" in got
    assert got[-1] == "bitwise identical to uninterrupted run: True"
    first = [ln.split(" (")[0]   # the wall aside
             for ln in got[:got.index("== run with injected failure at step 13 ==")]
             if ln.startswith("step")]
    assert [ln.split(" (")[0] for ln in got[-3:-1]] == first[-2:]


@pytest.mark.slow
def test_failover_example_equals_jax(torch_run, tmp_path):
    """The log's steps, learning rates and resume point JAX's."""
    want = _jax_example("failover_demo.py", tmp_path)
    assert _weight_free(torch_run("torch_failover_demo.py")) == _weight_free(want)


SERVE_SMALL = ("--requests", "5", "--max-new", "6")


def _serve_weight_free(lines: list[str]) -> list[str]:
    head = re.sub(r" in [\d.]+s \([\d.]+ tok/s, ", " (", lines[0])
    return [head] + [ln.split(" -> ")[0] for ln in lines[1:]]


@pytest.mark.parametrize("mode", ["inverse_qmc", "inverse_rng", "alias"])
def test_serve_batched_example(torch_run, mode):
    """Every request finishes with all its tokens, in each sampling mode."""
    got = torch_run("torch_serve_batched.py", *SERVE_SMALL, "--mode", mode)
    assert got[0].startswith(f"mode={mode}: 5 requests, 30 tokens in ")
    assert all(" -> [" in ln for ln in got[1:]) and len(got) == 4


@pytest.mark.slow
def test_serve_batched_example_equals_jax(torch_run, tmp_path):
    """Requests, tokens, decode steps and prompts JAX's (the tokens depend
    on the weights)."""
    want = _serve_weight_free(_jax_example("serve_batched.py", tmp_path, *SERVE_SMALL))
    for mode in ("inverse_qmc", "inverse_rng", "alias"):
        got = _serve_weight_free(torch_run("torch_serve_batched.py", *SERVE_SMALL,
                                           "--mode", mode))
        assert got == [want[0].replace("inverse_qmc", mode)] + want[1:], mode


TRAIN_TINY = ("--preset", "tiny", "--steps", "8", "--batch", "2", "--seq", "32")


def test_train_lm_example_resumes(tmp_path):
    """The tiny preset trains its steps; invoked again, it resumes from its
    last checkpoint and has no step left."""
    got = _torch_example("torch_train_lm.py", tmp_path, *TRAIN_TINY)
    assert got[0] == "model dense-3m: 0.9M params" and got[-1].startswith("final loss: ")
    again = _torch_example("torch_train_lm.py", tmp_path, *TRAIN_TINY)
    assert again[1:] == ["resumed from step 8",
                         "final loss: none (the checkpoint is already at step 8)"]


@pytest.mark.slow
def test_train_lm_example_equals_jax(torch_run, tmp_path):
    """Parameter count, logged steps and learning rates JAX's."""
    want = _jax_example("train_lm.py", tmp_path, *TRAIN_TINY)
    assert _weight_free(torch_run("torch_train_lm.py", *TRAIN_TINY)) == _weight_free(want)


_SHARDED_CHECKS = (
    "build: sharded gather is BIT-IDENTICAL to single-device build_forest",
    "sampling: 65536 owner-routed draws == all-reduce oracle == single-device draws",
    "delta update: no-op delta skips the tree rebuild entirely",
)


def _sharded(torch_run, world: int) -> list[str]:
    got = torch_run("torch_sharded_forest.py", "--world", str(world))
    assert got[0].startswith(f"devices: {world} x cpu (mesh ('data',) ({world},), gloo)")
    assert all(c in got for c in _SHARDED_CHECKS)
    assert any(ln.startswith("delta update: 1/") and "bit-identical" in ln for ln in got)
    assert sum(ln.lstrip().startswith("D=") for ln in got) == world.bit_length()
    return got


def test_sharded_forest_example_one_rank(torch_run):
    got = _sharded(torch_run, 1)
    assert "sharded over 1 shards, cell ranges [0,16384)" in got


def _sharded_checks(lines: list[str]) -> list[str]:
    """The walkthrough's lines before its timing sweep, in the port's
    wording: the header without the mesh, the oracle named as the port
    names it, a hyphen for the em dash."""
    sweep = next(i for i, ln in enumerate(lines) if ln.startswith("build/sample timing sweep"))
    head = [re.sub(r" \(mesh .*\)$", "", lines[0])] + lines[1:sweep]
    return [ln.replace("masked-psum oracle", "all-reduce oracle").replace(" \u2014 ", " - ")
            for ln in head]


@pytest.mark.slow
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_forest_example_gloo(torch_run, tmp_path, world):
    """Each rank a process on a gloo group: every rank checks the sharded
    build and both drains against the single-device path, and every line
    before the timing sweep equals ``sharded_forest.py``'s on ``world``
    fake XLA devices."""
    got = _sharded(torch_run, world)
    cells = 16384 // world
    assert got[1].startswith(f"sharded over {world} shards, cell ranges [0,{cells}), "
                             f"[{cells},{2 * cells})")
    want = _jax_example("sharded_forest.py", tmp_path,
                        XLA_FLAGS=f"--xla_force_host_platform_device_count={world}")
    assert want[0] == f"devices: {world} x cpu"
    assert _sharded_checks(got) == _sharded_checks(want)
    assert len(_sharded_checks(got)) == 11
