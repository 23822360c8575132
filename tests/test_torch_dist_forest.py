"""The port's cell-partitioned sharded forest (``repro_torch.dist.forest``,
over ``torch.distributed`` with gloo on the CPU) against the JAX package's
``repro.dist.forest`` and unsharded builds.

The contract, as in ``tests/test_dist_forest.py``: the windowed sharded
build gathered is bit-identical to the unsharded build (here: to JAX's
``build_forest`` given JAX's CDF bits, ROADMAP C2), for equal, rebalanced
and explicit partitions; both drains (owner-routed and the all-reduce
oracle) equal ``sample_forest`` elementwise; ``update_forest_sharded``
equals a from-scratch sharded build over the same partition and capacity
(no-op, sparse and full deltas, capacity hysteresis); ``drain_plan``
equals JAX's ``_drain_plan`` arithmetic on the same forest and batch; the
sharded consumers draw what the unsharded ones draw (and, for the
forest and mixture samplers on dyadic weights, what JAX's draw); a forest of 2 shards on a group of 1 degrades to the
gathered single-device descent.

One script holds every check. It runs in this process on a gloo group of
one rank, and, marked ``slow`` (each size pays a subprocess and its ranks'
start-up), at world sizes 2 and 4 in one subprocess per size whose ranks
``torch.multiprocessing.spawn`` starts. JAX's references are computed here
and handed over in a pickle; the subprocesses import no JAX.
"""
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
import torch.distributed as dist

from repro.core import build_forest as jax_build_forest
from repro.core import forest_to_numpy as jax_forest_to_numpy
from repro.core import sample_forest as jax_sample_forest
from repro.core.cdf import build_cdf as jax_build_cdf
from repro.data.mixture import MixtureSampler as JaxMixture
from repro.dist import forest as JDF
from repro.serve.sampler import ForestSampler as JaxForestSampler
from repro_torch.ckpt import load_state
from repro_torch.core import forest_to_numpy, sample_forest
from repro_torch.dist import forest as DF

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("cdf", "table", "left", "right", "cell_first", "fallback")
KINDS = ("uniform", "powerlaw", "ties", "zeros", "wide", "single", "spiky", "zipf")


def _weights(kind: str, n: int, rng) -> np.ndarray:
    """The weight families of the JAX dist suite (conformance and
    rebalance)."""
    if kind == "uniform":
        return rng.random(n).astype(np.float32) + np.float32(1e-3)
    if kind == "powerlaw":
        return rng.random(n).astype(np.float32) ** 8 + np.float32(1e-9)
    if kind == "ties":
        base = rng.random(max(n // 8, 1)).astype(np.float32) + np.float32(1e-3)
        return base[rng.integers(0, len(base), n)]
    if kind == "zeros":
        w = rng.random(n).astype(np.float32)
        w[rng.random(n) < 0.5] = 0.0
        w[rng.integers(0, n)] = 1.0
        return w
    if kind == "wide":
        return (10.0 ** rng.uniform(-30, 30, n)).astype(np.float32)
    if kind == "single":
        return rng.random(1).astype(np.float32) + np.float32(0.5)
    if kind == "spiky":
        w = rng.random(n).astype(np.float32) * np.float32(1e-5)
        w[rng.integers(0, n, max(n // 16, 1))] += np.float32(50.0)
        return w
    return (1.0 / np.arange(1, n + 1, dtype=np.float64) ** 1.3).astype(np.float32)


def _dyadic(n: int, rng) -> np.ndarray:
    c = rng.integers(1, 8, n)
    extra = (1 << int(np.ceil(np.log2(c.sum())))) - c.sum()
    np.add.at(c, rng.integers(0, n, extra), 1)
    return c.astype(np.float64)


@functools.lru_cache(maxsize=1)
def _references() -> dict:
    """Every case's inputs and JAX's answers (the same for every world
    size; computed once a process)."""
    rng = np.random.default_rng(100)
    cases = []
    for kind in KINDS:
        for n, m in ([(1, 8)] if kind == "single" else
                     [(600, 64)] if kind in ("spiky", "zipf") else [(13, 8), (300, 64)]):
            w = _weights(kind, n, rng)
            cdf = jax_build_cdf(jnp.asarray(w))
            f = jax_build_forest(jnp.asarray(w), m)
            xi = rng.random(509).astype(np.float32)
            xi[:3] = (0.0, 1 - 2**-24, xi[3])  # ends and a duplicate
            cases.append(dict(kind=kind, m=m, w=w, cdf=np.asarray(cdf),
                              forest=jax_forest_to_numpy(f), xi=xi,
                              draws=np.asarray(jax_sample_forest(f, jnp.asarray(xi)))))
    dy = _dyadic(96, rng)
    js = JaxForestSampler(dy, m=64, seed=2)
    mix_w = np.asarray([0.5, 0.25, 0.125, 0.0625, 0.0625])
    jm = JaxMixture(mix_w, m=64, seed=1)
    img = rng.integers(0, 8, (8, 16)).astype(np.float64)
    img[:, -1] = 64 * 16 - img[:, :-1].sum(1)  # dyadic rows and masses
    pts = rng.random((300, 2)).astype(np.float32)
    return dict(
        cases=cases, dyadic=dy,
        forest_sampler=[js.sample(np.arange(32)) for _ in range(3)],
        mix_w=mix_w, mixture=[jm.sample(s, 256) for s in (0, 7)],
        img=img, pts=pts,
        drain_xi=rng.random(1 << 12).astype(np.float32),
    )


# The checks, run on every rank of a group of ``D`` gloo ranks; rank 0
# returns what the parent compares with JAX (the drain plans, the forest
# to degrade). No JAX here.
_SCRIPT = r'''
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import build_forest, forest_to_numpy, sample_forest
from repro_torch.data import MixtureSampler
from repro_torch.dist import forest as DF
from repro_torch.serve import ForestSampler
from repro_torch.spatial import Map2DSampler

KEYS = ("cdf", "table", "left", "right", "cell_first", "fallback")
CPU = dict(device="cpu")


def same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), what


def same_sharded(a, b, what):
    for k in DF.ShardedForest._fields:
        same(getattr(a, k).numpy(), getattr(b, k).numpy(), (what, k))


def run_checks(ref, save_dir=None):
    D, rank = dist.get_world_size(), dist.get_rank()
    out = {"plans": []}
    rng = np.random.default_rng(7)
    for c in ref["cases"]:
        m, tag = c["m"], (c["kind"], len(c["w"]), c["m"])
        parts = [{}, {"rebalance": True}]
        if D > 1:
            explicit = np.linspace(0, m, D + 1).astype(int)
            explicit[1] = 1  # a lopsided first cell range
            parts.append({"partition": explicit})
        for kw in parts:
            sf = DF.build_forest_from_cdf_sharded(c["cdf"], m, **kw, **CPU)
            g = forest_to_numpy(DF.gather_forest(sf))
            for k in KEYS:
                same(g[k], c["forest"][k], (tag, kw, k))
            assert sf.left.shape == (D, sf.capacity)
            counts = sf.window_count.numpy()
            assert counts.sum() == sf.n and counts.max() <= sf.capacity
            for routed in (True, False):
                got = DF.sample_sharded(sf, c["xi"], routed=routed, **CPU)
                same(got.numpy(), c["draws"], (tag, kw, routed))
        # from weights: the port's own scan, sharded and not
        f1 = forest_to_numpy(build_forest(c["w"], m, **CPU))
        sf = DF.build_forest_sharded(c["w"], m, **CPU)
        g = forest_to_numpy(DF.gather_forest(sf))
        for k in KEYS:
            same(g[k], f1[k], (tag, "weights", k))
        same(DF.build_cdf_sharded(c["w"], **CPU).numpy(), f1["cdf"], (tag, "cdf"))
        if D > 1 and c["kind"] == "uniform" and len(c["w"]) == 300:
            assert sf.capacity < sf.n  # the window shrinks below the world

    # tiny batches (B < D included) and the empty one
    c = ref["cases"][2]
    sf = DF.build_forest_from_cdf_sharded(c["cdf"], c["m"], **CPU)
    f = build_forest(c["w"], c["m"], **CPU)
    for B in (1, 2, 3, D + 1):
        xi = rng.random(B).astype(np.float32)
        same(DF.sample_sharded(sf, xi, **CPU).numpy(),
             sample_forest(f, xi, **CPU).numpy(), ("tiny", B))
    try:
        DF.sample_sharded(sf, np.zeros(0, np.float32), **CPU)
        raise AssertionError("an empty batch must raise")
    except ValueError:
        pass

    # drain plans of a balanced, a skewed and an odd batch
    n = m = 1024
    w = rng.random(n).astype(np.float32) + np.float32(1e-3)
    sf = DF.build_forest_sharded(w, m, **CPU)
    for xi in (ref["drain_xi"], np.full(1 << 12, 0.999, np.float32), ref["drain_xi"][:D * 16 + 3]):
        plan = DF.drain_plan(sf, xi, **CPU)
        assert plan["send_counts"].sum() == plan["padded_batch"]
        assert plan["descent_lanes"] == D * plan["bucket_capacity"]
        out["plans"].append((plan, xi))
    out["plan_forest"] = {k: getattr(sf, k).numpy() for k in DF.ShardedForest._fields}

    # delta updates: no-op, sparse (one leaf), full; hysteresis
    n, m = 1024, 64
    w0 = rng.integers(2, 50, n).astype(np.float32)
    sf0 = DF.build_forest_sharded(w0, m, **CPU)
    for w_same in (w0, w0 * np.float32(2.0)):
        upd, st = DF.update_forest_sharded(sf0, w_same, with_stats=True, **CPU)
        assert not st["rebuilt"] and st["dirty_shards"] == 0 and st["rebuilt_windows"] == 0
        same_sharded(upd, sf0, "noop")
    w1 = w0.copy()
    w1[500] += 1.0
    w1[501] -= 1.0
    upd, st = DF.update_forest_sharded(sf0, w1, with_stats=True, **CPU)
    rebuilt = DF.build_forest_sharded(w1, m, partition=sf0.cell_bounds.numpy(),
                                      capacity=upd.capacity, **CPU)
    same_sharded(upd, rebuilt, "sparse")
    assert st["dirty_chunks"] == 1
    if not st["plan_changed"]:
        assert st["rebuilt_windows"] == st["dirty_shards"] == 1
    w2 = rng.random(n).astype(np.float32) + np.float32(1e-3)
    upd, st = DF.update_forest_sharded(sf0, w2, with_stats=True, **CPU)
    same_sharded(upd, DF.build_forest_sharded(w2, m, partition=sf0.cell_bounds.numpy(),
                                              capacity=upd.capacity, **CPU), "full")
    assert st["rebuilt_windows"] == D
    for k in KEYS:
        same(forest_to_numpy(DF.gather_forest(upd))[k],
             forest_to_numpy(build_forest(w2, m, **CPU))[k], ("full gather", k))
    a = DF.update_forest_sharded(sf0, weights_delta=w1 - w0, base_weights=w0, **CPU)
    same_sharded(a, DF.update_forest_sharded(sf0, w0 + (w1 - w0), **CPU), "delta form")
    for bad in (dict(weights=w2[:-1]), dict(weights_delta=w1 - w0)):
        try:
            DF.update_forest_sharded(sf0, **bad, **CPU)
            raise AssertionError(f"{sorted(bad)} must raise")
        except ValueError:
            pass
    w_hi = np.full(n, 1e-6, np.float32)
    w_hi[: n // 8] = 1.0
    w_lo = rng.random(n).astype(np.float32) + np.float32(0.5)
    sf = DF.build_forest_sharded(w_hi, m, **CPU)
    cap0 = sf.capacity
    for w in (w_lo, w_hi, w_lo):
        sf, st = DF.update_forest_sharded(sf, w, with_stats=True, **CPU)
        assert sf.capacity == st["capacity"] == cap0
        g = forest_to_numpy(DF.gather_forest(sf))
        same(g["left"], forest_to_numpy(build_forest(w, m, **CPU))["left"], "hysteresis")
    if D > 1:
        assert DF.build_forest_sharded(w_lo, m, **CPU).capacity < cap0
        try:
            DF.build_forest_sharded(w_lo, m, capacity=1, **CPU)
            raise AssertionError("a too small capacity must raise")
        except ValueError:
            pass

    # the sharded consumers draw what the unsharded ones and JAX's draw
    for kw in ({}, {"rebalance": True}, {"routed": False}):
        s = ForestSampler(ref["dyadic"], m=64, sharded=True, seed=2, **kw, **CPU)
        u = ForestSampler(ref["dyadic"], m=64, seed=2, **CPU)
        for want in ref["forest_sampler"]:
            slots = np.arange(32)
            same(s.sample(slots), want, ("forest sampler", kw))
            same(u.sample(slots), want, ("forest sampler", "unsharded"))
        s.update_weights(ref["dyadic"][::-1].copy())
        u.update_weights(ref["dyadic"][::-1].copy())
        same(s.sample(np.arange(32)), u.sample(np.arange(32)), ("forest sampler update", kw))
    mx = MixtureSampler(ref["mix_w"], m=64, seed=1, sharded=True, **CPU)
    for step, want in zip((0, 7), ref["mixture"]):
        same(mx.sample(step, 256), want, ("mixture", step))
    mu = MixtureSampler(ref["mix_w"], m=64, seed=1, **CPU)
    mx.update_weights(ref["mix_w"][::-1].copy())
    mu.update_weights(ref["mix_w"][::-1].copy())
    same(mx.sample(3, 128), mu.sample(3, 128), "mixture update")
    # the unsharded map equals JAX's on dyadic maps (tests/test_torch_spatial.py)
    ms = Map2DSampler(ref["img"], m_marginal=16, sharded=True, **CPU)
    mu = Map2DSampler(ref["img"], m_marginal=16, **CPU)
    for a, b in zip(ms.sample_map(ref["pts"])[:2], mu.sample_map(ref["pts"])[:2]):
        same(a.numpy(), b.numpy(), "map")
    assert ms.last_drain["marginal"] == "sharded" and ms.stats()["sharded"]
    rows = {2: np.roll(ref["img"][2], 3), 5: ref["img"][1].copy()}
    st_s, st_u = ms.update_map(dict(rows)), mu.update_map(dict(rows))
    assert st_s["marginal_rebuilt"] == st_u["marginal_rebuilt"]
    for a, b in zip(ms.sample_map(ref["pts"])[:2], mu.sample_map(ref["pts"])[:2]):
        same(a.numpy(), b.numpy(), "map after update")

    if save_dir is not None and D == 2:
        from repro_torch.ckpt import save_state

        sf = DF.build_forest_from_cdf_sharded(ref["cases"][2]["cdf"], ref["cases"][2]["m"], **CPU)
        if rank == 0:
            save_state(save_dir, {"forest": tuple(sf)}, 1)
        # a group of one rank: the 2-shard forest raises, or degrades
        sub = dist.new_group([0])
        if rank == 0:
            xi = ref["cases"][2]["xi"]
            try:
                DF.sample_sharded(sf, xi, group=sub, **CPU)
                raise AssertionError("a shard-count mismatch must raise")
            except ValueError:
                pass
            got, st = DF.sample_sharded(sf, xi, group=sub, on_mismatch="degrade",
                                        with_stats=True, **CPU)
            assert st["degraded"] and st["n_shards"] == 2 and st["mesh_devices"] == 1
            same(got.numpy(), ref["cases"][2]["draws"], "degrade")
        dist.barrier()
    return out if rank == 0 else None


def worker(rank, D, store_path, ref_path, out_path, save_dir):
    import pickle

    dist.init_process_group("gloo", store=dist.FileStore(store_path, D), rank=rank,
                            world_size=D)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    out = run_checks(ref, save_dir)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import sys
    import torch.multiprocessing as mp

    D = int(sys.argv[1])
    tmp = sys.argv[2]
    mp.spawn(worker, args=(D, tmp + "/store", tmp + "/ref.pkl", tmp + "/out.pkl",
                           tmp + "/forest"), nprocs=D)
    print("DIST_OK", D)
'''


def _jax_plan(out: dict, D: int):
    """JAX's ``_drain_plan`` arithmetic on the port's forest and batches."""
    jsf = JDF.ShardedForest(*(jnp.asarray(out["plan_forest"][k])
                              for k in JDF.ShardedForest._fields))
    for plan, xi in out["plans"]:
        want, _ = JDF._drain_plan(jsf, jnp.asarray(xi), D)
        for k, v in want.items():
            assert np.array_equal(np.asarray(plan[k]), np.asarray(v)), k


@pytest.fixture(scope="module")
def group_of_one(tmp_path_factory):
    """A gloo process group of one rank in this process."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("store") / "s"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_sharded_forest_on_one_rank(group_of_one):
    ns = {}
    exec(compile(_SCRIPT, "dist_forest_checks", "exec"), ns)
    out = ns["run_checks"](_references())
    _jax_plan(out, 1)


def test_partitions_and_plans_equal_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        counts = rng.integers(0, 30, int(rng.integers(1, 9)))
        d = int(rng.integers(1, 5))
        b = DF.occupancy_partition(counts, d)
        assert np.array_equal(b, JDF.occupancy_partition(counts, d))
        if counts.sum():
            cells = np.repeat(np.arange(len(counts)), counts)
            for x, y in zip(DF._plan_windows(cells, b, int(counts.sum())),
                            JDF._plan_windows(cells, b, int(counts.sum()))):
                assert np.array_equal(x, y)
    assert np.array_equal(DF.cell_partition(64, 8), JDF.cell_partition(64, 8))
    for k in (1, 15, 16, 17, 1000):
        assert DF._round_bucket(k, 600) == JDF._round_bucket(k, 600)
        assert DF._round_capacity(k, 700) == JDF._round_capacity(k, 700)
    for bad in (lambda: DF.cell_partition(10, 4), lambda: DF.occupancy_partition([], 2),
                lambda: DF.occupancy_partition([1, 2], 0),
                lambda: DF.resolve_partition(8, 2, partition=[0, 3, 7])):
        with pytest.raises(ValueError):
            bad()


def test_group_checks(group_of_one):
    """The device names the backend: a gloo group serves CPU tensors only;
    a bad ``on_mismatch`` raises."""
    w = np.random.default_rng(0).random(32).astype(np.float32)
    sf = DF.build_forest_sharded(w, 8, device="cpu")
    with pytest.raises(ValueError, match="on_mismatch"):
        DF.sample_sharded(sf, w, on_mismatch="guess", device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="nccl"):
            DF.sample_sharded(sf, w, device="cuda")


@pytest.mark.slow
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_forest_on_gloo_ranks_subprocess(D, tmp_path, group_of_one):
    """Every check of the script at world size ``D`` (2 and 4), in one
    subprocess of ``D`` gloo ranks; JAX's drain plans here; at 2, the
    saved 2-shard forest loaded here and degraded on this group of one."""
    with open(tmp_path / "ref.pkl", "wb") as f:
        pickle.dump(_references(), f)
    (tmp_path / "checks.py").write_text(_SCRIPT)  # spawn re-imports it by path
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, str(tmp_path / "checks.py"), str(D), str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0 and f"DIST_OK {D}" in p.stdout, p.stderr[-4000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        out = pickle.load(f)
    _jax_plan(out, D)
    if D == 2:
        state, _ = load_state(tmp_path / "forest")
        sf = DF.ShardedForest(*(torch.from_numpy(np.asarray(a)) for a in state["forest"]))
        assert sf.n_shards == 2
        ref = _references()["cases"][2]
        got, st = DF.sample_sharded(sf, ref["xi"], on_mismatch="degrade", with_stats=True,
                                    device="cpu")
        assert st["degraded"]
        assert np.array_equal(got.numpy(), ref["draws"])
        assert np.array_equal(got.numpy(),
                              sample_forest(DF.gather_forest(sf), ref["xi"], device="cpu").numpy())
