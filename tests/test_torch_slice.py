"""The port's first slice as a whole: weights -> CDF -> forest -> samples,
served through per-slot QMC streams, against the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import forest_to_numpy as jax_forest_to_numpy
from repro.serve.sampler import ForestSampler as JaxForestSampler
from repro.serve.sampler import QmcStreams as JaxQmcStreams
from repro_torch.configs.paper_workloads import TABLE1, env_map_2d
from repro_torch.core import build_forest, forest_to_numpy, sample_forest
from repro_torch.core.metrics import chi2_statistic, histogram
from repro_torch.kernels.cdf_scan import cdf_scan
from repro_torch.kernels.forest_delta import forest_delta
from repro_torch.kernels.forest_sample import forest_sample
from repro_torch.serve.sampler import ForestSampler, QmcStreams

_SRC = Path(__file__).resolve().parents[1] / "src"


def test_qmc_streams_bit_equal_to_jax():
    ours, theirs = QmcStreams(37, seed=5), JaxQmcStreams(37, seed=5)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(ours.offset_bits, theirs.offset_bits)
    for call in range(6):
        slots = rng.integers(0, 37, size=50 + call)  # many duplicate slots
        a, b = ours.next(slots), theirs.next(slots)
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
        np.testing.assert_array_equal(ours.counters, theirs.counters)
    np.testing.assert_array_equal(ours.next(), theirs.next())
    state = ours.snapshot()
    twin = QmcStreams.restore(state)
    slots = rng.integers(0, 37, size=20)
    np.testing.assert_array_equal(twin.next(slots), ours.next(slots))


def test_forest_sampler_from_jax_state_draws_the_same():
    w = TABLE1["i^20"](512)
    jax_sampler = JaxForestSampler(w, m=256, n_slots=64, seed=3)
    rng = np.random.default_rng(1)
    jax_sampler.sample(rng.integers(0, 64, size=40))  # advance the streams first
    ours = ForestSampler.from_state(
        jax_forest_to_numpy(jax_sampler.forest), jax_sampler.streams.snapshot(), "cpu")
    for _ in range(4):
        slots = rng.integers(0, 64, size=100)
        np.testing.assert_array_equal(ours.sample(slots), jax_sampler.sample(slots))
    np.testing.assert_array_equal(ours.streams.counters, jax_sampler.streams.counters)


def test_weights_to_samples_chi_square():
    w = env_map_2d(32, 64, seed=1).reshape(-1)
    f = build_forest(w, 1024, device="cpu")
    xi = torch.rand(1 << 18, generator=torch.Generator().manual_seed(0))
    idx = sample_forest(f, xi, device="cpu").numpy()
    cdf = f.cdf.numpy()
    assert np.all(cdf[idx] <= xi.numpy()) and np.all(xi.numpy() < cdf[idx + 1])
    p = w / w.sum()
    chi2 = chi2_statistic(histogram(idx, len(w)), p)
    dof = len(w) - 1
    assert chi2 < dof + 6 * np.sqrt(2 * dof)


def test_update_weights_rebuilds_and_keeps_streams():
    w = TABLE1["4 spikes"](256)
    sampler = ForestSampler(w, m=64, n_slots=16, seed=2, device="cpu")
    sampler.sample(np.arange(16))
    delta = np.zeros(256)
    delta[7] = 0.5
    sampler.update_weights(delta=delta)
    new_w = (w.astype(np.float64) + delta) / (w.astype(np.float64) + delta).sum()
    fresh = forest_to_numpy(build_forest(new_w.astype(np.float32), 64, device="cpu"))
    got = forest_to_numpy(sampler.forest)
    for key in fresh:
        np.testing.assert_array_equal(got[key], fresh[key])
    np.testing.assert_array_equal(sampler.streams.counters, np.ones(16, np.uint32))
    with pytest.raises(ValueError):
        sampler.update_weights(w, delta=delta)


def test_device_policy(monkeypatch):
    """Entry points default to the card and raise without one; on the CPU,
    when asked, they run the plain versions and launch no kernel."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = np.arange(1, 33, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_forest(w, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ForestSampler(w, m=8)
    with pytest.raises(NotImplementedError, match="A7"):
        ForestSampler(w, m=8, sharded=True, device="cpu")
    for fn in (cdf_scan, forest_delta, forest_sample):
        monkeypatch.setattr(fn, "launches", 0)
    f = build_forest(w, 8, device="cpu")
    sample_forest(f, torch.rand(100), device="cpu")
    assert f.cdf.device.type == "cpu"
    assert (cdf_scan.launches, forest_delta.launches, forest_sample.launches) == (0, 0, 0)


def test_package_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 19, names\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(_SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr
