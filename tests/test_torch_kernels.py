"""The port's kernel wrappers against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode or through ``repro.kernels.ref``.
``tests/test_torch_cuda.py`` holds the hand-written kernels against the
plain versions on the card.

Tolerances: distances and descents are bit-exact / elementwise. Scans are
held to ``SCAN_ATOL`` (3e-6) times the row total: both sides reassociate
the float32 sum differently, and the JAX suite holds its own kernel to its
reference with the same 3e-6.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import build_forest as jax_build_forest
from repro.core import forest_to_numpy as jax_forest_to_numpy
from repro.core import normalize_weights
from repro.core import sample_forest as jax_sample_forest
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.cdf_scan import cdf_scan as jax_cdf_scan
from repro.kernels.forest_delta import forest_delta as jax_forest_delta
from repro_torch.core import build_forest
from repro_torch.interop import forest_from_numpy
from repro_torch.kernels.cdf_scan import SCAN_ATOL, cdf_scan
from repro_torch.kernels.forest_delta import forest_delta
from repro_torch.kernels.forest_sample import forest_sample


@pytest.mark.parametrize("n,m", [(2, 1), (100, 7), (8192, 4096)])
def test_forest_delta_plain_bit_exact(n, m):
    rng = np.random.default_rng(n)
    data = np.sort(rng.random(n)).astype(np.float32)
    want = np.asarray(jax_forest_delta(jnp.asarray(data), m, interpret=True))
    want_ref = np.asarray(jax_ref.ref_forest_delta(jnp.asarray(data), m))
    got = forest_delta(torch.from_numpy(data), m).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(got, want_ref.astype(np.int64))


@pytest.mark.parametrize("B,V", [(1, 100), (3, 1000), (2, 4096)])
@pytest.mark.parametrize("mode", ["softmax", "weights", "raw"])
def test_cdf_scan_plain_matches_pallas(B, V, mode):
    rng = np.random.default_rng(B * V)
    softmax, normalize = mode == "softmax", mode != "raw"
    if softmax:
        x = rng.normal(0, 3, (B, V)).astype(np.float32)
    else:
        x = (rng.random((B, V)) + 1e-3).astype(np.float32)
    want = np.asarray(jax_cdf_scan(jnp.asarray(x), softmax=softmax,
                                   normalize=normalize, interpret=True))
    got = cdf_scan(torch.from_numpy(x), softmax=softmax, normalize=normalize).numpy()
    total = want[:, -1:]
    assert np.all(np.abs(got - want) <= SCAN_ATOL * total)


def test_cdf_scan_plain_bf16_softmax():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 3, (2, 1000)).astype(np.float32)
    want = np.asarray(jax_cdf_scan(jnp.asarray(x, jnp.bfloat16), interpret=True))
    got = cdf_scan(torch.from_numpy(x).to(torch.bfloat16)).numpy()
    assert np.all(np.abs(got - want) <= SCAN_ATOL)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        cdf_scan(torch.zeros(4, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        cdf_scan(torch.zeros(4, 4), softmax=True, normalize=False)
    with pytest.raises(ValueError):
        forest_delta(torch.zeros(4, dtype=torch.float64), 4)
    f = build_forest(np.ones(8, np.float32), 4, device="cpu")
    with pytest.raises(ValueError):
        forest_sample(*f[:4], f.cell_first, f.fallback, torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError):
        forest_sample(f.cdf, f.table, f.left, f.right, f.cell_first,
                      f.fallback.to(torch.int32), torch.zeros(3))


def _tied(hot, hot2):
    w = np.zeros(300, np.float32)
    w[hot] = 1.2
    if hot2 is not None:
        w[hot2] = 0.8
    return w


_FORESTS = {
    **{f"power{p}_{n}_{m}": (n, m, p) for p in (1, 8, 20) for n, m in ((1000, 256),)},
    "spike_at_zero": (_tied(150, None), 16, None),
    "interior_ties": (_tied(0, 299), 16, None),
    "dyadic_chain": (np.asarray([2.0 ** -(i + 1) for i in range(24)] + [2.0 ** -24],
                                np.float32), 1, None),
}


def _forest_case(name):
    spec = _FORESTS[name]
    if spec[2] is None:
        w, m = spec[0], spec[1]
    else:
        n, m, power = spec
        rng = np.random.default_rng(n + power)
        w = normalize_weights(rng.random(n) ** power + 1e-9)
    return jax_build_forest(jnp.asarray(w), m)


@pytest.mark.parametrize("name", list(_FORESTS))
def test_forest_sample_plain_matches_jax(name):
    jf = _forest_case(name)
    f = forest_from_numpy(jax_forest_to_numpy(jf), "cpu")
    xi = np.random.default_rng(1).random(2048).astype(np.float32)
    got = forest_sample(*f[:4], f.cell_first, f.fallback, torch.from_numpy(xi)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_sample_forest(jf, jnp.asarray(xi))))
    np.testing.assert_array_equal(
        got, np.asarray(jax_ops.forest_sample(jf, jnp.asarray(xi), use_pallas=False)))
    raw = forest_sample(*f[:4], f.cell_first, f.fallback, torch.from_numpy(xi),
                        use_fallback=False).numpy()
    np.testing.assert_array_equal(
        raw, np.asarray(jax_sample_forest(jf, jnp.asarray(xi), use_fallback=False)))
