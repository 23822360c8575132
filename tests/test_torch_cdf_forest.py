"""The port's CDF and forest construction against the JAX package.

Tree topology is a function of the CDF bits, and the port's scan does not
reproduce XLA's reassociation, so every bit gate here feeds the port the
reference's CDF; ``build_cdf`` itself is held to an ulp bound.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import build_cdf as jax_build_cdf
from repro.core import build_forest as jax_build_forest
from repro.core import forest_to_numpy as jax_forest_to_numpy
from repro.core.cdf import chunked_cumsum as jax_chunked_cumsum
from repro.core.cdf import finalize_cdf as jax_finalize_cdf
from repro_torch.core import build_cdf, build_forest_apetrei, forest_from_cdf
from repro_torch.core import forest_to_numpy, validate_forest
from repro_torch.core.cdf import _cummax, finalize_cdf
from repro_torch.core.forest import _allowed_depth

# Start JAX's backend while this file is collected: in every pytest process
# that is before any test runs. tests/test_imports.py imports
# repro.launch.dryrun in its own process, and that import sets XLA_FLAGS to
# 512 fake devices; once the backend is up, the flag no longer changes the
# device count that later test files in the same process see. Without this
# line, which JAX tests meet 512 devices depends on how pytest-xdist groups
# the test files on its workers, and the set of files decides that.
jax.devices()

# build_cdf vs repro.core.build_cdf, in float32 ulps. Both sum over the same
# 64-row grid and divide by the same rounded total; they differ only in the
# order of additions inside a row (XLA reassociates, the CPU scan
# accumulates sequentially). For non-negative terms the relative error of a
# prefix in any order is at most (additions on its path) * 2^-24, so the
# two differ by a few ulp: measured at most 5 over these families and
# sizes, and at most 4 at n = 2^20.
CDF_ULP_BOUND = 8

_KINDS = ("uniform", "powerlaw", "ties", "zeros", "wide", "single")


def _weights(kind: str, n: int, rng) -> np.ndarray:
    """The weight families of tests/test_core_forest.py."""
    if kind == "uniform":
        return rng.random(n).astype(np.float32) + np.float32(1e-3)
    if kind == "powerlaw":
        return (rng.random(n).astype(np.float32) ** 8) + np.float32(1e-9)
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
    return rng.random(1).astype(np.float32) + np.float32(0.5)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps, with subnormals read as 0: XLA on the CPU
    flushes subnormal quotients to zero, PyTorch keeps them (as IEEE does)."""
    tiny = np.finfo(np.float32).tiny
    a, b = (np.where(np.abs(x) < tiny, np.float32(0), x) for x in (a, b))
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("kind", _KINDS)
def test_build_cdf_within_ulp_bound(kind):
    rng = np.random.default_rng(_KINDS.index(kind))
    for n in (1,) if kind == "single" else (7, 1000, 5000):
        w = _weights(kind, n, rng)
        want = np.asarray(jax_build_cdf(jnp.asarray(w)))
        got = build_cdf(w, device="cpu").numpy()
        assert got[0] == 0.0 and got[-1] == 1.0
        assert np.all(np.diff(got) >= 0)
        assert _ulps(got, want).max() <= CDF_ULP_BOUND, (kind, n)


@pytest.mark.parametrize("kind", ["uniform", "powerlaw", "wide"])
def test_finalize_cdf_bit_equal_given_jax_raw_scan(kind):
    w = _weights(kind, 5000, np.random.default_rng(3))
    raw = jax_chunked_cumsum(jnp.asarray(w))
    want = np.asarray(jax_finalize_cdf(raw))
    got = finalize_cdf(torch.from_numpy(np.array(raw))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", [1, 2, 17, 4097, 100_003])
def test_two_level_cummax_equals_torch_cummax(n):
    x = torch.rand(n, generator=torch.Generator().manual_seed(n))
    assert torch.equal(_cummax(x), torch.cummax(x, 0).values)


@pytest.mark.parametrize("m", [1, 7, 64, 1024])
@pytest.mark.parametrize("kind", _KINDS)
def test_forest_from_reference_cdf_bit_identical(kind, m):
    """All six arrays equal JAX's, given JAX's CDF; the tree arrays equal
    the Algorithm-1 emulation; the forest is structurally valid."""
    rng = np.random.default_rng(1000 * m + _KINDS.index(kind))
    # Few distinct (n, m) shapes: each costs JAX a compile.
    for n in (1,) if kind == "single" else (13, 300) if m <= 7 else (300,):
        w = _weights(kind, n, rng)
        want = jax_forest_to_numpy(jax_build_forest(jnp.asarray(w), m))
        f = forest_from_cdf(want["cdf"], m, device="cpu")
        got = forest_to_numpy(f)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{kind} {n} {m} {key}")
        ap = build_forest_apetrei(got["cdf"], m)
        for key in ("table", "left", "right"):
            np.testing.assert_array_equal(got[key], ap[key])
        validate_forest(f)


def test_allowed_depth_integer_form_equals_float_formula():
    """ceil(log2(max(overlap, 2))) as the JAX package computes it in float32
    equals the port's integer bit length for every overlap up to 2^21
    (overlap <= n + 1, and the largest n built is 2^20). Past 2^21 the
    float32 log2 rounds 2^21 + 1 down to exactly 21."""
    v = np.arange(0, (1 << 21) + 1, dtype=np.int32)
    want = np.asarray(jnp.ceil(jnp.log2(jnp.maximum(jnp.asarray(v), 2).astype(jnp.float32))))
    got = _allowed_depth(torch.from_numpy(v.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
