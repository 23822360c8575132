"""The port's samplers against the JAX package's, over the same forest.

The forest comes across through ``forest_from_numpy(forest_to_numpy(...))``
so both sides descend identical arrays; every sampler must agree
elementwise (the visit counts of ``sample_forest_with_stats`` too).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from repro.core import build_forest as jax_build_forest
from repro.core import forest_to_numpy as jax_forest_to_numpy
from repro.core import normalize_weights
from repro.core import sample as jax_sample
from repro_torch.core import sample as S
from repro_torch.interop import forest_from_numpy


def _cases():
    rng = np.random.default_rng(4)
    tied = np.zeros(300, np.float32)
    tied[150] = 1.2
    chain = np.asarray([2.0 ** -(i + 1) for i in range(24)] + [2.0 ** -24], np.float32)
    return {
        "power8": (normalize_weights(rng.random(1000) ** 8 + 1e-9), 256),
        "power20": (normalize_weights(rng.random(1000) ** 20 + 1e-9), 256),
        "spike_at_zero": (tied, 16),
        "dyadic_chain": (chain, 1),
    }


_CASES = _cases()


@pytest.mark.parametrize("name", list(_CASES))
def test_samplers_match_jax(name):
    w, m = _CASES[name]
    jf = jax_build_forest(jnp.asarray(w), m)
    f = forest_from_numpy(jax_forest_to_numpy(jf), "cpu")
    xi = np.random.default_rng(9).random(1500).astype(np.float32)
    xi[:3] = (0.0, np.float32(np.nextafter(np.float32(1), np.float32(0))), 0.5)
    jxi = jnp.asarray(xi)

    def same(got, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    same(S.sample_forest(f, xi, device="cpu"), jax_sample.sample_forest(jf, jxi))
    same(S.sample_forest(f, xi, use_fallback=False, device="cpu"),
         jax_sample.sample_forest(jf, jxi, use_fallback=False))
    idx, visits = S.sample_forest_with_stats(f, xi, device="cpu")
    jidx, jvisits = jax_sample.sample_forest_with_stats(jf, jxi)
    same(idx, jidx)
    same(visits, jvisits)
    same(S.sample_binary(f.cdf, xi, device="cpu"), jax_sample.sample_binary(jf.cdf, jxi))
    same(S.sample_linear(f.cdf, xi, device="cpu"), jax_sample.sample_linear(jf.cdf, jxi))
    same(S.sample_cutpoint_binary(f.cdf, f.cell_first, xi, device="cpu"),
         jax_sample.sample_cutpoint_binary(jf.cdf, jf.cell_first, jxi))
    same(S.sample_cutpoint_linear(f.cdf, f.cell_first, xi, 64, device="cpu"),
         jax_sample.sample_cutpoint_linear(jf.cdf, jf.cell_first, jxi, 64))
