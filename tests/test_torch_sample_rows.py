"""The port's per-row inverse-CDF search (kernel B9's plain version) and the
softmax scan at an LM vocabulary, against the JAX package.

``ref_sample_rows`` is the two-level tiled count of the JAX kernel
``_sample_kernel``. On monotone rows it equals JAX's
``ref.ref_sample_rows`` (searchsorted right, clipped) elementwise; on rows
with a dip only the count is defined, and it is held elementwise to a numpy
transcription of ``_sample_kernel``. The JAX Pallas kernel itself does not
run on the installed JAX (ROADMAP C1), so it is not called here.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.ref import ref_cdf_scan as jax_ref_cdf_scan
from repro.kernels.ref import ref_sample_rows as jax_ref_sample_rows
from repro_torch.kernels import ops
from repro_torch.kernels.cdf_scan import SCAN_ATOL
from repro_torch.kernels.ref import ref_cdf_scan, ref_sample_rows
from repro_torch.kernels.sample_tiled import TILE, sample_rows

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

QWEN_VOCAB = 151936


def _kernel_np(row: np.ndarray, xi: np.ndarray, tile: int = TILE) -> np.ndarray:
    """``_sample_kernel`` of repro/kernels/sample_tiled.py, one row, in numpy:
    pad with 2.0 to whole tiles, count cutpoints, count inside the tile."""
    V = row.shape[0]
    nt = -(-V // tile)
    cp = np.concatenate([row, np.full(nt * tile - V, 2.0, np.float32)])
    bounds = cp.reshape(nt, tile)[:, -1]
    out = []
    for u in xi:
        t = min(int(np.sum(bounds <= u)), nt - 1)
        off = int(np.sum(cp[t * tile:(t + 1) * tile] <= u))
        out.append(min(t * tile + min(off, tile - 1), V - 1))
    return np.asarray(out, np.int32)


def _monotone_rows(B: int, V: int, rng) -> np.ndarray:
    logits = jnp.asarray(rng.normal(0.0, 3.0, (B, V)), jnp.float32)
    return np.asarray(jax_ref_cdf_scan(logits))


@pytest.mark.parametrize("V", [1, 7, 511, 512, 513, 4096, 50257])
def test_plain_sample_rows_matches_jax_on_monotone_rows(V):
    rng = np.random.default_rng(V)
    B, k = 4, 8
    cdf = _monotone_rows(B, V, rng)
    xi = rng.random((B, k)).astype(np.float32)
    # the edges: 0, the row's last entry, the largest float below 1, and
    # entries of the row itself (exact boundaries, right side)
    xi[:, 0] = 0.0
    xi[:, 1] = cdf[:, -1]
    xi[:, 2] = np.float32(1.0 - 2.0 ** -24)
    for b in range(B):
        xi[b, 3:] = cdf[b, rng.integers(0, V, k - 3)]
    want = np.asarray(jax_ref_sample_rows(jnp.asarray(cdf), jnp.asarray(xi)))
    got = ref_sample_rows(torch.tensor(cdf), torch.tensor(xi)).numpy()
    np.testing.assert_array_equal(got, want)


def _dipped_rows(V: int, rng) -> list[np.ndarray]:
    """Rows that are not monotone: one-ulp dips at tile cutpoints, random
    noise, a row that falls, and a constant row."""
    base = np.cumsum(rng.random(V)).astype(np.float32)
    base /= base[-1]
    dip = base.copy()
    for j in range(TILE - 1, V - 1, TILE):  # a cutpoint above its successor
        dip[j] = np.nextafter(dip[j + 1], np.float32(2.0))
        dip[j + 1] = np.nextafter(dip[j + 1], np.float32(-1.0))
    noisy = (base + rng.normal(0.0, 1e-3, V)).astype(np.float32)
    falling = base[::-1].copy()
    flat = np.full(V, 0.5, np.float32)
    return [dip, noisy, falling, flat]


@pytest.mark.parametrize("V", [600, 1536, 5000])
def test_plain_sample_rows_matches_kernel_transcription_on_dipped_rows(V):
    rng = np.random.default_rng(V + 1)
    rows = np.stack(_dipped_rows(V, rng))
    B, k = rows.shape[0], 16
    xi = rng.random((B, k)).astype(np.float32)
    for b in range(B):
        xi[b, :8] = rows[b, rng.integers(0, V, 8)]
    xi[:, 8] = 0.0
    xi[:, 9] = np.float32(1.0 - 2.0 ** -24)
    got = ref_sample_rows(torch.tensor(rows), torch.tensor(xi)).numpy()
    want = np.stack([_kernel_np(rows[b], xi[b]) for b in range(B)])
    np.testing.assert_array_equal(got, want)


def test_sample_rows_wrapper_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(3)
    cdf = torch.tensor(_monotone_rows(3, 1000, rng))
    xi = torch.rand(3, 2, generator=torch.Generator().manual_seed(0))
    before = sample_rows.launches
    got = ops.sample_rows(cdf, xi)
    assert got.dtype == torch.int32 and got.shape == (3, 2)
    assert torch.equal(got, ref_sample_rows(cdf, xi))
    assert sample_rows.launches == before  # counts kernel launches only
    with pytest.raises(ValueError):
        ops.sample_rows(cdf.double(), xi)
    with pytest.raises(ValueError):
        ops.sample_rows(cdf, xi[:2])
    with pytest.raises(ValueError):
        ops.sample_rows(cdf[:, :0], xi)


def test_softmax_scan_at_qwen_vocabulary_within_scan_atol():
    """The port's plain softmax scan (normalize, then scan) against JAX's
    reference (scan, then divide by the last entry) at V = 151936, the
    Qwen vocabulary: within ``SCAN_ATOL`` (row totals are 1)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(0.0, 3.0, (4, QWEN_VOCAB)).astype(np.float32)
    want = np.asarray(jax_ref_cdf_scan(jnp.asarray(logits)))
    got = ref_cdf_scan(torch.tensor(logits)).numpy()
    assert np.abs(got - want).max() <= SCAN_ATOL
