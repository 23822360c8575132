"""The port's hand-written CUDA kernels against their plain versions.

These tests need the card: each skips (inside a fixture) where there is
none. The file imports only the port, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Distances and descents are held bit-exact / elementwise; scans to
``SCAN_ATOL`` times the row total (the kernel reassociates the sum).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import build_forest, forest_from_cdf
from repro_torch.kernels import ref
from repro_torch.kernels.cdf_scan import SCAN_ATOL, cdf_scan
from repro_torch.kernels.forest_delta import forest_delta
from repro_torch.kernels.forest_sample import forest_sample

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    return torch.device("cuda")


def test_forest_delta_bit_exact(cuda):
    data = torch.sort(torch.rand(100_003, generator=torch.Generator().manual_seed(0))).values
    for m in (1, 7, 4096, 1 << 17):
        got = forest_delta(data.to(cuda), m)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref.ref_forest_delta(data, m))


@pytest.mark.parametrize("mode", ["softmax", "weights", "raw"])
def test_cdf_scan_matches_plain(cuda, mode):
    g = torch.Generator().manual_seed(1)
    softmax, normalize = mode == "softmax", mode != "raw"
    for B, V in ((1, 1), (3, 1000), (64, 16384), (2, 50257)):
        x = torch.randn(B, V, generator=g) * 3 if softmax else torch.rand(B, V, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            got = cdf_scan(xd.to(cuda), softmax=softmax, normalize=normalize).cpu()
            want = ref.ref_cdf_scan(xd, softmax=softmax, normalize=normalize)
            assert torch.all((got - want).abs() <= SCAN_ATOL * want[:, -1:].abs())


def _tied(hot, hot2):
    w = np.zeros(300, np.float32)
    w[hot] = 1.2
    if hot2 is not None:
        w[hot2] = 0.8
    return w


_FORESTS = {
    "power8": (np.random.default_rng(0).random(5000) ** 8 + 1e-9, 1024),
    "power20": (np.random.default_rng(1).random(5000) ** 20 + 1e-9, 64),
    "spike_at_zero": (_tied(150, None), 16),
    "interior_ties": (_tied(0, 299), 16),
    "dyadic_chain": (np.asarray([2.0 ** -(i + 1) for i in range(24)] + [2.0 ** -24],
                                np.float32), 1),
}


@pytest.mark.parametrize("name", list(_FORESTS))
def test_forest_sample_matches_plain(cuda, name):
    w, m = _FORESTS[name]
    f = build_forest(w, m, device="cpu")
    fd = type(f)(*(t.to(cuda) for t in f))
    xi = torch.rand(100_000, generator=torch.Generator().manual_seed(2))
    for fb in (True, False):
        got = forest_sample(*fd[:4], fd.cell_first, fd.fallback, xi.to(cuda),
                            use_fallback=fb).cpu()
        want = forest_sample(*f[:4], f.cell_first, f.fallback, xi, use_fallback=fb)
        assert torch.equal(got, want)


def test_build_forest_on_card_equals_plain_build(cuda):
    """Same CDF bits in, same six arrays out, on either device."""
    w = np.random.default_rng(3).random(70_000) ** 4
    fd = build_forest(w, 4096, device=cuda)
    f = forest_from_cdf(fd.cdf.cpu(), 4096, device="cpu")
    for a, b in zip(fd, f):
        assert torch.equal(a.cpu(), b)
