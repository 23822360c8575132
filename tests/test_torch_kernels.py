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
from repro_torch.kernels import cdf_scan as scan_mod
from repro_torch.kernels.cdf_scan import SCAN_ATOL, cdf_scan, scan_in_kernel_order, scan_plan
from repro_torch.kernels.forest_delta import forest_delta
from repro_torch.kernels import ref
from repro_torch.kernels.forest_sample import forest_pack, forest_sample


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


def test_scan_plan_covers_every_length():
    """scan_plan is a function of V alone (the same plan from a fresh
    computation), covers every V from 1 to 2^20 with no gap, keeps a cluster
    at 8 blocks or fewer, leaves no block of a cluster empty, and keeps a
    block's shared memory within the H100's 227 KB."""
    plan = scan_plan.__wrapped__
    last_regime = scan_mod.WARP
    for V in range(1, (1 << 20) + 1):
        p = plan(V)
        if V % 4099 == 0:
            assert scan_plan(V) == p
        assert p.regime >= last_regime, V  # regimes follow V in order
        last_regime = p.regime
        if p.regime == scan_mod.WARP:
            assert V <= scan_mod.SHORT_MAX and p.cluster == 1 and p.smem == 0
            assert p.slice == p.rounds * scan_mod.ROUND and p.slice - scan_mod.ROUND < V <= p.slice
            assert p.threads % 32 == 0 and p.threads <= 256
        elif p.regime == scan_mod.CLUSTER:
            assert scan_mod.SHORT_MAX < V <= scan_mod.CAPACITY
            assert 1 <= p.cluster <= 8 and p.slice % 8 == 0
            assert p.cluster * p.slice >= V > (p.cluster - 1) * p.slice
            assert p.threads % 32 == 0 and 32 <= p.threads <= 1024
            assert 1 <= p.rounds <= scan_mod.CTA_ROUNDS
            assert (p.threads // 32) * p.rounds * scan_mod.ROUND >= p.slice
            assert p.smem <= 227 * 1024
        else:
            assert p.regime == scan_mod.BLOCK and V > scan_mod.CAPACITY
    assert scan_mod.CAPACITY == 8 * 32768


@pytest.mark.parametrize("B,V,mode", [(2, 151936, "softmax"), (64, 16384, "raw")])
def test_cdf_scan_kernel_order_matches_pallas(B, V, mode):
    """The kernel's association order (slices, rank-ordered shares) agrees
    with the JAX kernel in interpret mode within SCAN_ATOL x the row total:
    the decode path's softmax rows and the main path's chunk rows."""
    rng = np.random.default_rng(V)
    softmax, normalize = mode == "softmax", mode != "raw"
    if softmax:
        x = rng.normal(0, 3, (B, V)).astype(np.float32)
    else:
        x = (rng.random((B, V)) + 1e-3).astype(np.float32)
    want = np.asarray(jax_cdf_scan(jnp.asarray(x), softmax=softmax,
                                   normalize=normalize, interpret=True))
    got = scan_in_kernel_order(torch.from_numpy(x), softmax, normalize).numpy()
    assert np.all(np.abs(got - want) <= SCAN_ATOL * want[:, -1:])


@pytest.mark.parametrize("V", [1, 31, 32, 33, 128, 129, 1024, 1025, 2048, 2049, 16384,
                               151936, 202048, 8 * 32768])
@pytest.mark.parametrize("mode", ["softmax", "weights", "raw"])
def test_cdf_scan_kernel_order_matches_plain(V, mode):
    """At every regime boundary the kernel's order agrees with the plain
    version within SCAN_ATOL x the row total, in float32 and bfloat16; a
    normalized row ends at exactly 1 (its sum is its last prefix)."""
    rng = np.random.default_rng(V + len(mode))
    softmax, normalize = mode == "softmax", mode != "raw"
    x = rng.normal(0, 3, (3, V)) if softmax else rng.random((3, V))
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x.astype(np.float32)).to(dtype)
        got = scan_in_kernel_order(xt, softmax, normalize)
        want = cdf_scan(xt, softmax=softmax, normalize=normalize)
        assert torch.all((got - want).abs() <= SCAN_ATOL * want[:, -1:].abs())
        if normalize:
            assert torch.all(got[:, -1] == 1.0)


def test_cdf_scan_kernel_order_rejects_block_rows():
    with pytest.raises(ValueError):
        scan_in_kernel_order(torch.zeros(1, scan_mod.CAPACITY + 1))


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


@pytest.mark.parametrize("name", list(_FORESTS))
def test_forest_sample_packed_plain_matches_jax(name):
    """The packed layout's plain descent (guide entry with the flag bit, one
    node record a level) equals JAX's
    ``sample_forest`` and ``ops.forest_sample`` elementwise, at random
    uniforms and at every interval's lower bound, 0 and 1 - 2^-24."""
    jf = _forest_case(name)
    f = forest_from_numpy(jax_forest_to_numpy(jf), "cpu")
    pk = forest_pack(f.cdf, f.table, f.left, f.right, f.fallback)
    xi = np.concatenate([np.random.default_rng(1).random(2048).astype(np.float32),
                         f.cdf[:-1].numpy(), np.float32([0.0, 1.0 - 2.0 ** -24])])
    for fb in (True, False):
        got = ref.ref_forest_sample_packed(*pk, f.cdf, f.cell_first, torch.from_numpy(xi),
                                           use_fallback=fb).numpy()
        want = np.asarray(jax_sample_forest(jf, jnp.asarray(xi), use_fallback=fb))
        np.testing.assert_array_equal(got, want)
        if fb:
            np.testing.assert_array_equal(
                got, np.asarray(jax_ops.forest_sample(jf, jnp.asarray(xi), use_pallas=False)))


def test_forest_pack_flags_only_tree_cells():
    """Bit 30 marks exactly the flagged cells that hold a tree, and the
    packed records carry the six arrays' bits."""
    f = build_forest(_tied(0, 299), 16, device="cpu")
    guide, nodes = forest_pack(f.cdf, f.table, f.left, f.right, f.fallback)
    flagged = (guide >= 0) & ((guide & (1 << 30)) != 0)
    assert torch.equal(flagged, f.fallback & (f.table >= 0)) and bool(flagged.any())
    assert torch.equal(torch.where(f.table >= 0, guide & ~(1 << 30), guide), f.table)
    assert torch.equal(nodes[:, 0].view(torch.float32), f.cdf[:-1])
    assert torch.equal(nodes[:, 1], f.left) and torch.equal(nodes[:, 2], f.right)


@pytest.mark.parametrize("which", ["forest_pack", "forest_sample"])
def test_forest_pack_raises_where_the_flag_bit_cannot_hold_n(which):
    """Node ids of 2^30 or more would collide with the pack's flag bit:
    ``forest_pack`` refuses such a forest, and so does ``forest_sample``
    when handed a pack for it. Without a pack, the plain path reads the six
    arrays and accepts the same forest: a lane in a tagged cell returns its
    interval, and one in a tree cell descends to its leaf (stride-0 views,
    so nothing is allocated)."""
    n, m = 1 << 30, 16
    i32 = torch.zeros(1, dtype=torch.int32)
    cdf, left = torch.zeros(1).expand(n + 1), i32.expand(n)
    table, fallback = i32.expand(m), torch.zeros(1, dtype=torch.bool).expand(m)
    if which == "forest_pack":
        with pytest.raises(ValueError, match="2\\^30"):
            forest_pack(cdf, table, left, left, fallback)
        return
    packed = (i32.expand(m), i32.expand(n, 4))
    with pytest.raises(ValueError, match="2\\^30"):
        forest_sample(cdf, table, left, left, i32.expand(m + 1), fallback,
                      torch.zeros(4), packed=packed)
    tagged = torch.full((1,), ~(n - 1), dtype=torch.int32).expand(m)
    leaf = torch.full((1,), ~(n - 1), dtype=torch.int32).expand(n)
    for tab, want in ((tagged, n - 1), (table, n - 1)):
        got = forest_sample(cdf, tab, leaf, leaf, i32.expand(m + 1), fallback,
                            torch.tensor([0.0, 0.5, 0.999]))
        assert got.tolist() == [want] * 3


def test_holder_makes_no_pack_for_a_forest_of_2_30_intervals():
    """A sampler's forest of 2^30 or more intervals gets no pack: its draws
    take the six-array body (stride-0 views, so nothing is allocated)."""
    from repro_torch.core import RadixForest
    from repro_torch.core.sample import PackedForestHolder

    n, m = 1 << 30, 16
    i32 = torch.zeros(1, dtype=torch.int32)
    f = RadixForest(torch.zeros(1).expand(n + 1), i32.expand(m), i32.expand(n),
                    i32.expand(n), i32.expand(m + 1),
                    torch.zeros(1, dtype=torch.bool).expand(m))
    holder = PackedForestHolder()
    holder.forest = f
    assert holder._packed is None and holder.forest is f


@pytest.mark.parametrize("how", ["update_weights", "from_state"])
def test_forest_sampler_repacks_every_new_forest(how):
    """A sampler's pack always belongs to its current forest: after an
    update or a restore it equals the pack of a freshly built sampler."""
    from repro_torch.core import forest_to_numpy
    from repro_torch.serve.sampler import ForestSampler

    rng = np.random.default_rng(5)
    w0, w1 = rng.random(3000) ** 4 + 1e-6, rng.random(3000) ** 8 + 1e-6
    fresh = ForestSampler(w1, m=1024, device="cpu")
    if how == "update_weights":
        s = ForestSampler(w0, m=1024, device="cpu")
        s.update_weights(w1)
    else:
        s = ForestSampler.from_state(forest_to_numpy(fresh.forest),
                                     fresh.streams.snapshot(), device="cpu")
    for a, b in zip(s._packed, fresh._packed):
        assert torch.equal(a, b)
    pk = forest_pack(s.forest.cdf, s.forest.table, s.forest.left, s.forest.right,
                     s.forest.fallback)
    for a, b in zip(s._packed, pk):
        assert torch.equal(a, b)
