"""The port's MoE, Mamba, xLSTM and cross-attention modules against the
JAX package's, module by module, at reduced widths in float32.

JAX ``init_params`` weights are carried across with
``interop.params_from_jax``; both sides run the same numpy inputs.
Tolerances:
- MoE: expert ids, ``keep`` and capacity positions exactly (the same
  token-major cumsum over the same ids; ties go to the lower expert index
  on both sides); ``y`` within ``2e-6 * max|y|`` (the port gathers the
  kept pairs and sums over the k choices in float32, JAX contracts one-hot
  tensors: other orders; |y| reaches ~100 here, the experts' init scale
  being ``1/sqrt(E)``), ``aux`` within ``rtol=1e-6``.
- Sampled routing: ids exactly, except where a uniform lies within
  ``CDF_ULPS`` float32 ulps of one of the row's CDF boundaries (the two
  cumsums may differ by an ulp there; ROADMAP C2).
- Mamba: the port's log-depth scan and JAX's associative scan sum in other
  orders: outputs within ``atol=1e-5``, states ``rtol=1e-4, atol=1e-6``.
- mLSTM, sLSTM, cross-attention: the same einsums in float32, outputs
  within ``atol=1e-5``; the mLSTM's prefill state is the recurrence's
  closed form (one product) beside JAX's step loop: ``rtol=1e-4,
  atol=1e-6``.
"""
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models import xlstm as JX
from repro.models.model import _mamba_prefill as jax_mamba_prefill
from repro.models.model import _mlstm_prefill as jax_mlstm_prefill
from repro.models.model import _slstm_prefill as jax_slstm_prefill
import repro_torch.configs as TC
from repro_torch.interop import params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models import xlstm as TX
from repro_torch.models.model import _trunc_normal_

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

CDF_ULPS = 4


def _carry(arch: str, **over):
    """(JAX cfg, port cfg, JAX params, port model), float32, one period."""
    over = dict(dtype="float32", **over)
    jcfg = dataclasses.replace(JC.get_reduced(arch), **over)
    tcfg = dataclasses.replace(TC.get_reduced(arch), **over)
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")


def _slice(params, *path):
    """One period's (or layer's) leaves of a stacked JAX subtree."""
    node = params
    for k in path:
        node = node[k]
    return jax.tree.map(lambda a: a[0], node)


def _jit(fn):
    """``fn(params, cfg, *arrays)`` under ``jax.jit`` (one compile, not one
    per eager op), ``cfg`` static."""
    return jax.jit(fn, static_argnums=(1,))


def _np(x) -> np.ndarray:
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32)


def _x(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


@pytest.fixture(scope="module")
def kimi():
    return _carry("kimi_k2_1t_a32b", n_layers=1)


@pytest.fixture(scope="module")
def jamba():
    """Jamba's Mamba block alone: one layer of the reduced widths."""
    return _carry("jamba_1_5_large_398b", n_layers=1, block_pattern=("mamba",),
                  mlp_pattern=("none",))


@pytest.fixture(scope="module")
def xlstm():
    return _carry("xlstm_1_3b", n_layers=2)


# ------------------------------------------------------------------- routing


def test_route_top_k_breaks_ties_as_jax():
    """Gates with many exact ties (values from a coarse grid): the same ids,
    ties to the lower expert index, and the same renormalized weights."""
    rng = np.random.default_rng(0)
    g = rng.integers(0, 4, (64, 16)).astype(np.float32)
    g = g / g.sum(-1, keepdims=True)
    for k in (1, 2, 5):
        jid, jw = JM._route(jnp.asarray(g), k, None)
        tid, tw = TM._route(torch.tensor(g), k)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=0)


def test_route_sampled_matches_jax_off_cdf_boundaries():
    rng = np.random.default_rng(1)
    gates = np.asarray(jax.nn.softmax(jnp.asarray(rng.normal(0, 2, (256, 12)),
                                                  jnp.float32), axis=-1))
    xi = rng.random((256, 3)).astype(np.float32)
    jid, jw = JM._route(jnp.asarray(gates), 3, jnp.asarray(xi))
    tid, tw = TM._route(torch.tensor(gates), 3, torch.tensor(xi))
    jid, tid = np.asarray(jid), tid.numpy()
    cdf = np.cumsum(gates.astype(np.float64), -1)
    cdf /= cdf[:, -1:]
    for r, j in zip(*np.nonzero(jid != tid)):
        near = np.abs(cdf[r] - xi[r, j]).min()
        assert near <= CDF_ULPS * np.spacing(np.float32(1.0)), (r, j, near)
    same = jid == tid
    assert same.mean() > 0.99
    np.testing.assert_allclose(tw.numpy()[same.all(-1)], np.asarray(jw)[same.all(-1)],
                               rtol=1e-6)


@pytest.mark.parametrize("T", [1, 12, 2048, 2049, 2053, 4096, 6144, 10007])
def test_pick_groups_matches_jax(T):
    assert TM._pick_groups(T) == JM._pick_groups(T)
    G = TM._pick_groups(T)
    assert T % G == 0 and T // G <= TM.GROUP_TOKENS


# ----------------------------------------------------------------------- moe


def _jax_plan(gates, k, E, cap):
    """JAX ``moe``'s ids, keep and capacity positions, its own lines."""
    ids, _ = JM._route(gates, k, None)
    G, g = gates.shape[:2]
    onehot = jax.nn.one_hot(ids, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(G, g * k, E), axis=1).reshape(G, g, k, E) - onehot
    keep = (pos < cap) * onehot
    return np.asarray(ids), np.asarray(keep), np.asarray(jnp.sum(pos * keep, -1))


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "llama4_maverick_400b_a17b"])
def test_moe_matches_jax_with_drops(arch):
    """Grouped capacity dispatch at the default capacity_factor 1.25, with
    drops: the same (token, choice) pairs kept at the same positions, and
    y (shared experts included) and the aux loss as JAX's."""
    jcfg, tcfg, jp, model = _carry(arch, n_layers=1)
    p = _slice(jp, "layers", "m0")
    m = model.layers[0].m0
    # a direction all tokens share crowds them onto the same experts: drops
    x = _x((2, 24, jcfg.d_model), 2, 0.5) + _x((1, 1, jcfg.d_model), 3)
    jy, jaux = _jit(JM.moe)(p, jcfg, jnp.asarray(x))
    ty, taux = TM.moe(m, tcfg, torch.tensor(x))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=2e-6 * np.abs(jy).max(), rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)

    E, k = tcfg.n_experts, tcfg.top_k
    G = TM._pick_groups(48)
    g = 48 // G
    cap = TM.capacity(g, k, E, tcfg.capacity_factor)
    assert cap == max(int(np.ceil(g * k / E * jcfg.capacity_factor)), 1)
    xt = x.reshape(G, g, -1)
    gates = jax.nn.softmax(jnp.einsum("gtd,de->gte", jnp.asarray(xt), p["router"]), -1)
    jid, jkeep, jpos = _jax_plan(gates, k, E, cap)
    tgates = torch.softmax(torch.nn.functional.linear(torch.tensor(xt), m.router), -1)
    tid, _ = TM._route(tgates, k)
    tkeep, tpos = TM.dispatch_plan(tid, E, cap)
    np.testing.assert_array_equal(tid.numpy(), jid)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    assert (jkeep.sum(-1) == 0).any(), "the case must drop some (token, choice) pairs"


def test_moe_sampled_mode_matches_jax_given_the_same_ids(kimi):
    """The sampled routing mode end to end: the same uniforms give the same
    ids off the CDF boundaries (checked by the routing test), and then the
    same y and aux."""
    jcfg, tcfg, jp, model = kimi
    p, m = _slice(jp, "layers", "m0"), model.layers[0].m0
    x = _x((1, 16, jcfg.d_model), 3)
    xi = np.random.default_rng(4).random((1, 16, tcfg.top_k)).astype(np.float32)
    jy, jaux = _jit(JM.moe)(p, jcfg, jnp.asarray(x), jnp.asarray(xi))
    ty, taux = TM.moe(m, tcfg, torch.tensor(x), torch.tensor(xi))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=2e-6 * np.abs(jy).max(), rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


# --------------------------------------------------------------------- mamba


def test_mamba_matches_jax(jamba):
    jcfg, tcfg, jp, model = jamba
    p, b = _slice(jp, "layers", "b0"), model.layers[0].b0
    x = _x((2, 13, jcfg.d_model), 5)
    jy, jc = _jit(jax_mamba_prefill)(p, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(TS.mamba(b, tcfg, torch.tensor(x))), np.asarray(jy),
                               atol=1e-5, rtol=0)
    ty, tc = TS.mamba_prefill(b, tcfg, torch.tensor(x))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=0)
    for key in ("conv", "h"):
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]), rtol=1e-4, atol=1e-6)
    x1 = _x((2, 1, jcfg.d_model), 6)
    jy, jn = _jit(JS.mamba_decode)(p, jcfg, jnp.asarray(x1), jc)
    ty, tn = TS.mamba_decode(b, tcfg, torch.tensor(x1), tc)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=0)
    for key in ("conv", "h"):
        np.testing.assert_allclose(_np(tn[key]), np.asarray(jn[key]), rtol=1e-4, atol=1e-6)


def test_ssm_scan_is_the_recurrence():
    rng = np.random.default_rng(7)
    a = torch.tensor(rng.random((2, 37, 3, 4)), dtype=torch.float64)
    bx = torch.tensor(rng.normal(size=(2, 37, 3, 4)))
    h, want = torch.zeros_like(bx[:, 0]), []
    for t in range(37):
        h = a[:, t] * h + bx[:, t]
        want.append(h)
    torch.testing.assert_close(TS.ssm_scan(a, bx), torch.stack(want, 1), rtol=1e-12, atol=0)


# --------------------------------------------------------------------- xLSTM


@pytest.mark.parametrize("S", [32, 20])
def test_mlstm_matches_jax(xlstm, S):
    """The chunkwise mLSTM at S = two chunks of 16 and 20 (not a multiple of
    the chunk: cut to 10), its prefill state, and one decode step after it."""
    jcfg, tcfg, jp, model = xlstm
    p, b = _slice(jp, "layers", "b0"), model.layers[0].b0
    x = _x((2, S, jcfg.d_model), S)
    jy, jc = _jit(jax_mlstm_prefill)(p, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(TX.mlstm(b, tcfg, torch.tensor(x))), np.asarray(jy),
                               atol=1e-5, rtol=0)
    ty, tc = TX.mlstm_prefill(b, tcfg, torch.tensor(x))
    for key in ("C", "n"):
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]), rtol=1e-4, atol=1e-6)
    x1 = _x((2, 1, jcfg.d_model), S + 1)
    jy, jn = _jit(JX.mlstm_decode)(p, jcfg, jnp.asarray(x1), jc)
    ty, tn = TX.mlstm_decode(b, tcfg, torch.tensor(x1), tc)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=0)


def test_mlstm_chunk_scan_matches_jax():
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 24, 3, 8)).astype(np.float32) for _ in range(3))
    lf = np.log(rng.uniform(0.5, 1.0, (2, 24, 3))).astype(np.float32)
    li = rng.normal(size=(2, 24, 3)).astype(np.float32)
    scan = jax.jit(JX._mlstm_chunk_scan, static_argnums=(5,))
    want = scan(*map(jnp.asarray, (q, k, v, lf, li)), 6)
    got = TX._mlstm_chunk_scan(*map(torch.tensor, (q, k, v, lf, li)), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="chunk"):
        TX._mlstm_chunk_scan(*map(torch.tensor, (q, k, v, lf, li)), 7)


def test_slstm_matches_jax(xlstm):
    jcfg, tcfg, jp, model = xlstm
    p, b = _slice(jp, "layers", "b1"), model.layers[0].b1
    x = _x((2, 11, jcfg.d_model), 9)
    jy, jc = _jit(jax_slstm_prefill)(p, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(TX.slstm(b, tcfg, torch.tensor(x))), np.asarray(jy),
                               atol=1e-5, rtol=0)
    ty, tc = TX.slstm_prefill(b, tcfg, torch.tensor(x))
    for key in "hcnm":
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]), rtol=1e-5, atol=1e-6)
    init = TX.slstm_init_cache(tcfg, 2, torch.float32)
    assert bool((init["m"] == torch.tensor(-1e30)).all()) and init["h"].dtype == torch.float32
    x1 = _x((2, 1, jcfg.d_model), 10)
    jy, jn = _jit(JX.slstm_decode)(p, jcfg, jnp.asarray(x1), jc)
    ty, tn = TX.slstm_decode(b, tcfg, torch.tensor(x1), tc)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=0)
    for key in "hcnm":
        np.testing.assert_allclose(_np(tn[key]), np.asarray(jn[key]), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------- cross-attention


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_jax(qk_norm):
    """Whisper's decoder cross-attention (and a qk-normed variant, whose
    norms apply to the cross q and k): ``encoder_kv`` and
    ``cross_attention`` as JAX's."""
    jcfg, tcfg, jp, model = _carry("whisper_small", n_layers=1, qk_norm=qk_norm)
    if qk_norm:  # non-unit norm scales, so the norms are exercised
        rng = np.random.default_rng(11)
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
            if any(getattr(k, "key", None) == "scale" for k in path) else a, jp)
        model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    p, xa = _slice(jp, "layers", "x0"), model.layers[0].x0
    enc = _x((2, 9, jcfg.d_model), 12)
    x = _x((2, 5, jcfg.d_model), 13)
    jk, jv = _jit(JL.encoder_kv)(p, jcfg, jnp.asarray(enc))
    tk, tv = TL.encoder_kv(xa, tcfg, torch.tensor(enc))
    np.testing.assert_allclose(_np(tk), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=1e-5, rtol=0)
    want = _jit(JL.cross_attention)(p, jcfg, jnp.asarray(x), (jk, jv))
    got = TL.cross_attention(xa, tcfg, torch.tensor(x), (tk, tv))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------- init


def test_trunc_normal_slices_an_expert_stack():
    """An (E, D, F) expert stack drawn in slices of 3 experts: the same
    from the same seed, within the +-2 sd truncation, at its 1/sqrt(fan)
    scale (a normal truncated at +-2 sd has sd 0.8796), and the slices do
    not repeat one another."""
    E, D, Fe = 8, 64, 96
    scale = 1.0 / math.sqrt(E)
    a, b = (torch.empty(E, D, Fe, dtype=torch.bfloat16) for _ in range(2))
    for t in (a, b):
        _trunc_normal_(t, scale, torch.Generator().manual_seed(0), slice_elems=3 * D * Fe)
    assert torch.equal(a, b)
    w = a.float()
    assert float(w.abs().max()) <= 2 * scale * (1 + 2 ** -8)
    assert abs(float(w.std()) / scale - 0.8796) < 0.02
    assert not torch.equal(w[0], w[3]) and not torch.equal(w[:3], w[3:6])
    whole = torch.empty(E, D, Fe)
    _trunc_normal_(whole, scale, torch.Generator().manual_seed(0))
    assert float(whole.abs().max()) <= 2 * scale
