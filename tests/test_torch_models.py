"""The port's LM (``prefill``, ``decode_step``, the config registry)
against the JAX package, at reduced widths in float32: the dense archs,
and xLSTM for a recurrent decode cache (mLSTM ``C``/``n``, sLSTM
``c``/``h``/``m``/``n``) carried across packages.

JAX ``init_params`` weights are carried across with
``interop.params_from_jax``; both sides run the same numpy tokens. Logits
are held to ``atol=1e-4`` (float32 with matmuls summed in other orders:
the logits here are O(1)), cache entries to ``atol=1e-5``, and decode
after prefill to prefill of the longer prompt at ``atol=1e-4``.

One carried case runs in bfloat16, the dtype the full-width serve path
uses (bf16 weights, biases and KV cache, f32 norms and softmax). There the
two sides round the same bf16 values after sums taken in other orders, so
logits (|logit| < 1 here) are held to ``atol=2e-2`` and cache entries to
two bf16 ulps (``rtol=atol=2^-6``); on this CPU, over 3 seeds of both
reduced archs, the largest logit gap was 5.9e-3 and the largest cache gap
one bf16 ulp.

A JAX decode cache crosses into the port as a JAX engine snapshot stores
it: its ``tree_leaves`` through the JAX package's ``save_state`` and the
port's ``load_state``, then ``cache_from_jax``; the port then decodes the
same next tokens as JAX.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.ckpt import save_state as jax_save_state
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
import repro_torch.configs as TC
from repro_torch.ckpt import load_state
from repro_torch.interop import cache_from_jax, cache_to_leaves, params_from_jax
from repro_torch.models import decode_step, forward, init_params, prefill

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
ARCHS = ["qwen1_5_0_5b", "qwen3_4b"]
# (logit atol, cache rtol, cache atol) by dtype; see the module docstring
TOL = {"float32": (LOGIT_ATOL, 0.0, CACHE_ATOL), "bfloat16": (2e-2, 2**-6, 2**-6)}


def _cfgs(arch: str, dtype: str = "float32"):
    over = dict(dtype=dtype, n_layers=2)
    return (dataclasses.replace(JC.get_reduced(arch), **over),
            dataclasses.replace(TC.get_reduced(arch), **over))


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.fixture(scope="module", params=ARCHS + ["qwen1_5_0_5b-bfloat16", "xlstm_1_3b"])
def carried(request):
    """(JAX cfg, port cfg, JAX params, port model): JAX weights with
    non-zero biases and norm scales, so every parameter is exercised."""
    jcfg, tcfg = _cfgs(*request.param.split("-"))
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + jnp.asarray(rng.normal(0.0, 0.1, x.shape), x.dtype)
        if any(getattr(k, "key", None) in ("bq", "bk", "bv", "scale") for k in path)
        else x, params)
    return jcfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")


def test_registry_matches_jax():
    for arch in TC.ARCHS:
        assert dataclasses.asdict(TC.get(arch)) == dataclasses.asdict(JC.get(arch))
        assert dataclasses.asdict(TC.get_reduced(arch)) == dataclasses.asdict(
            JC.get_reduced(arch))
        assert TC.canonical(JC.get(arch).name) == arch
    assert TC.ARCHS == JC.ARCHS
    with pytest.raises(KeyError, match="unknown architecture"):
        TC.get("no_such_arch")


def test_prefill_and_decode_match_jax(carried):
    jcfg, tcfg, jp, model = carried
    logit_atol, cache_rtol, cache_atol = TOL[tcfg.dtype]
    rng = np.random.default_rng(2)
    B, S, max_seq = 3, 6, 16
    toks = rng.integers(0, jcfg.vocab, (B, S))
    jl, jcache, _ = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                                max_seq=max_seq)
    tl, cache, _ = prefill(model, tcfg, {"tokens": torch.tensor(toks)}, max_seq)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=logit_atol, rtol=0)
    jleaves = jax.tree_util.tree_leaves(jcache)
    for a, b in zip(cache_to_leaves(cache), jleaves, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), atol=cache_atol, rtol=cache_rtol)
    # decode with per-row positions: rows advance at different rates
    pos = np.full(B, S)
    tok = rng.integers(0, jcfg.vocab, B)
    for step in range(4):
        jl, jcache = jax_decode_step(jp, jcfg, jcache, jnp.asarray(tok, jnp.int32),
                                     jnp.asarray(pos, jnp.int32))
        tl, cache = decode_step(model, tcfg, cache, torch.tensor(tok), torch.tensor(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=logit_atol, rtol=0)
        tok = _np(jl).argmax(-1)
        pos = pos + np.asarray([1, step % 2, 0])
    for a, b in zip(cache_to_leaves(cache), jax.tree_util.tree_leaves(jcache), strict=True):
        np.testing.assert_allclose(_np(a), _np(b), atol=cache_atol, rtol=cache_rtol)


def test_cache_from_jax_leaves_decodes_like_jax(carried, tmp_path):
    jcfg, tcfg, jp, model = carried
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 5))
    _, jcache, _ = jax_prefill(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)}, max_seq=16)
    jax_save_state(tmp_path, {"cache": [np.asarray(x)
                                        for x in jax.tree_util.tree_leaves(jcache)]}, 0)
    state, _ = load_state(tmp_path)
    cache = cache_from_jax(state["cache"], tcfg, 2, 16, "cpu")
    tok, pos = np.asarray([1, 2]), np.asarray([5, 5])
    jl, _ = jax_decode_step(jp, jcfg, jcache, jnp.asarray(tok, jnp.int32),
                            jnp.asarray(pos, jnp.int32))
    tl, _ = decode_step(model, tcfg, cache, torch.tensor(tok), torch.tensor(pos))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL[tcfg.dtype][0], rtol=0)
    np.testing.assert_array_equal(_np(tl).argmax(-1), _np(jl).argmax(-1))
    with pytest.raises(ValueError):
        cache_from_jax([np.asarray(x) for x in jax.tree_util.tree_leaves(jcache)],
                       tcfg, 3, 16, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """prefill(S) + decode_step(token S) == prefill(S + 1) at its last
    position, on the port's own seeded init."""
    _, cfg = _cfgs(arch)
    model = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(6))
    want, _, _ = prefill(model, cfg, {"tokens": toks}, 16)
    _, cache, _ = prefill(model, cfg, {"tokens": toks[:, :8]}, 16)
    got, cache = decode_step(model, cfg, cache, toks[:, 8], torch.tensor([8, 8]))
    torch.testing.assert_close(got, want, atol=LOGIT_ATOL, rtol=0)
    assert cache["b0"]["len"].tolist() == [9] * cfg.n_periods


def test_init_params_is_seeded_and_scaled():
    _, cfg = _cfgs("qwen1_5_0_5b")
    a = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    attn = a.layers[0].b0
    assert float(a.embed.abs().max()) <= 0.04  # 2 sd at scale 0.02
    assert float(attn.wq.abs().max()) <= 2.0 / cfg.d_model ** 0.5
    assert torch.count_nonzero(attn.bq) == 0
    assert not hasattr(a, "lm_head")  # tied embeddings


def test_unsupported_configs_raise():
    _, cfg = _cfgs("qwen3_4b")
    flash = dataclasses.replace(cfg, attn_impl="flash")  # builds; no backward (B10)
    model = init_params(flash, device="cpu").requires_grad_()
    with pytest.raises(NotImplementedError, match="B10"):
        forward(model, flash, {"tokens": torch.zeros(1, 4).long()})
    with pytest.raises(ValueError, match="unknown mlp kind"):
        init_params(dataclasses.replace(cfg, mlp_pattern=("sparse",)), device="cpu")
    with pytest.raises(ValueError, match="unknown block kind"):
        init_params(dataclasses.replace(cfg, block_pattern=("attn", "rwkv"), n_layers=2),
                    device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        prefill(init_params(cfg, device="cpu"), cfg, {"tokens": torch.zeros(1, 9).long()}, 8)
