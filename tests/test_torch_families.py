"""The port's LM families beyond the dense one (MoE, the Mamba hybrid,
xLSTM, the Whisper encoder-decoder, the embedding frontend) against the
JAX package, whole-model, at reduced widths in float32.

Per family (one module-scoped fixture each: JAX ``init_params`` weights,
with perturbed norm scales, carried across by ``interop.params_from_jax``,
and one ``make_batch`` batch, equal on both sides, B = 2, S = 16):
``forward`` logits and aux, ``loss_fn``, ``prefill`` logits, every cache
leaf and the encoder output, and ``decode_step`` after ``prefill``. Logits
are held to ``atol=1e-4`` (float32 summed in other orders; measured
<= 4e-6), the aux loss and the loss to ``rtol=1e-5``, cache leaves and
encoder outputs to ``rtol=1e-4, atol=1e-5`` (the Mamba scan and the
mLSTM's closed-form prefill state sum in other orders than JAX's scans).
The serving engine over reduced Jamba (Mamba, attention and MoE blocks)
is compared with JAX's token for token under the CDF-boundary rule of
ROADMAP C7 (see tests/test_torch_serve.py).
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import TokenSampler as JaxTokenSampler
import repro_torch.configs as TC
from repro_torch.data import make_batch
from repro_torch.interop import cache_to_leaves, params_from_jax
from repro_torch.models import decode_step, forward, init_params, loss_fn, prefill
from repro_torch.models.layout import leaf_map, stacked
from repro_torch.serve import Request, ServeEngine, TokenSampler
from test_torch_serve import _check_outputs, _compare_calls, _jax_scan, _port_scan, _Recorder
from _torch_threads import one_torch_thread  # noqa: F401 (pytestmark uses it)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

FAMILIES = ["jamba_1_5_large_398b", "llama4_maverick_400b_a17b", "kimi_k2_1t_a32b",
            "whisper_small", "internvl2_76b", "xlstm_1_3b"]
LOGIT_ATOL = 1e-4
CACHE_TOL = dict(rtol=1e-4, atol=1e-5)
B, S, MAX_SEQ = 2, 16, 24


def _cfgs(arch: str, **over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(JC.get_reduced(arch), **over),
            dataclasses.replace(TC.get_reduced(arch), **over))


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@functools.cache
def _carried(arch: str):
    """(JAX cfg, port cfg, JAX params, port model): JAX's init with
    non-unit norm scales, so every norm is exercised, carried across."""
    jcfg, tcfg = _cfgs(arch)
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x + jnp.asarray(rng.normal(0.0, 0.1, x.shape), x.dtype)
        if any(getattr(k, "key", None) == "scale" for k in path) else x, params)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """Both packages' forward, loss, prefill and decode on one batch."""
    jcfg, tcfg, jp, model = _carried(request.param)
    batch, jbatch = make_batch(tcfg, 3, B, S), jax_make_batch(jcfg, 3, B, S)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    key = "embeds" if tcfg.frontend == "embed" else "tokens"
    pre = {k: (v[:, :S - 1] if k in (key, "labels") else v) for k, v in batch.items()}
    nxt = batch[key][:, S - 1:S] if key == "embeds" else batch[key][:, S - 1]
    pos = np.full(B, S - 1)
    out = dict(arch=request.param, jcfg=jcfg, tcfg=tcfg, batch=batch, jbatch=jbatch,
               jax_fwd=jax_forward(jp, jcfg, jb), fwd=forward(model, tcfg, batch),
               jax_loss=jax_loss_fn(jp, jcfg, jb), loss=loss_fn(model, tcfg, batch))
    jl, jcache, jenc = jax_prefill(jp, jcfg, {k: jnp.asarray(v) for k, v in pre.items()},
                                   max_seq=MAX_SEQ)
    tl, cache, enc = prefill(model, tcfg, pre, MAX_SEQ)
    out.update(jax_pre=(jl, jax.tree_util.tree_leaves(jcache), jenc),
               pre=(tl, cache_to_leaves(cache), enc))
    jd, jcache = jax_decode_step(jp, jcfg, jcache, jnp.asarray(nxt),
                                 jnp.asarray(pos, jnp.int32), jenc)
    td, cache = decode_step(model, tcfg, cache, nxt, pos, enc)
    out.update(jax_dec=(jd, jax.tree_util.tree_leaves(jcache)), dec=(td, cache_to_leaves(cache)))
    return out


def test_make_batch_matches_jax(family):
    assert family["batch"].keys() == family["jbatch"].keys()
    for k, v in family["jbatch"].items():
        np.testing.assert_array_equal(family["batch"][k], v)
    assert ("embeds" in family["batch"]) == (family["tcfg"].frontend == "embed")
    assert ("frames" in family["batch"]) == bool(family["tcfg"].encoder_layers)


def test_forward_matches_jax(family):
    (jl, jaux), (tl, taux) = family["jax_fwd"], family["fwd"]
    assert tl.shape == (B, S, family["tcfg"].vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5, atol=1e-7)
    assert (float(jaux) > 0) == ("moe" in family["tcfg"].mlp_pattern)


def test_loss_fn_matches_jax(family):
    (jl, jm), (tl, tm) = family["jax_loss"], family["loss"]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7)


def test_prefill_matches_jax(family):
    """Last-position logits, every cache leaf in ``tree_leaves`` order
    (attention k/v/len, Mamba conv/h, mLSTM C/n, sLSTM c/h/m/n), and the
    encoder output."""
    (jl, jleaves, jenc), (tl, leaves, enc) = family["jax_pre"], family["pre"]
    np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGIT_ATOL, rtol=0)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(_np(a), _np(b), **CACHE_TOL)
    assert (enc is None) == (jenc is None)
    if enc is not None:
        np.testing.assert_allclose(_np(enc), _np(jenc), **CACHE_TOL)


def test_decode_after_prefill_matches_jax(family):
    (jd, jleaves), (td, leaves) = family["jax_dec"], family["dec"]
    np.testing.assert_allclose(_np(td), _np(jd), atol=LOGIT_ATOL, rtol=0)
    for a, b in zip(leaves, jleaves, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), **CACHE_TOL)


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_init_params_builds_every_reduced_config(arch):
    """Each of the ten reduced configs builds on the CPU, with exactly the
    parameters of the layout map (so every leaf carries to and from JAX)."""
    cfg = TC.get_reduced(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = set()
    for path, name, _kind, _shape in leaf_map(cfg):
        n = stacked(cfg, path)
        want |= {name} if n is None else {name.format(p=p) for p in range(n)}
    assert {n for n, _ in model.named_parameters()} == want
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_mlstm_chunked_normalizer_follows_jax_c11():
    """ROADMAP C11: the reference's chunked mLSTM normalizes by
    ``sum_t D_jt (q.k_t)^2`` (its ``n_intra`` is built from the weights that
    already hold ``q.k_t``), its step form by ``sum_t D_jt (q.k_t)``; they
    agree only while ``|q.n| <= 1`` clamps both. With q and k scaled up so it
    does not, JAX's own decode after prefill leaves its prefill of the
    longer prompt, and the port follows JAX on both paths."""
    jcfg, tcfg = _cfgs("xlstm_1_3b")  # the family fixture's shapes: its compiles
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    for w in ("wq", "wk"):
        jp["layers"]["b0"][w] = jp["layers"]["b0"][w] * 6.0
    model = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (B, S))
    jt = jnp.asarray(toks, jnp.int32)
    want = _np(jax_prefill(jp, jcfg, {"tokens": jt}, max_seq=MAX_SEQ)[0])
    _, jcache, _ = jax_prefill(jp, jcfg, {"tokens": jt[:, :S - 1]}, max_seq=MAX_SEQ)
    got = _np(jax_decode_step(jp, jcfg, jcache, jt[:, S - 1],
                              jnp.full((B,), S - 1, jnp.int32))[0])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) > 1e-3  # the fault shows
    tw = prefill(model, tcfg, {"tokens": torch.tensor(toks)}, MAX_SEQ)[0]
    _, cache, _ = prefill(model, tcfg, {"tokens": torch.tensor(toks[:, :S - 1])}, MAX_SEQ)
    tg = decode_step(model, tcfg, cache, torch.tensor(toks[:, S - 1]), torch.full((B,), S - 1))[0]
    np.testing.assert_allclose(_np(tw), want, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(_np(tg), got, atol=LOGIT_ATOL, rtol=0)


def test_hybrid_engine_streams_match_jax_engine():
    """Reduced Jamba (Mamba, attention and MoE in one period) served by both
    engines: the same uniforms, and the same tokens call by call except
    where both sides' CDF rows put a boundary within SCAN_ATOL of the
    uniform (ROADMAP C7); every cache kind spliced at admission."""
    jcfg, tcfg, jp, model = _carried("jamba_1_5_large_398b")
    rng = np.random.default_rng(31)
    specs = [dict(rid=i, prompt=rng.integers(0, jcfg.vocab, size=4),
                  max_new=int(rng.integers(3, 7))) for i in range(5)]
    # the family fixture's decode shape (B, MAX_SEQ): JAX reuses its compile
    jeng = JaxServeEngine(jp, jcfg, n_slots=B, max_seq=MAX_SEQ,
                          sampler=JaxTokenSampler(n_slots=B, use_pallas=False, seed=2))
    teng = ServeEngine(model, tcfg, n_slots=B, max_seq=MAX_SEQ,
                       sampler=TokenSampler(n_slots=B, seed=2, device="cpu"), device="cpu")
    jrec, trec = _Recorder(jeng, _jax_scan), _Recorder(teng, _port_scan)
    jreqs = {s["rid"]: JaxRequest(**s) for s in specs}
    treqs = {s["rid"]: Request(**s) for s in specs}
    for r in jreqs.values():
        jeng.submit(r)
    for r in treqs.values():
        teng.submit(r)
    jeng.run(max_steps=60)
    teng.run(max_steps=60)
    _check_outputs(jreqs, treqs, _compare_calls(jrec, trec))
    assert teng.steps == jeng.steps
    assert set(teng.cache) == {f"b{i}" for i in range(8)}


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-76b", "kimi-k2-1t-a32b"])
def test_launcher_serves_every_frontend(arch, monkeypatch, capsys):
    """``launch.serve`` takes the encoder-decoder and the embed frontend
    (model-level prefill and decode) beside the engine's token families."""
    from repro_torch.launch import serve

    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--device", "cpu",
                                     "--requests", "2", "--max-new", "3"])
    serve.main()
    out = capsys.readouterr().out
    assert "served 2/2 requests, 6 tokens" in out
    assert ("model-level" in out) == (arch != "kimi-k2-1t-a32b")
