"""Kernel B10's plain version and the port's eval forward against the JAX
package, on the CPU.

* ``ref_flash_attention`` against JAX's ``ref_flash_attention`` over the
  sweep of ``tests/test_kernels.py`` (4 shapes x causal x {f32, bf16}) at
  the JAX suite's tolerances, 2e-5 in float32 and 2e-2 in bfloat16 (one
  bf16 ulp of outputs up to ~4, where both sides round float32 sums taken
  in other orders); and against the Pallas kernel in interpret mode on two
  cases, one ragged (S = 100 over 64-row blocks), at 2e-5.
* ``forward``/``loss_fn`` at reduced Qwen1.5-0.5B and Qwen3-4B (GQA and
  qk-norm), 2 layers, 64 tokens, float32, one model run with
  ``attn_impl="einsum"`` and ``"flash"`` (JAX's flash in interpret mode,
  as ``tests/test_arch_smoke.py`` runs it): logits within ``atol=1e-5``
  (O(1) logits; on this CPU the largest gap was 5.2e-7) and the loss within
  ``1e-5`` (gap 4.8e-7). One bfloat16 case: both sides round the same bf16
  values after sums in other orders, so logits are held to ``2e-2`` as in
  ``tests/test_torch_models.py`` and the loss to ``2e-3`` (over 3 seeds of
  both reduced archs on this CPU: logit gaps up to 7.8e-3, one to two bf16
  ulps, loss gaps up to 2.7e-4).
* An emulation of the bf16 CUDA kernel's rounding points (below) against
  JAX's ``ref_flash_attention`` and its Pallas kernel in interpret mode,
  at the bf16 tolerance; and which inputs the wrapper copies before TMA.
* An emulation of the float32 CUDA kernel's arithmetic, three TF32
  products for each product (operands rounded to TF32 as ``cvt.rna``
  rounds), against JAX's ``ref_flash_attention`` at the float32 tolerance
  over the float32 shapes of this suite and of the card's tests, causal
  and not; TF32 alone misses it.
"""
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
import repro_torch.configs as TC
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention, kernel_inputs
from repro_torch.models import forward, init_params, loss_fn

# Start JAX's backend at collection (see tests/test_torch_cdf_forest.py).
jax.devices()

TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the JAX suite's
FWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-3)}  # (logits, loss)


def _qkv(shape_q, shape_kv, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in (shape_q, shape_kv, shape_kv)]


def _torch(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 32), (2, 96, 4, 2, 64), (1, 256, 8, 2, 32), (2, 64, 2, 1, 128),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_flash_attention_matches_jax_ref(B, S, H, KV, hd, causal, dtype):
    q, k, v = _qkv((B, S, H, hd), (B, S, KV, hd), dtype, S + H)
    want = jref.ref_flash_attention(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
                                    causal=causal)
    got = ref.ref_flash_attention(*(_torch(a, dtype) for a in (q, k, v)), causal=causal)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (1, 128, 4, 2, 32, False),   # two query and two key tiles, GQA
    (1, 100, 2, 2, 32, True),    # ragged: padded keys masked in the kernel
])
def test_ref_flash_attention_matches_pallas_interpret(B, S, H, KV, hd, causal):
    q, k, v = _qkv((B, S, H, hd), (B, S, KV, hd), "float32", 0)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                     block_q=64, block_k=64, interpret=True)
    got = ref.ref_flash_attention(*(torch.tensor(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    q, k, v = (torch.tensor(a) for a in _qkv((2, 40, 4, 16), (2, 40, 2, 16), "float32", 1))
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v, causal=False),
                       ref.ref_flash_attention(q, k, v, causal=False))
    assert flash_attention.launches == before  # no kernel launch on the CPU
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1].expand(2, 40, 3, 16), v)       # H % KV
    with pytest.raises(ValueError):
        flash_attention(q, k.to(torch.bfloat16), v)                   # mixed dtypes
    with pytest.raises(NotImplementedError, match="B10"):
        flash_attention(q.requires_grad_(), k, v)


KERNEL_KEY_TILE = 128    # FA_TK of the bf16 body in csrc/flash_attention.cu
LOG2E = 1.4426950408889634


def _emulate_bf16_kernel(q, k, v, causal, tile=KERNEL_KEY_TILE):
    """The bf16 kernel's arithmetic in plain torch, at its rounding points:
    products of bf16 q and k summed in float32; the float32 scale times
    log2(e) applied to the scores after the product; masked scores -inf;
    per key tile of the kernel's width, m = max(m, rowmax * c),
    p = exp2(s * c - m), l = l * alpha + rowsum p (float32), and
    acc = acc * alpha + bf16(p) . v (the unnormalized weights rounded to
    bf16 before the product); out = acc / max(l, 1e-30) cast to bf16."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    qf, kf, vf = (t.float().repeat_interleave(H // t.shape[2], dim=2).transpose(1, 2)
                  for t in (q, k, v))                                # (B, H, S, hd)
    c = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    m = torch.full((B, H, Sq, 1), -math.inf)
    l, acc = torch.zeros((B, H, Sq, 1)), torch.zeros((B, H, Sq, hd))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, tile):
        kpos = torch.arange(k0, min(k0 + tile, Sk))[None, :]
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)
        if causal:
            s = torch.where(kpos <= qpos, s, -math.inf)
        n = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        u = torch.where(n == -math.inf, 0.0, n)
        alpha = torch.exp2(m - u)
        p = torch.exp2(s * c - u)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + tile]
        m = n
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 1024, 2, 2, 64),     # eight key tiles, the eval path's head dim
    (1, 300, 4, 2, 128),     # ragged: 2 x 128 + 44 keys, GQA, hd 128
])
def test_bf16_kernel_rounding_matches_jax(B, S, H, KV, hd):
    """The rounding of the tensor-core design (scale after the product,
    exp2, bf16 weights before P.V, 128-key tiles) stays within the JAX
    suite's bf16 tolerance of both JAX oracles, causal."""
    q, k, v = _qkv((B, S, H, hd), (B, S, KV, hd), "bfloat16", S + hd)
    got = _emulate_bf16_kernel(*(_torch(a, "bfloat16") for a in (q, k, v)), causal=True)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    for want in (jref.ref_flash_attention(jq, jk, jv, causal=True),
                 jax_flash(jq, jk, jv, causal=True, interpret=True)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["bfloat16"],
                                   atol=TOL["bfloat16"])


F32_KEY_TILE = {32: 64, 64: 64, 128: 32}   # FaF32<HD>::BK of the float32 body


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest, ties away
    from zero, on the bit pattern (add half of the 13 dropped bits to the
    magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32x3(a, b):
    """a @ b as the float32 kernel forms it: hi = TF32(x), lo = TF32(x - hi)
    for each operand, and lo.hi' + hi.lo' + hi.hi' summed in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    """a @ b with TF32 operands alone, for the record of what it misses."""
    return _tf32(a) @ _tf32(b)


def _emulate_f32_kernel(q, k, v, causal, mm=_mm_tf32x3):
    """The float32 kernel's arithmetic in plain torch: q times the float32
    scale, S = q k^T and P V each through ``mm``, masked scores -inf, and per
    key tile of the kernel's width the online softmax in log2 units
    (m = max(m, rowmax * log2 e), p = exp2(s log2 e - m)); out = acc /
    max(l, 1e-30)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qf, kf, vf = (t.repeat_interleave(H // t.shape[2], dim=2).transpose(1, 2)
                  for t in (q * scale, k, v))                       # (B, H, S, hd)
    m = torch.full((B, H, Sq, 1), -math.inf)
    l, acc = torch.zeros((B, H, Sq, 1)), torch.zeros((B, H, Sq, hd))
    qpos = torch.arange(Sq)[:, None]
    tile = F32_KEY_TILE[hd]
    for k0 in range(0, Sk, tile):
        kpos = torch.arange(k0, min(k0 + tile, Sk))[None, :]
        s = mm(qf, kf[:, :, k0:k0 + tile].transpose(-1, -2))
        if causal:
            s = torch.where(kpos <= qpos, s, -math.inf)
        n = torch.maximum(m, s.amax(-1, keepdim=True) * LOG2E)
        u = torch.where(n == -math.inf, 0.0, n)
        alpha = torch.exp2(m - u)
        p = torch.exp2(s * LOG2E - u)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vf[:, :, k0:k0 + tile])
        m = n
    return (acc / l.clamp_min(1e-30)).transpose(1, 2)


def test_tf32_rounds_as_cvt_rna():
    """Nearest, ties away from zero, on the 13 dropped bits."""
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 3 * ulp / 2, 3.0e38, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0e38, 0.0])
    got = _tf32(x)
    assert torch.equal(got[:4], want[:4]) and got[5] == 0.0
    assert abs(float(got[4]) - 3.0e38) <= 3.0e38 * 2.0 ** -11
    h = _tf32(torch.randn(1000))
    assert torch.equal(h, _tf32(h))       # TF32 values stay as they are
    assert not (h.view(torch.int32) & 0x1FFF).any()


# The float32 shapes of the suite above and of test_flash_attention_matches_plain
# on the card: (B, Sq, Sk, H, KV, hd).
F32_SHAPES = [
    (1, 128, 128, 4, 4, 32), (2, 96, 96, 4, 2, 64), (1, 256, 256, 8, 2, 32),
    (2, 64, 64, 2, 1, 128), (1, 100, 100, 2, 2, 32), (1, 1000, 1000, 4, 2, 64),
    (2, 37, 200, 4, 4, 64), (1, 5, 20, 2, 1, 32), (1, 1024, 1024, 32, 8, 128)]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", F32_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_f32_kernel_three_tf32_products_match_jax(B, Sq, Sk, H, KV, hd, causal):
    """The float32 tensor-core design (q scaled first, three TF32 products
    for S and for P V, exp2 in log2 units, the kernel's key tiles) stays
    within the JAX suite's float32 tolerance of 2e-5 of JAX's
    ``ref_flash_attention``. TF32 alone does not: over these 18 cases the
    largest error of the same emulation with TF32 operands alone was 1.30e-3
    causal and 6.82e-4 not (the smallest 2.51e-4, 13x the tolerance),
    against 1.79e-6 and 1.07e-6 for three products (measured on the CPU;
    see ``test_f32_kernel_tf32_alone_misses_the_tolerance``)."""
    q, k, v = _qkv((B, Sq, H, hd), (B, Sk, KV, hd), "float32", Sq + Sk + H + hd)
    got = _emulate_f32_kernel(*(torch.tensor(a) for a in (q, k, v)), causal=causal)
    want = jref.ref_flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["float32"], atol=TOL["float32"])


def test_f32_kernel_tf32_alone_misses_the_tolerance():
    """Why three products: with TF32 operands alone the same emulation
    misses 2e-5 at the 10f shape (1, 1000, 4/2 heads, hd 64)."""
    q, k, v = _qkv((1, 1000, 4, 64), (1, 1000, 2, 64), "float32", 5)
    qt, kt, vt = (torch.tensor(a) for a in (q, k, v))
    want = _np(jref.ref_flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=False))
    one = np.abs(_np(_emulate_f32_kernel(qt, kt, vt, False, mm=_mm_tf32)) - want).max()
    three = np.abs(_np(_emulate_f32_kernel(qt, kt, vt, False)) - want).max()
    assert one > TOL["float32"] > 10 * three, (one, three)


def test_kernel_inputs_copy_only_what_tma_cannot_read():
    """bf16: transposed views of (B, heads, S, hd) tensors are read in place;
    a base off the 16-byte grid or a head stride that is not a multiple of
    8 elements is copied into fresh contiguous memory. float32 (the float32
    body reads any strides, 16 bytes at a time where they allow) copies only
    a non-dense head dim."""
    x = torch.randn(2, 40, 4, 64).to(torch.bfloat16)
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert kernel_inputs(strided, strided, strided)[0].data_ptr() == strided.data_ptr()
    buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    padded = torch.zeros(2, 40, 4, 66, dtype=torch.bfloat16)[..., :64]
    padded.copy_(x)
    for t in (shifted, padded):
        assert t.data_ptr() % 16 or t.stride(2) % 8
        got = kernel_inputs(t, t, t)[0]
        assert got.data_ptr() != t.data_ptr() and got.data_ptr() % 16 == 0
        assert got.is_contiguous() and torch.equal(got, t)
    f = torch.empty(x.numel() + 1)[1:].view(x.shape)
    assert f.data_ptr() % 16 and kernel_inputs(f, f, f)[0] is f
    g = torch.randn(2, 40, 4, 128)[..., ::2]
    assert kernel_inputs(g, g, g)[0].is_contiguous()


def _carried(arch, dtype):
    over = dict(dtype=dtype, n_layers=2)
    jcfg = dataclasses.replace(JC.get_reduced(arch), **over)
    tcfg = dataclasses.replace(TC.get_reduced(arch), **over)
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(   # non-zero biases and norm scales
        lambda path, x: x + jnp.asarray(rng.normal(0.0, 0.1, x.shape), x.dtype)
        if any(getattr(k, "key", None) in ("bq", "bk", "bv", "scale") for k in path)
        else x, params)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu",
                            param_dtype=torch.float32)
    return jcfg, tcfg, params, model


def _batch(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[0, 10:20] = -1   # masked positions
    return {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("arch,dtype", [("qwen1_5_0_5b", "float32"), ("qwen3_4b", "float32"),
                                        ("qwen1_5_0_5b", "bfloat16")])
def test_forward_and_loss_match_jax(arch, dtype):
    """One carried model, both attention paths, against JAX's forward and
    loss_fn on the same tokens."""
    jcfg, tcfg, jp, model = _carried(arch, dtype)
    batch = _batch(jcfg.vocab, 2, 64, 2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    logit_tol, loss_tol = FWD_TOL[dtype]
    for impl in ("einsum", "flash"):
        jc, tc = (dataclasses.replace(c, attn_impl=impl) for c in (jcfg, tcfg))
        jl, jaux = jax_forward(jp, jc, jbatch)
        jloss, jm = jax_loss_fn(jp, jc, jbatch)
        with torch.no_grad():
            tl, taux = forward(model, tc, batch)
            tloss, tm = loss_fn(model, tc, batch)
        assert tl.dtype == getattr(torch, dtype) and tl.shape == (2, 64, jcfg.vocab)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=logit_tol, rtol=0)
        assert float(taux) == float(jaux) == 0.0
        assert abs(float(tloss) - float(jloss)) <= loss_tol, (impl, float(tloss), float(jloss))
        assert abs(float(tm["nll"]) - float(jm["nll"])) <= loss_tol


def test_flash_forward_under_grad_raises():
    """The reference has no backward for B10 (jax.grad through the Pallas
    call raises), so the port refuses a flash forward that autograd would
    have to differentiate; without gradients it runs."""
    cfg = dataclasses.replace(TC.get_reduced("qwen1_5_0_5b"), dtype="float32", n_layers=2,
                              attn_impl="flash")
    model = init_params(cfg, device="cpu", param_dtype=torch.float32).requires_grad_()
    batch = _batch(cfg.vocab, 1, 16, 3)
    with pytest.raises(NotImplementedError, match="B10"):
        loss_fn(model, cfg, batch)
    with torch.no_grad():
        loss, _ = loss_fn(model, cfg, batch)
    assert np.isfinite(float(loss))
