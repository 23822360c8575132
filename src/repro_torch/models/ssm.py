"""Mamba-style selective SSM block (Jamba's sequence mixer), the port of
the JAX package's ``models/ssm.py``.

The full-sequence forward runs the recurrence ``h_t = a_t * h_{t-1} +
bx_t`` as a log-depth scan over time (Hillis-Steele: ``ceil(log2 S)``
rounds of whole-tensor products), the counterpart of JAX's
``associative_scan``; the two sum in other orders, so they agree to a
relative bound, not bit for bit. Its backward is the adjoint scan over
reversed time (``_SsmScan``), so training keeps one copy of the state a
layer. Decode carries (the last ``K - 1`` conv inputs, the float32 state
``h``) per layer: O(1) per token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _dtype, _f32, _weight


class Mamba(nn.Module):
    """Parameters of one Mamba block: ``in_proj`` (2 DI, D), ``conv`` (K,
    DI) and ``x_proj`` (2 N + 1, DI), ``out_proj`` (D, DI) in the parameter
    dtype; ``dt_bias`` (DI,), ``a_log`` (DI, N) and ``d_skip`` (DI,) in
    float32, as the JAX package uses them."""

    def __init__(self, cfg: ModelConfig, device=None, param_dtype=None):
        super().__init__()
        D = cfg.d_model
        DI, N = cfg.ssm_expand * D, cfg.ssm_state
        dt = param_dtype or _dtype(cfg)
        self.in_proj = _weight(2 * DI, D, dtype=dt, device=device)
        self.conv = _weight(cfg.ssm_conv, DI, dtype=dt, device=device)
        self.x_proj = _weight(2 * N + 1, DI, dtype=dt, device=device)
        self.dt_bias = _f32(torch.empty(DI, device=device))
        self.a_log = _f32(torch.empty(DI, N, device=device))
        self.d_skip = _f32(torch.empty(DI, device=device))
        self.out_proj = _weight(D, DI, dtype=dt, device=device)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no linear cut-off."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _scan(a: torch.Tensor, h: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The Hillis-Steele rounds on ``a`` and ``h`` IN PLACE (the caller
    passes copies): forward, h_t = a_t * h_{t-1} + h_t; with ``reverse``,
    h_t = a_t * h_{t+1} + h_t, the same rounds on the flipped sequence."""
    S, d = a.shape[1], 1
    while d < S:
        if reverse:
            h[:, :-d] = torch.addcmul(h[:, :-d], a[:, :-d], h[:, d:])
            a[:, :-d] = a[:, :-d] * a[:, d:]
        else:
            h[:, d:] = torch.addcmul(h[:, d:], a[:, d:], h[:, :-d])
            a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return h


class _SsmScan(torch.autograd.Function):
    """The scan with its adjoint, itself a linear scan run backwards over
    time: g_t = dh_t + a_{t+1} g_{t+1}, d bx_t = g_t, d a_t = g_t h_{t-1}
    (h_{-1} = 0). Saves ``a`` and ``h`` only, O(B S DI N) a layer, as JAX's
    differentiated ``associative_scan``; autograd through the rounds would
    keep a copy of the state per round."""

    @staticmethod
    def forward(ctx, a, bx):
        h = _scan(a.clone(), bx.clone())
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        coef = torch.zeros_like(a)
        coef[:, :-1] = a[:, 1:]
        g = _scan(coef, dh.clone(), reverse=True)
        da = torch.zeros_like(g)
        da[:, 1:] = g[:, 1:] * h[:, :-1]
        return da, g


def ssm_scan(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t along axis 1 (h_{-1} = 0), as a
    Hillis-Steele scan of the pairs (a, bx) under JAX's ``combine``;
    differentiable in both (:class:`_SsmScan`)."""
    return _SsmScan.apply(a, bx)


def _gates(p: Mamba, cfg: ModelConfig, u: torch.Tensor):
    """u (B, S, DI) after the conv -> (a, bx (B, S, DI, N), Cm (B, S, N),
    u in float32)."""
    N = cfg.ssm_state
    proj = F.linear(u, p.x_proj.to(u.dtype)).to(torch.float32)
    Bm, Cm, dt = proj[..., :N], proj[..., N:2 * N], proj[..., -1:]
    dt = softplus(dt + p.dt_bias)                                     # (B, S, DI)
    A = -torch.exp(p.a_log)                                           # (DI, N)
    uf = u.to(torch.float32)
    a = torch.exp(dt[..., None] * A)
    bx = (dt[..., None] * Bm[:, :, None, :]) * uf[..., None]
    return a, bx, Cm, uf


def _out(p: Mamba, y: torch.Tensor, z: torch.Tensor, dt) -> torch.Tensor:
    return F.linear(y.to(dt) * F.silu(z), p.out_proj.to(dt))


def _mamba(p: Mamba, cfg: ModelConfig, x: torch.Tensor):
    B, S, _ = x.shape
    xi, z = torch.chunk(F.linear(x, p.in_proj.to(x.dtype)), 2, dim=-1)
    pad = F.pad(xi, (0, 0, cfg.ssm_conv - 1, 0))          # causal depthwise conv
    conv = 0
    for k in range(cfg.ssm_conv):
        conv = conv + pad[:, k:k + S] * p.conv[k].to(x.dtype)
    u = F.silu(conv)
    a, bx, Cm, uf = _gates(p, cfg, u)
    h = ssm_scan(a, bx)                                               # (B, S, DI, N)
    y = torch.einsum("bsin,bsn->bsi", h, Cm) + uf * p.d_skip
    return _out(p, y, z, x.dtype), pad, h


def mamba(p: Mamba, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward. x (B, S, D) -> (B, S, D)."""
    return _mamba(p, cfg, x)[0]


def mamba_prefill(p: Mamba, cfg: ModelConfig, x: torch.Tensor):
    """The forward and the decode state after the sequence: ``conv`` the
    last ``K - 1`` conv inputs (zeros where the sequence is shorter) and
    ``h`` the scan's last state, float32 (JAX ``_mamba_prefill``, which
    replays the recurrence for it)."""
    y, pad, h = _mamba(p, cfg, x)
    return y, {"conv": pad[:, x.shape[1]:], "h": h[:, -1]}


def mamba_init_cache(cfg: ModelConfig, B: int, dtype, device=None, periods: int | None = None):
    """Zero decode state: ``conv`` (B, K - 1, DI) in ``dtype``, ``h`` (B,
    DI, N) float32; with ``periods``, stacked over a leading axis."""
    DI = cfg.ssm_expand * cfg.d_model
    lead = () if periods is None else (periods,)
    return {"conv": torch.zeros(*lead, B, cfg.ssm_conv - 1, DI, dtype=dtype, device=device),
            "h": torch.zeros(*lead, B, DI, cfg.ssm_state, dtype=torch.float32, device=device)}


def mamba_decode(p: Mamba, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """One-token step. x (B, 1, D) -> (y (B, 1, D), the new state)."""
    xi, z = torch.chunk(F.linear(x, p.in_proj.to(x.dtype)), 2, dim=-1)
    window = torch.cat([cache["conv"], xi], dim=1)                   # (B, K, DI)
    conv = torch.einsum("bki,ki->bi", window, p.conv.to(x.dtype))[:, None]
    u = F.silu(conv)
    a, bx, Cm, uf = _gates(p, cfg, u)
    h = a[:, 0] * cache["h"] + bx[:, 0]
    y = torch.einsum("bin,bn->bi", h, Cm[:, 0])[:, None] + uf * p.d_skip
    return _out(p, y, z, x.dtype), {"conv": window[:, 1:], "h": h}


def init_mamba_(p: Mamba, cfg: ModelConfig, normal_, gen: torch.Generator) -> None:
    """The JAX package's init distributions: truncated normals through
    ``normal_(tensor, scale)`` (``1/sqrt(fan)``, the conv at 0.5),
    ``dt_bias`` the inverse softplus of a log-uniform step in [1e-3, 1e-1],
    ``a_log = log(1..N)`` on every channel, ``d_skip`` ones."""
    D = cfg.d_model
    DI, N = cfg.ssm_expand * D, cfg.ssm_state
    normal_(p.in_proj, 1.0 / math.sqrt(D))
    normal_(p.conv, 0.5)
    normal_(p.x_proj, 1.0 / math.sqrt(DI))
    normal_(p.out_proj, 1.0 / math.sqrt(DI))
    u = torch.empty(DI, device=p.dt_bias.device).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen)
    p.dt_bias.copy_(torch.log(torch.expm1(torch.exp(u))))
    p.a_log.copy_(torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                         device=p.a_log.device)).expand(DI, N))
    p.d_skip.fill_(1.0)
