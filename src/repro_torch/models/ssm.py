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

Over DTensors (a distributed model) the block runs by local shards
(``dist.local.Split``): each rank takes its channels of DI, split over the
mesh dims that shard ``in_proj``'s output. That output is JAX's
concatenated ``[x | z]``, whose shards are not the two halves' shards, so
the rank's block of it is gathered over those dims and both halves
re-sliced. The conv, the gates and the scan run on the local channels;
``x_proj`` contracts over them, so its output is summed over the split
dims; ``out_proj`` is row-parallel, a partial sum. The decode state ``h``
takes the local channels; ``conv``, which JAX's cache rule leaves whole,
is sliced on the way in and written back whole.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor

from repro_torch.dist.local import Split

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


def _gates(p: Mamba, cfg: ModelConfig, u: torch.Tensor, reduce=None):
    """u (B, S, DI) after the conv -> (a, bx (B, S, DI, N), Cm (B, S, N),
    u in float32). ``reduce`` sums ``x_proj``'s output over the ranks
    that split DI (a local form's)."""
    N = cfg.ssm_state
    proj = F.linear(u, p.x_proj.to(u.dtype)).to(torch.float32)
    if reduce is not None:
        proj = reduce(proj)
    Bm, Cm, dt = proj[..., :N], proj[..., N:2 * N], proj[..., -1:]
    dt = softplus(dt + p.dt_bias)                                     # (B, S, DI)
    A = -torch.exp(p.a_log)                                           # (DI, N)
    uf = u.to(torch.float32)
    a = torch.exp(dt[..., None] * A)
    bx = (dt[..., None] * Bm[:, :, None, :]) * uf[..., None]
    return a, bx, Cm, uf


def _out(p: Mamba, y: torch.Tensor, z: torch.Tensor, dt) -> torch.Tensor:
    return F.linear(y.to(dt) * F.silu(z), p.out_proj.to(dt))


def _in(p: Mamba, x: torch.Tensor):
    """(xi, z) (B, S, DI): the halves of the input projection."""
    return torch.chunk(F.linear(x, p.in_proj.to(x.dtype)), 2, dim=-1)


def _mamba(p: Mamba, cfg: ModelConfig, xi: torch.Tensor, z: torch.Tensor, reduce=None):
    S = xi.shape[1]
    pad = F.pad(xi, (0, 0, cfg.ssm_conv - 1, 0))          # causal depthwise conv
    conv = 0
    for k in range(cfg.ssm_conv):
        conv = conv + pad[:, k:k + S] * p.conv[k].to(xi.dtype)
    u = F.silu(conv)
    a, bx, Cm, uf = _gates(p, cfg, u, reduce)
    h = ssm_scan(a, bx)                                               # (B, S, DI, N)
    y = torch.einsum("bsin,bsn->bsi", h, Cm) + uf * p.d_skip
    return _out(p, y, z, xi.dtype), pad, h


def _split(p: Mamba, cfg: ModelConfig, x):
    """The local form's split, its local weights and the rank's channels of
    the input projection's halves (module docstring)."""
    DI = cfg.ssm_expand * cfg.d_model
    sp = Split(x, p.in_proj, DI)
    xl = sp.rows(x)
    xz = sp.gather(F.linear(xl, sp.weight(p.in_proj, 0).to(xl.dtype)), 2)
    c0, c1 = sp.units(DI)
    local = SimpleNamespace(conv=sp.weight(p.conv, 1), x_proj=sp.weight(p.x_proj, 1),
                            dt_bias=sp.weight(p.dt_bias, 0), a_log=sp.weight(p.a_log, 0),
                            d_skip=sp.weight(p.d_skip, 0), out_proj=sp.weight(p.out_proj, 1))
    return sp, local, xz[..., c0:c1], xz[..., DI + c0:DI + c1]


def mamba(p: Mamba, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward. x (B, S, D) -> (B, S, D)."""
    if isinstance(x, DTensor):
        sp, local, xi, z = _split(p, cfg, x)
        return sp.out(_mamba(local, cfg, xi, z, sp.reduce)[0])
    return _mamba(p, cfg, *_in(p, x))[0]


def mamba_prefill(p: Mamba, cfg: ModelConfig, x: torch.Tensor):
    """The forward and the decode state after the sequence: ``conv`` the
    last ``K - 1`` conv inputs (zeros where the sequence is shorter) and
    ``h`` the scan's last state, float32 (JAX ``_mamba_prefill``, which
    replays the recurrence for it)."""
    S = x.shape[1]
    if isinstance(x, DTensor):
        sp, local, xi, z = _split(p, cfg, x)
        y, pad, h = _mamba(local, cfg, xi, z, sp.reduce)
        return sp.out(y), {"conv": sp.state_out(pad[:, S:], 2),
                           "h": sp.state_out(h[:, -1], 1)}
    y, pad, h = _mamba(p, cfg, *_in(p, x))
    return y, {"conv": pad[:, S:], "h": h[:, -1]}


def mamba_init_cache(cfg: ModelConfig, B: int, dtype, device=None, periods: int | None = None):
    """Zero decode state: ``conv`` (B, K - 1, DI) in ``dtype``, ``h`` (B,
    DI, N) float32; with ``periods``, stacked over a leading axis."""
    DI = cfg.ssm_expand * cfg.d_model
    lead = () if periods is None else (periods,)
    return {"conv": torch.zeros(*lead, B, cfg.ssm_conv - 1, DI, dtype=dtype, device=device),
            "h": torch.zeros(*lead, B, DI, cfg.ssm_state, dtype=torch.float32, device=device)}


def _step(p: Mamba, cfg: ModelConfig, xi, z, cache: dict, reduce=None):
    window = torch.cat([cache["conv"], xi], dim=1)                   # (B, K, DI)
    conv = torch.einsum("bki,ki->bi", window, p.conv.to(xi.dtype))[:, None]
    u = F.silu(conv)
    a, bx, Cm, uf = _gates(p, cfg, u, reduce)
    h = a[:, 0] * cache["h"] + bx[:, 0]
    y = torch.einsum("bin,bn->bi", h, Cm[:, 0])[:, None] + uf * p.d_skip
    return _out(p, y, z, xi.dtype), {"conv": window[:, 1:], "h": h}


def mamba_decode(p: Mamba, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """One-token step. x (B, 1, D) -> (y (B, 1, D), the new state)."""
    if isinstance(x, DTensor):
        sp, local, xi, z = _split(p, cfg, x)
        st = {"conv": sp.state_in(cache["conv"], 2), "h": sp.state_in(cache["h"], 1)}
        y, st = _step(local, cfg, xi, z, st, sp.reduce)
        return sp.out(y), {"conv": sp.state_out(st["conv"], 2), "h": sp.state_out(st["h"], 1)}
    return _step(p, cfg, *_in(p, x), cache)


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
