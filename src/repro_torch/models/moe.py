"""Mixture-of-Experts with grouped capacity dispatch (GShard style), the
port of the JAX package's ``models/moe.py``.

Tokens are cut into ``G`` groups of ``g`` tokens (``_pick_groups``); within
a group each token's top-``k`` experts (or ``k`` draws from its gate CDF,
the sampled mode) take capacity slots in token-major order, and a (token,
choice) pair past ``cap = ceil(g * k / E * capacity_factor)`` drops. The
JAX package dispatches and combines with one-hot einsums over ``(G, g, E,
cap)``; here the kept pairs are scattered into the ``(G, E, cap, D)``
capacity buffers and gathered back by index, which gives the same buffers
(each slot holds one token or zeros) without the one-hot tensors. Every
expert's buffer goes through its three products, empty or not, as in JAX:
one batched ``torch.matmul`` over the experts.

``_route`` breaks ties as ``jax.lax.top_k`` does (the lower expert index
first) through a stable descending sort; ``torch.topk`` promises no order
on ties. ``cfg.router_noise`` is read nowhere, as in the JAX model.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import MLP, _dtype, _f32, _weight

GROUP_TOKENS = 2048  # target tokens per dispatch group


class MoE(nn.Module):
    """Parameters of one MoE MLP: ``router`` (E, D) float32 (the JAX package
    routes in float32), the experts' ``wi``/``wg`` (E, D, F) and ``wo`` (E,
    F, D) in the JAX layout, and ``shared``, a SwiGLU MLP of ``F *
    n_shared_experts`` hidden units, when the config has shared experts."""

    def __init__(self, cfg: ModelConfig, device=None, param_dtype=None):
        super().__init__()
        D, E, Fe = cfg.d_model, cfg.n_experts, cfg.expert_ff
        dt = param_dtype or _dtype(cfg)
        self.router = _f32(torch.empty(E, D, device=device))
        self.wi = _weight(E, D, Fe, dtype=dt, device=device)
        self.wg = _weight(E, D, Fe, dtype=dt, device=device)
        self.wo = _weight(E, Fe, D, dtype=dt, device=device)
        if cfg.n_shared_experts:
            self.shared = MLP(D, Fe * cfg.n_shared_experts, dt, device)


def _route(gates: torch.Tensor, k: int, noise_xi: torch.Tensor | None = None):
    """gates (..., E) softmax probabilities -> ((..., k) expert ids int64,
    (..., k) weights renormalized over the k). Top-k mode: the k largest
    gates, ties to the lower index (``jax.lax.top_k``'s order). Sampled
    mode: the monotone inverse of each row's gate CDF at the ``k`` uniforms
    ``noise_xi`` (..., k)."""
    if noise_xi is None:
        w, ids = torch.sort(gates, dim=-1, descending=True, stable=True)
        w, ids = w[..., :k], ids[..., :k]
        return ids, w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(gates, dim=-1)
    cdf = cdf / cdf[..., -1:]
    ids = torch.sum(cdf[..., None, :] <= noise_xi[..., :, None], dim=-1)
    ids = torch.clamp(ids, 0, gates.shape[-1] - 1)
    w = torch.take_along_dim(gates, ids, dim=-1)
    return ids, w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)


def _pick_groups(T: int) -> int:
    """The smallest divisor G of T whose groups hold at most GROUP_TOKENS
    tokens (for a prime T above GROUP_TOKENS: T groups of one token), as
    the JAX package picks it."""
    g = 1
    for cand in range(1, T + 1):
        if T % cand == 0 and T // cand <= GROUP_TOKENS:
            g = cand
            break
    return g


def capacity(g: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots per expert in a group of ``g`` tokens."""
    return max(int(math.ceil(g * k / E * capacity_factor)), 1)


def dispatch_plan(ids: torch.Tensor, E: int, cap: int):
    """ids (G, g, k) -> (keep (G, g, k, E) float32, pos (G, g, k) int64):
    each (token, choice) pair's slot in its expert's buffer, counted in
    token-major order over the group, and whether it is under ``cap``
    (JAX's cumsum of the one-hot ids, taken here in int64: exact)."""
    G, g, k = ids.shape
    onehot = F.one_hot(ids, E)                                        # (G, g, k, E)
    pos = torch.cumsum(onehot.reshape(G, g * k, E), dim=1).reshape(G, g, k, E) - onehot
    keep = (pos < cap) * onehot
    return keep.to(torch.float32), torch.sum(pos * keep, dim=-1)


def moe(p: MoE, cfg: ModelConfig, x: torch.Tensor, noise_xi: torch.Tensor | None = None):
    """x (B, S, D) -> (y (B, S, D), the Switch load-balance aux loss, a
    float32 scalar). y in x's dtype: the kept pairs' expert outputs weighted
    by their gate weights (rounded to x's dtype, as JAX's combine tensor),
    summed over the k choices in float32, plus the shared experts."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = _pick_groups(T)
    g = T // G
    dt = x.dtype
    xt = x.reshape(G, g, D)
    logits = F.linear(xt.to(torch.float32), p.router)
    gates = torch.softmax(logits, dim=-1)
    ids, weights = _route(gates, k, noise_xi)                        # (G, g, k)
    cap = capacity(g, k, E, cfg.capacity_factor)
    keep, pos = dispatch_plan(ids, E, cap)
    kept = keep.sum(-1) > 0                                           # (G, g, k)

    # dispatch: slot (e, c) of group gi holds the token that took it, else 0
    slot = (torch.arange(G, device=x.device)[:, None, None] * E + ids) * cap + pos
    src = torch.arange(G * g, device=x.device).view(G, g, 1).expand(G, g, k)
    xin = x.new_zeros(G * E * cap, D)
    xin[slot[kept]] = xt.reshape(G * g, D)[src[kept]]
    xin = xin.view(G, E, cap, D)
    h = torch.matmul(xin, p.wi.to(dt))                                # (G, E, cap, F)
    hg = torch.matmul(xin, p.wg.to(dt))
    out = torch.matmul(F.silu(hg) * h, p.wo.to(dt)).view(G * E * cap, D)

    # combine: each kept pair's output times its weight in x's dtype
    cw = (weights * kept).to(dt).to(torch.float32)                    # (G, g, k)
    y = torch.sum(cw[..., None] * out[slot].to(torch.float32), dim=2).to(dt)
    if hasattr(p, "shared"):
        y = y + p.shared(xt)

    me = torch.mean(gates, dim=1)                                     # (G, E)
    ce = torch.mean(torch.sum(keep, dim=2), dim=1) / max(k, 1)        # (G, E)
    aux = E * torch.mean(torch.sum(me * ce, dim=-1))
    return y.reshape(B, S, D), aux
