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

Over DTensors (a distributed model) the layer runs by local shards
(``_moe_local``): the experts split over the mesh dims that shard their
leading dim (expert parallelism), the tokens over the batch-sharded dims.
Each rank routes its own tokens; the routing ids are gathered over the
batch dims, so every (token, choice) pair's capacity slot is counted over
its whole group, as on one device (the groups follow the global token
count and may span batch shards). A rank fills and runs only its experts'
capacity buffers for its tokens' kept pairs, and its combine and its
experts' share of the aux loss are partial sums, reduced once.

``_route`` breaks ties as ``jax.lax.top_k`` does (the lower expert index
first) through a stable descending sort; ``torch.topk`` promises no order
on ties. ``cfg.router_noise`` is read nowhere, as in the JAX model.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor

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


def group_span(t0: int, Tl: int, g: int) -> tuple[int, int]:
    """The groups ``[gi0, gi1)`` of ``g`` tokens that tokens ``t0..t0+Tl``
    fall in."""
    return t0 // g, -(-(t0 + Tl) // g)


def group_plan(ids: torch.Tensor, G: int, t0: int, Tl: int, E: int, cap: int):
    """The dispatch plan of the groups that tokens ``t0..t0+Tl`` fall in,
    from ``ids`` (T, k), the routing ids of every token of the batch (a
    rank's gathered over the batch shards): ``(ids, keep, pos)`` of those
    groups, (Gl, g, k), (Gl, g, k, E) and (Gl, g, k), each pair's slot
    counted over its whole group as :func:`dispatch_plan` counts it on the
    whole batch."""
    T, k = ids.shape
    g = T // G
    gi0, gi1 = group_span(t0, Tl, g)
    gids = ids.reshape(G, g, k)[gi0:gi1]
    return (gids, *dispatch_plan(gids, E, cap))


def moe(p: MoE, cfg: ModelConfig, x: torch.Tensor, noise_xi: torch.Tensor | None = None):
    """x (B, S, D) -> (y (B, S, D), the Switch load-balance aux loss, a
    float32 scalar). y in x's dtype: the kept pairs' expert outputs weighted
    by their gate weights (rounded to x's dtype, as JAX's combine tensor),
    summed over the k choices in float32, plus the shared experts. Over
    DTensors by local shards (module docstring)."""
    if isinstance(x, DTensor):
        return _moe_local(p, cfg, x, noise_xi)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = _pick_groups(T)
    g = T // G
    xt = x.reshape(G, g, D)
    logits = F.linear(xt.to(torch.float32), p.router)
    gates = torch.softmax(logits, dim=-1)
    ids, weights = _route(gates, k, noise_xi)                        # (G, g, k)
    cap = capacity(g, k, E, cfg.capacity_factor)
    keep, pos = dispatch_plan(ids, E, cap)
    y, aux = _experts(xt, gates, ids, weights, keep, pos, cap, p.wi, p.wg, p.wo)
    y = y.reshape(B, S, D)
    if hasattr(p, "shared"):
        y = y + p.shared(x)      # on x, as the local form (one gradient order)
    return y, aux


def _experts(xt, gates, ids, weights, keep, pos, cap: int, wi, wg, wo, e0: int = 0,
             mine_tok: torch.Tensor | None = None):
    """The dispatch, the experts' three products and the combine of the
    groups ``xt`` (G, g, D), routed by ``gates`` (G, g, E), ``ids`` and
    ``weights`` (G, g, k) with the plan ``keep``/``pos``, for the experts
    ``e0..e0+El`` whose weights ``wi``/``wg``/``wo`` (El, ...) are given
    (all of them on one device) and the tokens where ``mine_tok`` (G, g,
    1) is true (all where None). Returns (y (G * g, D) in xt's dtype, the
    aux loss's terms of those experts and tokens, E times their mean over
    the G groups)."""
    G, g, D = xt.shape
    E, k, El = gates.shape[-1], ids.shape[-1], wi.shape[0]
    dt, dev = xt.dtype, xt.device
    mine = (ids >= e0) & (ids < e0 + El)                              # the given experts
    kept = (keep.sum(-1) > 0) & mine                                  # (G, g, k)
    if mine_tok is not None:
        kept = kept & mine_tok

    # dispatch: slot (e, c) of group gi holds the token that took it, else 0
    slot = (torch.arange(G, device=dev)[:, None, None] * El + ids - e0) * cap + pos
    slot = torch.where(mine, slot, 0)
    src = torch.arange(G * g, device=dev).view(G, g, 1).expand(G, g, k)
    xin = xt.new_zeros(G * El * cap, D)
    xin[slot[kept]] = xt.reshape(G * g, D)[src[kept]]
    xin = xin.view(G, El, cap, D)
    h = torch.matmul(xin, wi.to(dt))                                  # (G, El, cap, F)
    hg = torch.matmul(xin, wg.to(dt))
    out = torch.matmul(F.silu(hg) * h, wo.to(dt)).view(G * El * cap, D)

    # combine: each kept pair's output times its weight in xt's dtype
    cw = (weights * kept).to(dt).to(torch.float32)                    # (G, g, k)
    y = torch.sum(cw[..., None] * out[slot].to(torch.float32), dim=2).to(dt)

    me = torch.mean(gates if mine_tok is None else gates * mine_tok, dim=1)   # (G, E)
    ce = torch.mean(torch.sum(keep, dim=2), dim=1) / max(k, 1)        # (G, E)
    aux = E * torch.mean(torch.sum((me * ce)[:, e0:e0 + El], dim=-1))
    return y.reshape(G * g, D), aux


def _local_route(p: MoE, cfg: ModelConfig, x, noise_xi=None) -> SimpleNamespace:
    """The routing of a DTensor ``x``'s local tokens (its rows), on the grid
    of the ``Gl`` groups from ``gi0`` that they fall in (at ``lo..lo+Tl``
    of the grid's ``Gl * g`` tokens, zeros elsewhere): the split ``sp``,
    the rows ``xl``, the grid ``xt`` (Gl, g, D), ``gates`` (Gl, g, E), the
    gate ``weights`` and the gathered ``ids`` (Gl, g, k), and the plan
    ``keep``/``pos`` of the whole groups. On one rank the grid is ``x``."""
    from repro_torch.dist.local import Split, whole

    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = _pick_groups(T)
    g = T // G
    sp = Split(x, p.wi, E)
    xl = sp.rows(x)                                                   # (Bl, S, D)
    Tl, t0 = xl.shape[0] * S, sp.b0 * S
    gi0, gi1 = group_span(t0, Tl, g)
    Gl, lo = gi1 - gi0, t0 - gi0 * g
    xt = xl.reshape(Tl, D)
    if Gl * g != Tl:
        xt = F.pad(xt, (0, 0, lo, Gl * g - lo - Tl))
    xt = xt.view(Gl, g, D)
    logits = F.linear(xt.to(torch.float32), sp.weight(p.router))
    gates = torch.softmax(logits, dim=-1)
    if noise_xi is not None:
        noise_xi = whole(noise_xi).reshape(T, k)[gi0 * g:gi1 * g].view(Gl, g, k)
    ids, weights = _route(gates, k, noise_xi)                        # (Gl, g, k)
    ids_all = sp.whole_rows(ids.reshape(Gl * g, k)[lo:lo + Tl].reshape(-1, S, k))
    cap = capacity(g, k, E, cfg.capacity_factor)
    ids, keep, pos = group_plan(ids_all.reshape(T, k), G, t0, Tl, E, cap)
    return SimpleNamespace(sp=sp, xl=xl, xt=xt, gates=gates, weights=weights, ids=ids,
                           keep=keep, pos=pos, G=G, g=g, Gl=Gl, lo=lo, Tl=Tl, cap=cap)


def _moe_local(p: MoE, cfg: ModelConfig, x, noise_xi=None):
    """:func:`moe` of a DTensor ``x`` by local shards: ``_local_route``,
    then ``_experts`` for the rank's experts and tokens (on one rank every
    step is the plain layer's)."""
    S, D = x.shape[1], x.shape[2]
    r = _local_route(p, cfg, x, noise_xi)
    sp, lo, Tl = r.sp, r.lo, r.Tl
    mine_tok = torch.zeros(r.Gl * r.g, dtype=torch.bool, device=r.xl.device)
    mine_tok[lo:lo + Tl] = True
    y, aux = _experts(r.xt, r.gates, r.ids, r.weights, r.keep, r.pos, r.cap,
                      sp.weight(p.wi, 0), sp.weight(p.wg, 0), sp.weight(p.wo, 0),
                      sp.units(cfg.n_experts)[0], mine_tok.view(r.Gl, r.g, 1))
    y = sp.out(y[lo:lo + Tl].reshape(-1, S, D))                       # partial over experts
    if hasattr(p, "shared"):
        y = y + p.shared(x)
    if r.Gl != r.G:
        aux = aux * (r.Gl / r.G)      # the rank's groups' share of the mean over all
    return y, sp.scalar(aux)
