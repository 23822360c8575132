"""The dense LM of the port: parameters, decode cache, ``forward`` and
``loss_fn`` (eval and training), ``prefill`` and ``decode_step`` (serving).

Mirrors the JAX package's ``models/model.py`` for the dense family
(attention blocks, dense SwiGLU MLPs, token frontend, no encoder).
Parameters live in a :class:`DenseLM` module, one :class:`Period` per
super-block period, in the model dtype (serving) or as float32 masters
(``param_dtype=torch.float32``, training; each layer casts at use). The
decode cache keeps the JAX layout: ``cache[f"b{i}"]`` holds ``k``/``v``
``(P, B, S, KV, hd)`` and ``len`` ``(P,)`` int32. ``decode_step`` writes the
new keys and values into the cache in place (the JAX function returns a new
cache; the port saves the copy of the whole cache per step) and returns the
same dict.

``forward`` runs ``cfg.attn_impl``: ``"einsum"`` (materialized scores) or
``"flash"`` (kernel B10, forward only: with gradients required it raises,
as the reference cannot differentiate its kernel either). Other block or
MLP kinds, frontends, encoders and cross-attention raise
``NotImplementedError`` (ROADMAP A8).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve, to_device

from .config import ModelConfig
from .layers import MLP, Attention, RMSNorm, _dtype, _sdpa, causal_keep


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not build yet."""
    kinds = set(cfg.block_pattern) - {"attn"}
    mlps = set(cfg.mlp_pattern) - {"dense"}
    if kinds or mlps or cfg.frontend != "none" or cfg.encoder_layers or cfg.cross_attention:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family (attention blocks, dense MLPs, "
            f"token frontend, no encoder) is ported; block kinds {sorted(kinds)}, "
            f"mlp kinds {sorted(mlps)}, frontend {cfg.frontend!r}, encoder_layers "
            f"{cfg.encoder_layers} wait for ROADMAP A8")
    if cfg.attn_impl not in ("einsum", "flash"):
        raise ValueError(f"{cfg.name}: unknown attn_impl {cfg.attn_impl!r}")


class Period(nn.Module):
    """One super-block period: ``ln_b{i}``, ``b{i}`` (attention), ``ln_m{i}``,
    ``m{i}`` (MLP) for each block ``i`` of the pattern."""

    def __init__(self, cfg: ModelConfig, device=None, param_dtype=None):
        super().__init__()
        self.n = len(cfg.block_pattern)
        dt = param_dtype or _dtype(cfg)
        for i in range(self.n):
            self.add_module(f"ln_b{i}", RMSNorm(cfg.d_model, cfg.norm_eps, device))
            self.add_module(f"b{i}", Attention(cfg, device, dt))
            self.add_module(f"ln_m{i}", RMSNorm(cfg.d_model, cfg.norm_eps, device))
            self.add_module(f"m{i}", MLP(cfg.d_model, cfg.d_ff, dt, device))

    def block(self, i: int):
        return (getattr(self, f"ln_b{i}"), getattr(self, f"b{i}"),
                getattr(self, f"ln_m{i}"), getattr(self, f"m{i}"))

    def forward(self, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """The period over the full sequence (JAX ``_period_forward``);
        ``cfg`` is the caller's, which picks causality and ``attn_impl``."""
        for i in range(self.n):
            ln_b, attn, ln_m, mlp = self.block(i)
            x = x + attn(ln_b(x), pos, causal=cfg.causal, attn_impl=cfg.attn_impl)
            x = x + mlp(ln_m(x))
        return x


class DenseLM(nn.Module):
    """Parameters of a dense LM: ``embed`` (V, D), ``layers`` (one
    :class:`Period` per period), ``final_norm``, and ``lm_head`` (V, D)
    unless the embeddings are tied. Projections, biases and embeddings are
    stored in ``param_dtype`` (default ``cfg.dtype``); norm scales in
    float32."""

    def __init__(self, cfg: ModelConfig, device="cuda", param_dtype=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve(device)
        dt = param_dtype or _dtype(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, dtype=dt, device=dev),
                                  requires_grad=False)
        self.layers = nn.ModuleList(Period(cfg, dev, dt) for _ in range(cfg.n_periods))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty(cfg.vocab, cfg.d_model, dtype=dt, device=dev),
                requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _trunc_normal_(p: torch.Tensor, scale: float, gen: torch.Generator) -> None:
    """``truncated_normal(-2, 2) * scale`` drawn in float32, cast to p's dtype."""
    w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    p.copy_(w * scale)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda", param_dtype=None) -> DenseLM:
    """A :class:`DenseLM` on ``device`` with the JAX package's init
    distributions: truncated normal (+-2 sd) scaled by ``1/sqrt(fan)``, where
    ``fan`` is the first axis of the JAX weight shape (``D`` for q/k/v and
    the MLP inputs, ``H`` for the attention output, ``ff`` for the MLP
    output), ``0.02`` for the embeddings and the head; zero biases, unit
    norm scales. ``generator`` (on ``device``; default seed 0) makes it
    reproducible; the draws differ from JAX's PRNG (the tests carry JAX
    parameters across with ``interop.params_from_jax``). ``param_dtype``
    as for :class:`DenseLM`."""
    model = DenseLM(cfg, device, param_dtype)
    gen = generator or torch.Generator(device=model.device).manual_seed(0)
    D, H, ff = cfg.d_model, cfg.n_heads, cfg.d_ff
    _trunc_normal_(model.embed, 0.02, gen)
    for period in model.layers:
        for i in range(period.n):
            _ln, attn, _lm, mlp = period.block(i)
            for w in (attn.wq, attn.wk, attn.wv):
                _trunc_normal_(w, 1.0 / math.sqrt(D), gen)
            _trunc_normal_(attn.wo, 1.0 / math.sqrt(H), gen)
            _trunc_normal_(mlp.wi, 1.0 / math.sqrt(D), gen)
            _trunc_normal_(mlp.wg, 1.0 / math.sqrt(D), gen)
            _trunc_normal_(mlp.wo, 1.0 / math.sqrt(ff), gen)
    if not cfg.tie_embeddings:
        _trunc_normal_(model.lm_head, 0.02, gen)
    return model


def init_cache(cfg: ModelConfig, B: int, max_seq: int, device="cuda") -> dict:
    """Zero decode cache in the JAX layout: per block ``b{i}`` of the
    period, ``k``/``v`` (P, B, max_seq, KV, hd) in the model dtype and
    ``len`` (P,) int32."""
    check_supported(cfg)
    dev = resolve(device)
    P, dt = cfg.n_periods, _dtype(cfg)
    shape = (P, B, max_seq, cfg.n_kv_heads, cfg.hd)
    return {f"b{i}": {"k": torch.zeros(shape, dtype=dt, device=dev),
                      "v": torch.zeros(shape, dtype=dt, device=dev),
                      "len": torch.zeros(P, dtype=torch.int32, device=dev)}
            for i in range(len(cfg.block_pattern))}


def _embed_in(params: DenseLM, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The token embeddings in the model dtype: the table cast, then
    gathered, as JAX's ``embed.astype(dtype)[tok]`` (so the gradient of the
    gather accumulates in the model dtype there and here)."""
    tok = to_device(batch["tokens"], params.device).long()
    return params.embed.to(_dtype(cfg))[tok]


def _head(params: DenseLM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = params.final_norm(x)
    w = params.embed if cfg.tie_embeddings else params.lm_head
    return F.linear(x, w.to(x.dtype))


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs of
    the matmuls without batch dims (the projections), recompute the rest;
    JAX's ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def forward(params: DenseLM, cfg: ModelConfig, batch: dict, remat: str = "none"):
    """Full-sequence logits (B, S, V) in the model dtype, and the auxiliary
    loss (a float32 zero: the dense family has no router). ``remat``:
    ``"none"``, ``"full"`` (recompute each period in the backward) or
    ``"dots"`` (recompute all but the projections' outputs); the values do
    not depend on it."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")
    x = _embed_in(params, cfg, batch)
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    ctx = {}
    if remat == "dots":
        ctx = dict(context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                _save_dots))
    for period in params.layers:
        if remat == "none" or not torch.is_grad_enabled():
            x = period(x, pos, cfg)
        else:
            x = checkpoint(period, x, pos, cfg, use_reentrant=False, **ctx)
    return _head(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: DenseLM, cfg: ModelConfig, batch: dict, remat: str = "none"):
    """Next-token NLL over positions whose label is ``>= 0``, in float32,
    plus ``0.01 * aux``; returns ``(loss, {"nll", "aux"})`` as JAX's
    ``loss_fn``."""
    logits, aux = forward(params, cfg, batch, remat)
    labels = to_device(batch["labels"], logits.device).long()
    lg = logits[:, :-1].to(torch.float32)
    tg = labels[:, 1:]
    lse = torch.logsumexp(lg, dim=-1)
    # masked labels (< 0) pick entry 0 here (JAX wraps them); either way the
    # mask zeroes the term
    picked = torch.take_along_dim(lg, tg.clamp(min=0)[..., None], dim=-1)[..., 0]
    mask = (tg >= 0).to(torch.float32)
    nll = torch.sum((lse - picked) * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


@torch.no_grad()
def prefill(params: DenseLM, cfg: ModelConfig, batch: dict, max_seq: int):
    """Run the prompt ``batch["tokens"]`` (B, S); return (last-position
    logits (B, V), a fresh decode cache holding the prompt's keys and
    values, ``None`` for the encoder output the dense family lacks)."""
    x = _embed_in(params, cfg, batch)
    B, Sq, _ = x.shape
    if Sq > max_seq:
        raise ValueError(f"prompt of {Sq} tokens exceeds max_seq={max_seq}")
    pos = torch.arange(Sq, device=x.device)[None].expand(B, Sq)
    keep = causal_keep(Sq, Sq, x.device) if cfg.causal else None
    cache = init_cache(cfg, B, max_seq, x.device)
    for p, period in enumerate(params.layers):
        for i in range(period.n):
            ln_b, attn, ln_m, mlp = period.block(i)
            c = cache[f"b{i}"]
            q, k, v = attn.qkv(ln_b(x), pos)
            x = x + attn.out(_sdpa(q, k, v, keep))
            c["k"][p, :, :Sq] = k
            c["v"][p, :, :Sq] = v
            c["len"][p] = Sq
            x = x + mlp(ln_m(x))
    return _head(params, cfg, x[:, -1:])[:, 0], cache, None


@torch.no_grad()
def decode_step(params: DenseLM, cfg: ModelConfig, cache: dict, token, pos):
    """token (B,), pos (B,) -> (logits (B, V), cache). Row ``b`` writes its
    key and value at ``pos[b]`` (in place) and attends to ``0..pos[b]``."""
    dev = params.device
    token = to_device(token, dev).long()
    pos = to_device(pos, dev).long()
    x = _embed_in(params, cfg, {"tokens": token[:, None]})
    for p, period in enumerate(params.layers):
        for i in range(period.n):
            ln_b, attn, ln_m, mlp = period.block(i)
            c = cache[f"b{i}"]
            x = x + attn.decode(ln_b(x), c["k"][p], c["v"][p], pos)
            x = x + mlp(ln_m(x))
    for c in cache.values():
        c["len"] += 1
    return _head(params, cfg, x)[:, 0], cache
