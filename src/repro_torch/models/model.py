"""The dense LM of the port: parameters, decode cache, ``prefill`` and
``decode_step``.

Mirrors the serving entry points of the JAX package's ``models/model.py``
for the dense family (attention blocks, dense SwiGLU MLPs, token frontend,
no encoder). Parameters live in a :class:`DenseLM` module, one
:class:`Period` per super-block period; the decode cache keeps the JAX
layout: ``cache[f"b{i}"]`` holds ``k``/``v`` ``(P, B, S, KV, hd)`` and
``len`` ``(P,)`` int32. ``decode_step`` writes the new keys and values into
the cache in place (the JAX function returns a new cache; the port saves the
copy of the whole cache per step) and returns the same dict.

Other block or MLP kinds, frontends, encoders and cross-attention raise
``NotImplementedError`` (ROADMAP A8); ``attn_impl="flash"`` raises until
kernel B10 is ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

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
    if cfg.attn_impl != "einsum":
        raise NotImplementedError(
            f"{cfg.name}: attn_impl={cfg.attn_impl!r} needs the flash-attention "
            "kernel, not ported yet (ROADMAP B10); use attn_impl='einsum'")


class Period(nn.Module):
    """One super-block period: ``ln_b{i}``, ``b{i}`` (attention), ``ln_m{i}``,
    ``m{i}`` (MLP) for each block ``i`` of the pattern."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.n = len(cfg.block_pattern)
        for i in range(self.n):
            self.add_module(f"ln_b{i}", RMSNorm(cfg.d_model, cfg.norm_eps, device))
            self.add_module(f"b{i}", Attention(cfg, device))
            self.add_module(f"ln_m{i}", RMSNorm(cfg.d_model, cfg.norm_eps, device))
            self.add_module(f"m{i}", MLP(cfg.d_model, cfg.d_ff, _dtype(cfg), device))

    def block(self, i: int):
        return (getattr(self, f"ln_b{i}"), getattr(self, f"b{i}"),
                getattr(self, f"ln_m{i}"), getattr(self, f"m{i}"))


class DenseLM(nn.Module):
    """Parameters of a dense LM: ``embed`` (V, D), ``layers`` (one
    :class:`Period` per period), ``final_norm``, and ``lm_head`` (V, D)
    unless the embeddings are tied."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        check_supported(cfg)
        dev = resolve(device)
        dt = _dtype(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, dtype=dt, device=dev),
                                  requires_grad=False)
        self.layers = nn.ModuleList(Period(cfg, dev) for _ in range(cfg.n_periods))
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
                device="cuda") -> DenseLM:
    """A :class:`DenseLM` on ``device`` with the JAX package's init
    distributions: truncated normal (+-2 sd) scaled by ``1/sqrt(fan)``, where
    ``fan`` is the first axis of the JAX weight shape (``D`` for q/k/v and
    the MLP inputs, ``H`` for the attention output, ``ff`` for the MLP
    output), ``0.02`` for the embeddings and the head; zero biases, unit
    norm scales. ``generator`` (on ``device``; default seed 0) makes it
    reproducible; the draws differ from JAX's PRNG (the tests carry JAX
    parameters across with ``interop.params_from_jax``)."""
    model = DenseLM(cfg, device)
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
    return params.embed[to_device(batch["tokens"], params.device).long()]


def _head(params: DenseLM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = params.final_norm(x)
    w = params.embed if cfg.tie_embeddings else params.lm_head
    return F.linear(x, w)


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
    x = params.embed[token][:, None]
    for p, period in enumerate(params.layers):
        for i in range(period.n):
            ln_b, attn, ln_m, mlp = period.block(i)
            c = cache[f"b{i}"]
            x = x + attn.decode(ln_b(x), c["k"][p], c["v"][p], pos)
            x = x + mlp(ln_m(x))
    for c in cache.values():
        c["len"] += 1
    return _head(params, cfg, x)[:, 0], cache
