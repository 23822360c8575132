"""The LM of the port: parameters, decode cache, ``forward`` and ``loss_fn``
(eval and training), ``prefill`` and ``decode_step`` (serving), for every
family of the JAX package's ``models/model.py``.

A period (super-block) holds, for each block ``i`` of ``cfg.block_pattern``:
``ln_b{i}`` and ``b{i}`` (attention, Mamba, mLSTM or sLSTM), then, for an
attention block of an encoder-decoder config, ``ln_x{i}`` and ``x{i}``
(cross-attention over the encoder output), then ``ln_m{i}`` and ``m{i}``
(a dense SwiGLU MLP or an MoE) unless the MLP kind is ``"none"``; they run
in that order, as JAX's ``_period_forward``. The ``embed`` frontend reads
``batch["embeds"]`` (B, S, D) and has no ``embed`` table; an encoder
(Whisper) runs non-causal attention blocks over ``batch["frames"]``.
Parameters live in an :class:`LM` module in the model dtype (serving) or
as float32 masters (``param_dtype=torch.float32``); the leaves JAX uses in
float32 whatever the model dtype (norm scales, the router, the SSM and
xLSTM gate constants) stay float32.

The decode cache keeps the JAX layout, stacked over the periods: for an
attention block ``k``/``v`` (P, B, S, KV, hd) and ``len`` (P,) int32; for
Mamba ``conv`` (P, B, K - 1, DI) and ``h`` (P, B, DI, N); for mLSTM ``C``
(P, B, H, hd, hd) and ``n``; for sLSTM ``h``, ``c``, ``n``, ``m`` (P, B, H,
hd). ``decode_step`` writes the new state into the cache in place (the JAX
function returns a new cache; the port saves the copy of the whole cache
per step) and returns the same dict. It recomputes the encoder's keys and
values every step, as JAX does.

``forward`` runs ``cfg.attn_impl``: ``"einsum"`` (materialized scores) or
``"flash"`` (kernel B10, forward only: with gradients required it raises,
as the reference cannot differentiate its kernel either). Prefill, decode
and cross-attention always use the materialized scores, as in JAX.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve, to_device
from repro_torch.dist import hints as H
from repro_torch.dist import local as L
from repro_torch.dist.sharding import place_batch

from . import moe as M
from . import ssm as S
from . import xlstm as X
from .config import ModelConfig
from .layers import (
    MLP,
    Attention,
    RMSNorm,
    _dtype,
    _sdpa,
    attend,
    causal_keep,
    cross_attention,
    encoder_kv,
)

BLOCKS = {"attn": Attention, "mamba": S.Mamba, "mlstm": X.MLSTM, "slstm": X.SLSTM}
MLPS = ("dense", "moe", "none")
# the recurrent blocks' full-sequence, prefill (output and state) and
# one-step forms
_SEQUENCE = {"mamba": S.mamba, "mlstm": X.mlstm, "slstm": X.slstm}
_PREFILL = {"mamba": S.mamba_prefill, "mlstm": X.mlstm_prefill, "slstm": X.slstm_prefill}
_DECODE = {"mamba": S.mamba_decode, "mlstm": X.mlstm_decode, "slstm": X.slstm_decode}

# Largest float32 temporary of one init draw (elements): a weight is drawn
# in slices along its first axis, so a (384, 7168, 2048) expert stack needs
# ~1 GB beside itself, not 22.5 GB.
INIT_SLICE_ELEMS = 1 << 28


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block or MLP kind, or an ``attn_impl``,
    the model does not know (JAX's ``_init_block`` raises for a block kind)."""
    for kind in cfg.block_pattern:
        if kind not in BLOCKS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
    for kind in cfg.mlp_pattern:
        if kind not in MLPS:
            raise ValueError(f"{cfg.name}: unknown mlp kind {kind!r}")
    if cfg.attn_impl not in ("einsum", "flash"):
        raise ValueError(f"{cfg.name}: unknown attn_impl {cfg.attn_impl!r}")


def _zero(x: torch.Tensor) -> torch.Tensor:
    """A float32 zero to sum the aux losses in (replicated beside a
    DTensor ``x``: a MoE's aux loss is a DTensor there)."""
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.replicate(z, x.device_mesh) if isinstance(x, DTensor) else z


def _mlp_kind(cfg: ModelConfig, i: int) -> str:
    return cfg.mlp_pattern[i % len(cfg.mlp_pattern)]


def _cross(cfg: ModelConfig, kind: str) -> bool:
    return cfg.cross_attention and kind == "attn"


class Period(nn.Module):
    """One super-block period (see the module docstring for its names)."""

    def __init__(self, cfg: ModelConfig, device=None, param_dtype=None):
        super().__init__()
        self.kinds = tuple(cfg.block_pattern)
        dt = param_dtype or _dtype(cfg)
        D = cfg.d_model
        for i, kind in enumerate(self.kinds):
            self.add_module(f"ln_b{i}", RMSNorm(D, cfg.norm_eps, device))
            self.add_module(f"b{i}", BLOCKS[kind](cfg, device, dt))
            if _cross(cfg, kind):
                self.add_module(f"ln_x{i}", RMSNorm(D, cfg.norm_eps, device))
                self.add_module(f"x{i}", Attention(cfg, device, dt))
            mk = _mlp_kind(cfg, i)
            if mk != "none":
                self.add_module(f"ln_m{i}", RMSNorm(D, cfg.norm_eps, device))
                self.add_module(f"m{i}", MLP(D, cfg.d_ff, dt, device) if mk == "dense"
                                else M.MoE(cfg, device, dt))

    def sub(self, name: str, i: int):
        return getattr(self, f"{name}{i}")

    def tail(self, i: int, x: torch.Tensor, cfg: ModelConfig, enc_out):
        """After block ``i``: the cross-attention (an attention block of an
        encoder-decoder), then the MLP. Returns (x, the MoE aux loss or
        None)."""
        if _cross(cfg, self.kinds[i]):
            xa = self.sub("x", i)
            x = x + cross_attention(xa, cfg, self.sub("ln_x", i)(x),
                                    encoder_kv(xa, cfg, enc_out))
        mk = _mlp_kind(cfg, i)
        if mk == "dense":
            return x + self.sub("m", i)(self.sub("ln_m", i)(x)), None
        if mk == "moe":
            y, aux = M.moe(self.sub("m", i), cfg, self.sub("ln_m", i)(x))
            return x + y, aux
        return x, None

    def forward(self, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig, enc_out=None):
        """The period over the full sequence (JAX ``_period_forward``);
        ``cfg`` is the caller's, which picks causality and ``attn_impl``.
        Returns (x, the period's summed MoE aux loss, float32)."""
        aux = _zero(x)
        pp = H.gather_params(self)   # ZeRO-3 gather-on-use (no-op without hints)
        x = H.act_seq(x)             # sequence-sharded residual (no-op without hints)
        for i, kind in enumerate(pp.kinds):
            b, h = pp.sub("b", i), pp.sub("ln_b", i)(x)
            if kind == "attn":
                y = b(h, pos, causal=cfg.causal, attn_impl=cfg.attn_impl)
            else:
                y = _SEQUENCE[kind](b, cfg, h)
            x, a = pp.tail(i, x + y, cfg, enc_out)
            if a is not None:
                aux = aux + a
        return x, aux


class EncoderLayer(nn.Module):
    """One encoder layer: ``ln_a``, ``attn`` (non-causal self-attention),
    ``ln_m``, ``mlp`` (dense SwiGLU)."""

    def __init__(self, cfg: ModelConfig, device=None, param_dtype=None):
        super().__init__()
        dt = param_dtype or _dtype(cfg)
        self.attn = Attention(cfg, device, dt)
        self.ln_a = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)
        self.ln_m = RMSNorm(cfg.d_model, cfg.norm_eps, device)


class LM(nn.Module):
    """Parameters of an LM of any family: ``embed`` (V, D) unless the
    frontend is ``"embed"``, ``layers`` (one :class:`Period` per period),
    ``encoder`` (one :class:`EncoderLayer` per encoder layer) and
    ``enc_norm`` when the config has an encoder, ``final_norm``, and
    ``lm_head`` (V, D) unless the embeddings are tied. Projections and
    embeddings are stored in ``param_dtype`` (default ``cfg.dtype``)."""

    def __init__(self, cfg: ModelConfig, device="cuda", param_dtype=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve(device)
        dt = param_dtype or _dtype(cfg)
        self.cfg = cfg
        if cfg.frontend != "embed":
            self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, dtype=dt, device=dev),
                                      requires_grad=False)
        self.layers = nn.ModuleList(Period(cfg, dev, dt) for _ in range(cfg.n_periods))
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(EncoderLayer(cfg, dev, dt)
                                         for _ in range(cfg.encoder_layers))
            self.enc_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty(cfg.vocab, cfg.d_model, dtype=dt, device=dev),
                requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


def _trunc_normal_(p: torch.Tensor, scale: float, gen: torch.Generator,
                   slice_elems: int = INIT_SLICE_ELEMS) -> None:
    """``truncated_normal(-2, 2) * scale`` drawn in float32 and cast to p's
    dtype, in slices along the first axis of at most ``slice_elems``
    elements (at least one row), so no temporary holds the whole tensor in
    float32. The draws follow one another from ``gen``."""
    rows = max(1, slice_elems // max(1, p[0].numel())) if p.dim() else 1
    flat = p.view(1, *p.shape) if p.dim() == 0 else p
    for r in range(0, flat.shape[0], rows):
        part = flat[r:r + rows]
        w = torch.empty(part.shape, dtype=torch.float32, device=p.device)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(w * scale)


def _init_attention(attn: Attention, cfg: ModelConfig, normal_) -> None:
    for w in (attn.wq, attn.wk, attn.wv):
        normal_(w, 1.0 / math.sqrt(cfg.d_model))
    normal_(attn.wo, 1.0 / math.sqrt(cfg.n_heads))


def _init_mlp(mlp: MLP, d: int, ff: int, normal_) -> None:
    normal_(mlp.wi, 1.0 / math.sqrt(d))
    normal_(mlp.wg, 1.0 / math.sqrt(d))
    normal_(mlp.wo, 1.0 / math.sqrt(ff))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda", param_dtype=None) -> LM:
    """An :class:`LM` on ``device`` with the JAX package's init
    distributions: truncated normal (+-2 sd) scaled by ``1/sqrt(fan)``,
    where ``fan`` is the first axis of the JAX weight shape (``D`` for
    q/k/v, the MLP inputs and the Mamba input projection, ``H`` for the
    attention output, ``ff`` for the MLP outputs, ``DI`` inside the SSM and
    mLSTM blocks, ``E`` for the expert stacks), ``0.02`` for the
    embeddings, the head, the
    router and the mLSTM gates, ``0.5`` for the Mamba conv and ``0.3 /
    sqrt(hd)`` for the sLSTM recurrence; zero biases, unit norm scales, and
    the SSM and xLSTM gate constants as JAX sets them. ``generator`` (on
    ``device``; default seed 0) makes it reproducible; the draws differ
    from JAX's PRNG (the tests carry JAX parameters across with
    ``interop.params_from_jax``). ``param_dtype`` as for :class:`LM`."""
    model = LM(cfg, device, param_dtype)
    gen = generator or torch.Generator(device=model.device).manual_seed(0)
    normal_ = functools.partial(_trunc_normal_, gen=gen)
    D = cfg.d_model
    if cfg.frontend != "embed":
        normal_(model.embed, 0.02)
    for period in model.layers:
        for i, kind in enumerate(period.kinds):
            b = period.sub("b", i)
            if kind == "attn":
                _init_attention(b, cfg, normal_)
            elif kind == "mamba":
                S.init_mamba_(b, cfg, normal_, gen)
            elif kind == "mlstm":
                X.init_mlstm_(b, cfg, normal_)
            else:
                X.init_slstm_(b, cfg, normal_)
            if _cross(cfg, kind):
                _init_attention(period.sub("x", i), cfg, normal_)
            mk = _mlp_kind(cfg, i)
            if mk == "dense":
                _init_mlp(period.sub("m", i), D, cfg.d_ff, normal_)
            elif mk == "moe":
                m, Fe = period.sub("m", i), cfg.expert_ff
                normal_(m.router, 0.02)
                normal_(m.wi, 1.0 / math.sqrt(m.wi.shape[0]))
                normal_(m.wg, 1.0 / math.sqrt(m.wg.shape[0]))
                normal_(m.wo, 1.0 / math.sqrt(m.wo.shape[0]))
                if cfg.n_shared_experts:
                    _init_mlp(m.shared, D, Fe * cfg.n_shared_experts, normal_)
    for layer in getattr(model, "encoder", ()):
        _init_attention(layer.attn, cfg, normal_)
        _init_mlp(layer.mlp, D, cfg.d_ff, normal_)
    if not cfg.tie_embeddings:
        normal_(model.lm_head, 0.02)
    return model


def init_cache(cfg: ModelConfig, B: int, max_seq: int, device="cuda") -> dict:
    """Zero decode cache in the JAX layout (see the module docstring),
    every leaf stacked over the periods."""
    check_supported(cfg)
    dev = resolve(device)
    P, dt = cfg.n_periods, _dtype(cfg)
    cache = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "attn":
            shape = (P, B, max_seq, cfg.n_kv_heads, cfg.hd)
            cache[f"b{i}"] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                              "v": torch.zeros(shape, dtype=dt, device=dev),
                              "len": torch.zeros(P, dtype=torch.int32, device=dev)}
        elif kind == "mamba":
            cache[f"b{i}"] = S.mamba_init_cache(cfg, B, dt, dev, periods=P)
        elif kind == "mlstm":
            cache[f"b{i}"] = X.mlstm_init_cache(cfg, B, dt, dev, periods=P)
        else:
            cache[f"b{i}"] = X.slstm_init_cache(cfg, B, dt, dev, periods=P)
    return cache


def _embed_in(params: LM, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The input embeddings in the model dtype: ``batch["embeds"]`` under
    the embed frontend, else the token table cast, then gathered, as JAX's
    ``embed.astype(dtype)[tok]`` (so the gradient of the gather accumulates
    in the model dtype there and here)."""
    if cfg.frontend == "embed":
        x = to_device(batch["embeds"], params.device).to(_dtype(cfg))
        return place_batch(params, x, "embeds")
    tok = place_batch(params, to_device(batch["tokens"], params.device).long(), "tokens")
    return L.embedding_table(params.embed).to(_dtype(cfg))[tok]


def _pick(lg: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``lg[..., idx]`` elementwise (``take_along_dim`` on the last dim);
    over DTensors by each rank's own rows (``dist.local.local_pick``)."""
    if isinstance(lg, DTensor):
        return L.local_pick(lg, idx)
    return torch.take_along_dim(lg, idx[..., None], dim=-1)[..., 0]


def _head(params: LM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = params.final_norm(x)
    # a tied head keeps the embed rule (vocab over tp, D gathered); the
    # port's head weight is (V, D) either way, so no transpose
    name = "embed" if cfg.tie_embeddings else "lm_head"
    w = H.gather_params({name: getattr(params, name)})[name]
    return F.linear(x, w.to(x.dtype))


def encode(params: LM, cfg: ModelConfig, frames) -> torch.Tensor:
    """The bidirectional encoder over frame embeddings (B, S_enc, D):
    non-causal self-attention with RoPE at the encoder's positions (through
    ``cfg.attn_impl``), dense MLPs, ``enc_norm`` (JAX ``encode``)."""
    x = place_batch(params, to_device(frames, params.device).to(_dtype(cfg)), "frames")
    B, Senc, _ = x.shape
    pos = place_batch(params, torch.arange(Senc, device=x.device)[None].expand(B, Senc),
                      "frames")
    for layer in params.encoder:
        layer = H.gather_params(layer)
        x = x + layer.attn(layer.ln_a(x), pos, causal=False, attn_impl=cfg.attn_impl)
        x = x + layer.mlp(layer.ln_m(x))
    return params.enc_norm(x)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs of
    the matmuls without batch dims (the projections), recompute the rest;
    JAX's ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _under(hints, fn):
    """``fn`` run under ``hints``: a remat period recomputed in the backward,
    after the forward's ``sharding_hints`` block has closed, redistributes
    as its forward did (JAX reads the hints once, when it traces)."""
    if hints is None:
        return fn

    def call(*args):
        with H.sharding_hints(hints):
            return fn(*args)

    return call


def forward(params: LM, cfg: ModelConfig, batch: dict, remat: str = "none"):
    """Full-sequence logits (B, S, V) in the model dtype, and the auxiliary
    loss (float32: the MoE load-balance losses summed over layers and
    periods, zero without MoE). ``remat``: ``"none"``, ``"full"``
    (recompute each period in the backward) or ``"dots"`` (recompute all but
    the projections' outputs); the values do not depend on it."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")
    x = _embed_in(params, cfg, batch)
    B, Sq, _ = x.shape
    pos = place_batch(params, torch.arange(Sq, device=x.device)[None].expand(B, Sq), "tokens")
    enc_out = encode(params, cfg, batch["frames"]) if cfg.encoder_layers else None
    ctx = {}
    if remat == "dots":
        ctx = dict(context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                _save_dots))
    aux = _zero(x)
    for period in params.layers:
        if remat == "none" or not torch.is_grad_enabled():
            x, a = period(x, pos, cfg, enc_out)
        else:
            x, a = checkpoint(_under(H.current_hints(), period), x, pos, cfg, enc_out,
                              use_reentrant=False, **ctx)
        aux = aux + a
    return _head(params, cfg, x), aux


def loss_fn(params: LM, cfg: ModelConfig, batch: dict, remat: str = "none"):
    """Next-token NLL over positions whose label is ``>= 0``, in float32,
    plus ``0.01 * aux``; returns ``(loss, {"nll", "aux"})`` as JAX's
    ``loss_fn``."""
    logits, aux = forward(params, cfg, batch, remat)
    labels = place_batch(params, to_device(batch["labels"], logits.device).long(), "labels")
    lg = logits[:, :-1].to(torch.float32)
    tg = labels[:, 1:]
    lse = torch.logsumexp(lg, dim=-1)
    # masked labels (< 0) pick entry 0 here (JAX wraps them); either way the
    # mask zeroes the term
    picked = _pick(lg, tg.clamp(min=0))
    mask = (tg >= 0).to(torch.float32)
    nll = torch.sum((lse - picked) * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


def _put(c: dict, p: int, state: dict) -> None:
    """Write one period's new recurrent state into the stacked cache: a
    DTensor state into a DTensor cache's local shard at the cache's
    placements, into a plain cache whole."""
    for name, t in state.items():
        dst = c[name][p]
        if isinstance(t, DTensor):
            if isinstance(dst, DTensor):
                dst, t = dst.to_local(), t.redistribute(dst.device_mesh, dst.placements).to_local()
            else:
                t = t.full_tensor()
        dst.copy_(t)


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, batch: dict, max_seq: int):
    """Run the prompt (``batch["tokens"]`` (B, S), or ``batch["embeds"]``
    under the embed frontend, and ``batch["frames"]`` for an encoder);
    return (last-position logits (B, V), a fresh decode cache holding the
    prompt's keys and values and each recurrent block's state after the
    prompt, the encoder output or ``None``). A distributed model returns
    a plain (whole) cache; ``dist.sharding.distribute_cache`` places it."""
    x = _embed_in(params, cfg, batch)
    B, Sq, _ = x.shape
    if Sq > max_seq:
        raise ValueError(f"prompt of {Sq} tokens exceeds max_seq={max_seq}")
    pos = place_batch(params, torch.arange(Sq, device=x.device)[None].expand(B, Sq), "tokens")
    keep = causal_keep(Sq, Sq, x.device) if cfg.causal else None
    enc_out = encode(params, cfg, batch["frames"]) if cfg.encoder_layers else None
    cache = init_cache(cfg, B, max_seq, x.device)
    for p, period in enumerate(params.layers):
        period = H.gather_params(period)
        for i, kind in enumerate(period.kinds):
            b, c = period.sub("b", i), cache[f"b{i}"]
            h = period.sub("ln_b", i)(x)
            if kind == "attn":
                q, k, v = b.qkv(h, pos)
                y = b.out(attend(lambda q, k, v: _sdpa(q, k, v, keep), q, k, v))
                c["k"][p, :, :Sq] = L.whole(k)
                c["v"][p, :, :Sq] = L.whole(v)
                c["len"][p] = Sq
            else:
                y, state = _PREFILL[kind](b, cfg, h)
                _put(c, p, state)
            x, _ = period.tail(i, x + y, cfg, enc_out)
    return _head(params, cfg, x[:, -1:])[:, 0], cache, enc_out


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, cache: dict, token, pos, enc_out=None):
    """token (B,) (or embeddings (B, 1, D) under the embed frontend), pos
    (B,) -> (logits (B, V), cache). Row ``b`` of an attention block writes
    its key and value at ``pos[b]`` (in place) and attends to
    ``0..pos[b]``; recurrent blocks step their state (in place);
    cross-attention reads ``enc_out`` (the encoder output of ``prefill``).
    With a distributed model the cache may be placed by
    ``dist.sharding.distribute_cache``: each rank writes its own shard."""
    dev = params.device
    token = to_device(token, dev)
    pos = to_device(pos, dev).long()
    if cfg.frontend == "embed" and token.dim() == 3:
        x = place_batch(params, token.to(_dtype(cfg)), "embeds")
    else:
        x = _embed_in(params, cfg, {"tokens": token.long()[:, None]})
    for p, period in enumerate(params.layers):
        period = H.gather_params(period)
        for i, kind in enumerate(period.kinds):
            b, c = period.sub("b", i), cache[f"b{i}"]
            h = period.sub("ln_b", i)(x)
            if kind == "attn":
                y = b.decode(h, c["k"][p], c["v"][p], pos)
            else:
                y, state = _DECODE[kind](b, cfg, h, {n: t[p] for n, t in c.items()})
                _put(c, p, state)
            x, _ = period.tail(i, x + y, cfg, enc_out)
    for c in cache.values():
        if "len" in c:
            c["len"] += 1
    return _head(params, cfg, x)[:, 0], cache
