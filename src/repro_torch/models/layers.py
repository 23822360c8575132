"""Transformer layers of the LM: RMSNorm, RoPE, GQA attention with a
per-row KV cache, cross-attention over an encoder's output, SwiGLU MLP.

Each layer keeps the arithmetic of the JAX package's ``models/layers.py``:
RMSNorm in float32 and cast back, half-split (not interleaved) RoPE in
float32, attention logits cast to float32 and divided by ``sqrt(hd)``,
``-1e30`` masking and a float32 softmax, cast back before the value product.
Projections and biases are stored in a parameter dtype, by default the
model's compute dtype (serving); ``param_dtype=torch.float32`` keeps float32
masters, as the JAX package does for training. Either way each layer casts
a weight to the activations' dtype at use (``w.to(x.dtype)``, a no-op when
they agree), as JAX's ``.astype(x.dtype)``. Norm scales stay float32.
Weights are stored as ``(out, in)`` for ``F.linear``;
``repro_torch.interop.params_from_jax`` transposes the JAX layout.
Parameters are created with ``requires_grad=False``; a trainer turns them
on with ``requires_grad_()``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.dist.local import (
    NEG_INF,
    local_attention,
    local_decode_attention,
    replicate,
    split_heads,
)
from repro_torch.kernels import ops

from .config import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _weight(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device),
                        requires_grad=False)


def _zeros(n: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=dtype, device=device), requires_grad=False)


def _f32(t: torch.Tensor) -> nn.Parameter:
    """A float32 parameter holding ``t``: the leaves the JAX package uses in
    float32 whatever the model dtype (norm scales, the router, the SSM and
    xLSTM gate constants)."""
    return nn.Parameter(t.to(torch.float32), requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x.to(torch.float32)
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return ((x * torch.rsqrt(var + self.eps)) * self.scale).to(dt)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S) -> x rotated, half-split: the first
    and second halves of ``hd`` are the two coordinates of each pair."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    if isinstance(positions, DTensor):   # a distributed model's positions
        freqs = replicate(freqs, positions.device_mesh)
    ang = positions[..., None].to(torch.float32) * freqs          # (B, S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def causal_keep(Sq: int, Sk: int, device=None) -> torch.Tensor:
    """(Sq, Sk) mask of the keys each query position may attend to."""
    return (torch.arange(Sk, device=device)[None, :]
            <= torch.arange(Sq, device=device)[:, None])


def _sdpa(q, k, v, keep: torch.Tensor | None = None):
    """Materialized attention. q (B, Sq, H, hd), k/v (B, Sk, KV, hd); GQA
    by head-group reshape (query head ``h`` reads key head ``h // G``).
    ``keep`` broadcasts against the (B, KV, G, Sq, Sk) logits; masked
    logits are set to ``-1e30`` before the float32 softmax."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)       # (B, KV, G, Sq, hd)
    kt = k.permute(0, 2, 3, 1)[:, :, None]                       # (B, KV, 1, hd, Sk)
    logits = torch.matmul(qg, kt).to(torch.float32) / math.sqrt(hd)
    if keep is not None:
        logits = torch.where(keep, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(w, v.permute(0, 2, 1, 3)[:, :, None])      # (B, KV, G, Sq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def attend(core, q, k, v):
    """``core(q, k, v)``; for DTensors (a distributed model) by local
    shards (``dist.local.local_attention``: each rank its own rows and
    query heads, with the KV heads those heads read)."""
    if isinstance(q, DTensor):
        return local_attention(core, q, k, v)
    return core(q, k, v)


class Attention(nn.Module):
    """Self-attention with optional QKV bias and qk-norm; parameters in
    ``param_dtype`` (default: the model dtype)."""

    def __init__(self, cfg: ModelConfig, device=None, param_dtype=None):
        super().__init__()
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt = param_dtype or _dtype(cfg)
        self.cfg = cfg
        self.wq = _weight(H * hd, D, dtype=dt, device=device)
        self.wk = _weight(KV * hd, D, dtype=dt, device=device)
        self.wv = _weight(KV * hd, D, dtype=dt, device=device)
        self.wo = _weight(D, H * hd, dtype=dt, device=device)
        if cfg.qkv_bias:
            self.bq = _zeros(H * hd, dt, device)
            self.bk = _zeros(KV * hd, dt, device)
            self.bv = _zeros(KV * hd, dt, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.norm_eps, device)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, device)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x (B, S, D), positions (B, S) -> roped q (B, S, H, hd), roped k
        and v (B, S, KV, hd)."""
        cfg = self.cfg
        dt = x.dtype
        q = F.linear(x, self.wq.to(dt))
        k = F.linear(x, self.wk.to(dt))
        v = F.linear(x, self.wv.to(dt))
        if cfg.qkv_bias:
            q, k, v = q + self.bq.to(dt), k + self.bk.to(dt), v + self.bv.to(dt)
        q = split_heads(q, cfg.n_heads, cfg.hd)
        k = split_heads(k, cfg.n_kv_heads, cfg.hd)
        v = split_heads(v, cfg.n_kv_heads, cfg.hd)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta), v)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """(B, S, H, hd) attention output -> (B, S, D)."""
        return F.linear(o.flatten(2), self.wo.to(o.dtype))

    def forward(self, x: torch.Tensor, positions: torch.Tensor, causal: bool = True,
                attn_impl: str | None = None) -> torch.Tensor:
        """Full-sequence self-attention: x (B, S, D), positions (B, S) ->
        (B, S, D). ``attn_impl`` (default ``cfg.attn_impl``) picks the
        product: ``"einsum"`` the materialized ``_sdpa``, ``"flash"`` kernel
        B10 (``kernels.ops.flash_attention``), as JAX ``layers.attention``."""
        q, k, v = self.qkv(x, positions)
        if (attn_impl or self.cfg.attn_impl) == "flash":
            def core(q, k, v):
                return ops.flash_attention(q, k, v, causal=causal)
        else:
            keep = causal_keep(q.shape[1], k.shape[1], x.device) if causal else None

            def core(q, k, v):
                return _sdpa(q, k, v, keep)
        return self.out(attend(core, q, k, v))

    def decode(self, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
        """One-token decode with per-row positions: x (B, 1, D); ck/cv
        (B, S, KV, hd) cache views, written IN PLACE at ``(row, pos[row])``;
        pos (B,) int64. Row ``b`` attends to keys ``0..pos[b]``."""
        B = x.shape[0]
        if isinstance(x, DTensor):
            q, k, v = self.qkv(x, replicate(pos[:, None], x.device_mesh))
            return self.out(self._decode_local(q, k, v, ck, cv, pos))
        q, k, v = self.qkv(x, pos[:, None])
        rows = torch.arange(B, device=x.device)
        ck[rows, pos] = k[:, 0].to(ck.dtype)
        cv[rows, pos] = v[:, 0].to(cv.dtype)
        keep = torch.arange(ck.shape[1], device=x.device)[None] <= pos[:, None]
        return self.out(_sdpa(q, ck, cv, keep[:, None, None, None, :]))

    @staticmethod
    def _decode_local(q, k, v, ck, cv, pos):
        """The decode attention of a distributed model by local shards
        (``dist.local.local_decode_attention``); a plain cache is taken as
        replicated."""
        if not isinstance(ck, DTensor):
            ck, cv = replicate(ck, q.device_mesh), replicate(cv, q.device_mesh)

        def core(ql, kh, vh, pl):
            keep = torch.arange(kh.shape[1], device=ql.device)[None] <= pl[:, None]
            return _sdpa(ql, kh, vh, keep[:, None, None, None, :])

        return local_decode_attention(core, q, k, v, ck, cv, pos)


def encoder_kv(p: Attention, cfg: ModelConfig, enc_out: torch.Tensor):
    """Cross-attention keys and values of an encoder output (B, S_enc, D):
    ``k``/``v`` (B, S_enc, KV, hd), no bias and no RoPE, ``k`` qk-normed
    where the config says so (JAX ``layers.encoder_kv``)."""
    dt = enc_out.dtype
    k = split_heads(F.linear(enc_out, p.wk.to(dt)), cfg.n_kv_heads, cfg.hd)
    v = split_heads(F.linear(enc_out, p.wv.to(dt)), cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = p.k_norm(k)
    return k, v


def cross_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor, enc_kv) -> torch.Tensor:
    """Non-causal attention of x (B, S, D) over ``encoder_kv``'s keys and
    values: q without bias or RoPE (qk-normed where the config says so),
    the materialized ``_sdpa`` as JAX ``layers.cross_attention``."""
    q = split_heads(F.linear(x, p.wq.to(x.dtype)), cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = p.q_norm(q)
    k, v = enc_kv
    return p.out(attend(_sdpa, q, k.to(x.dtype), v.to(x.dtype)))


class MLP(nn.Module):
    """SwiGLU: ``wo(silu(wg x) * wi x)``; weights stored in ``dtype``."""

    def __init__(self, d: int, ff: int, dtype, device=None):
        super().__init__()
        self.wi = _weight(ff, d, dtype=dtype, device=device)
        self.wg = _weight(ff, d, dtype=dtype, device=device)
        self.wo = _weight(d, ff, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        h = F.linear(x, self.wi.to(dt))
        g = F.linear(x, self.wg.to(dt))
        return F.linear(F.silu(g) * h, self.wo.to(dt))

