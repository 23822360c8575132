"""Carry state across from the JAX package, through plain numpy.

The JAX side (``repro.core.forest_to_numpy``, ``QmcStreams.snapshot()``,
``ForestPool.snapshot()``, the samplers' and the engine's ``snapshot()``,
model parameters and caches as numpy pytrees) produces numpy dicts and
lists; these functions turn them into the port's objects, so
``repro_torch`` itself never imports ``repro``. The samplers, streams and
the engine take such dicts directly in their own ``restore``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.forest import RadixForest
from repro_torch.device import resolve, to_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import DenseLM, init_cache
from repro_torch.pool.arena import ForestPool, Handle

_FIELDS = {
    "cdf": torch.float32,
    "table": torch.int32,
    "left": torch.int32,
    "right": torch.int32,
    "cell_first": torch.int32,
    "fallback": torch.bool,
}


def forest_from_numpy(d: dict, device="cuda") -> RadixForest:
    """The dict of ``forest_to_numpy`` -> a port :class:`RadixForest` on
    ``device`` (same field names, dtypes and values)."""
    return RadixForest(**{
        k: to_device(np.ascontiguousarray(d[k]), device, dtype)
        for k, dtype in _FIELDS.items()
    })


def pool_from_snapshot(state: dict, device="cuda") -> ForestPool:
    """A ``ForestPool.snapshot()`` dict (of either package, as is) -> a port
    :class:`ForestPool` on ``device`` whose drains equal the source's."""
    return ForestPool.restore(state, device=device)


def handle_from_numpy(h) -> Handle:
    """A JAX ``Handle`` (a 5-field tuple: size class, row, n, version,
    method) -> the port's :class:`Handle`."""
    size_class, row, n, version, method = h
    return Handle(int(size_class), int(row), int(n), int(version), str(method))


@torch.no_grad()
def params_from_jax(params_np: dict, cfg: ModelConfig, device="cuda") -> DenseLM:
    """A JAX ``init_params`` pytree with numpy leaves (stacked over periods:
    ``layers.b{i}.wq`` (P, D, H, hd), ``bq`` (P, H, hd), ``wo`` (P, H, hd,
    D), ``ln_b{i}.scale`` (P, D), ``m{i}.{wi,wg,wo}``, ``embed``,
    ``final_norm``, and ``lm_head`` (D, V) when untied) -> the port's
    :class:`DenseLM` on ``device``, weights transposed to ``(out, in)`` and
    cast to the model dtype, norm scales kept in float32."""
    model = DenseLM(cfg, device)

    def put(dst: torch.Tensor, a) -> None:  # copy_ casts to dst's dtype
        dst.copy_(torch.from_numpy(np.array(a, np.float32)))

    put(model.embed, params_np["embed"])
    put(model.final_norm.scale, params_np["final_norm"]["scale"])
    if not cfg.tie_embeddings:
        put(model.lm_head, np.asarray(params_np["lm_head"]).T)
    L = params_np["layers"]
    for p, period in enumerate(model.layers):
        for i in range(period.n):
            ln_b, attn, ln_m, mlp = period.block(i)
            a, m = L[f"b{i}"], L[f"m{i}"]
            put(ln_b.scale, L[f"ln_b{i}"]["scale"][p])
            put(ln_m.scale, L[f"ln_m{i}"]["scale"][p])
            for name in ("wq", "wk", "wv"):
                w = np.asarray(a[name][p])                      # (D, heads, hd)
                put(getattr(attn, name), w.reshape(w.shape[0], -1).T)
            wo = np.asarray(a["wo"][p])                         # (H, hd, D)
            put(attn.wo, wo.reshape(-1, wo.shape[-1]).T)
            if cfg.qkv_bias:
                for name in ("bq", "bk", "bv"):
                    put(getattr(attn, name), np.asarray(a[name][p]).reshape(-1))
            if cfg.qk_norm:
                put(attn.q_norm.scale, a["q_norm"]["scale"][p])
                put(attn.k_norm.scale, a["k_norm"]["scale"][p])
            for name in ("wi", "wg", "wo"):
                put(getattr(mlp, name), np.asarray(m[name][p]).T)
    return model


def cache_leaf_order(cache: dict):
    """``(block key, leaf name)`` pairs in the order ``jax.tree_util.
    tree_leaves`` walks a cache: sorted block keys, then ``k``, ``len``,
    ``v``."""
    return [(b, leaf) for b in sorted(cache) for leaf in sorted(cache[b])]


def cache_from_jax(leaves, cfg: ModelConfig, B: int, max_seq: int, device="cuda") -> dict:
    """A decode cache from its leaves in ``tree_leaves`` order (as a JAX
    engine snapshot stores them, or :func:`cache_to_leaves`): ``k``/``v``
    cast to the model dtype, ``len`` int32."""
    cache = init_cache(cfg, B, max_seq, resolve(device))
    order = cache_leaf_order(cache)
    if len(leaves) != len(order):
        raise ValueError(f"cache has {len(order)} leaves, got {len(leaves)}")
    for (b, leaf), a in zip(order, leaves):
        dst = cache[b][leaf]
        src = np.array(a, np.int32 if leaf == "len" else np.float32)
        if src.shape != tuple(dst.shape):
            raise ValueError(f"cache leaf {b}.{leaf}: shape {src.shape}, want {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(src))
    return cache


def cache_to_leaves(cache: dict) -> list:
    """The cache's leaves in ``tree_leaves`` order as numpy (``k``/``v`` as
    float32, which holds bfloat16 values exactly; ``len`` int32)."""
    return [cache[b][leaf].cpu().to(torch.int32 if leaf == "len" else torch.float32).numpy()
            for b, leaf in cache_leaf_order(cache)]
