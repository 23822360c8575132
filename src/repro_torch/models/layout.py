"""The JAX package's parameter layout, and the map between it and the
port's parameter names.

JAX keeps a model's parameters as one pytree: per-period leaves stacked
over the periods under ``layers``, weights ``(in, out)``, q/k/v ``(D,
heads, hd)``, biases ``(heads, hd)``. The port keeps a :class:`DenseLM`
whose ``named_parameters()`` are unstacked and ``(out, in)``. The maps
below work leaf by leaf on numpy arrays or tensors alike and keep their
dtype (bfloat16 included), so the same code serves the interop helpers,
which carry parameters across through numpy, and the trainer, which writes
and reads JAX's checkpoint layout.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig


def leaf_map(cfg: ModelConfig):
    """``(JAX path, port name, kind, JAX shape)`` of every parameter leaf.
    Per-period leaves (under ``layers``) are stacked over the periods in
    JAX: their port name holds ``{p}``, filled with each period, and the
    shape is one period's slice. ``kind`` says how a JAX leaf becomes the
    port's tensor: ``"in"`` (D, *out) -> (prod(out), D); ``"out"``
    (*in, D) -> (D, prod(in)); ``"flat"`` -> 1-D; ``"same"`` unchanged."""
    D, H, KV, hd, ff, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           cfg.d_ff, cfg.vocab)
    out = [(("embed",), "embed", "same", (V, D)),
           (("final_norm", "scale"), "final_norm.scale", "same", (D,))]
    if not cfg.tie_embeddings:
        out.append((("lm_head",), "lm_head", "in", (D, V)))
    for i in range(len(cfg.block_pattern)):
        b, m = f"b{i}", f"m{i}"
        heads = {"q": H, "k": KV, "v": KV}
        out += [(("layers", b, f"w{x}"), f"layers.{{p}}.{b}.w{x}", "in", (D, n, hd))
                for x, n in heads.items()]
        out.append((("layers", b, "wo"), f"layers.{{p}}.{b}.wo", "out", (H, hd, D)))
        if cfg.qkv_bias:
            out += [(("layers", b, f"b{x}"), f"layers.{{p}}.{b}.b{x}", "flat", (n, hd))
                    for x, n in heads.items()]
        if cfg.qk_norm:
            out += [(("layers", b, f"{x}_norm", "scale"), f"layers.{{p}}.{b}.{x}_norm.scale",
                     "same", (hd,)) for x in ("q", "k")]
        out += [(("layers", f"ln_{x}{i}", "scale"), f"layers.{{p}}.ln_{x}{i}.scale", "same",
                 (D,)) for x in ("b", "m")]
        out += [(("layers", m, "wi"), f"layers.{{p}}.{m}.wi", "in", (D, ff)),
                (("layers", m, "wg"), f"layers.{{p}}.{m}.wg", "in", (D, ff)),
                (("layers", m, "wo"), f"layers.{{p}}.{m}.wo", "out", (ff, D))]
    return out


def _to_port(a, kind: str):
    if kind == "in":
        return a.reshape(a.shape[0], -1).T
    if kind == "out":
        return a.reshape(-1, a.shape[-1]).T
    return a.reshape(-1) if kind == "flat" else a


def _to_jax(a, kind: str, shape):
    return (a.T if kind in ("in", "out") else a).reshape(shape)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def named_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """A JAX parameter pytree (or a tree of the same structure: gradients,
    ``m``, ``v``) with numpy or tensor leaves -> ``{port parameter name:
    leaf}`` in the port's layout (unstacked, ``(out, in)``), dtypes kept."""
    out = {}
    for path, name, kind, _shape in leaf_map(cfg):
        a = _get(tree, path)
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        if path[0] != "layers":
            out[name] = _to_port(a, kind)
            continue
        for p in range(cfg.n_periods):
            out[name.format(p=p)] = _to_port(a[p], kind)
    return out


def named_to_jax(named: dict, cfg: ModelConfig) -> dict:
    """The inverse of :func:`named_from_jax`: ``{port parameter name:
    leaf}`` (numpy arrays or tensors) -> the JAX pytree layout, per-period
    leaves stacked over the periods, dtypes kept. Tensors stay on their
    device."""
    tree: dict = {}

    def put(path, a):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a

    for path, name, kind, shape in leaf_map(cfg):
        if path[0] != "layers":
            put(path, _to_jax(named[name], kind, shape))
            continue
        parts = [_to_jax(named[name.format(p=p)], kind, shape) for p in range(cfg.n_periods)]
        put(path, torch.stack(parts) if isinstance(parts[0], torch.Tensor) else np.stack(parts))
    return tree
