"""The JAX package's parameter layout, and the map between it and the
port's parameter names.

JAX keeps a model's parameters as one pytree: per-period leaves stacked
over the periods under ``layers`` (and the encoder's over its layers under
``encoder``), weights ``(in, out)``, q/k/v ``(D, heads, hd)``, biases
``(heads, hd)``, expert stacks ``(E, D, F)``/``(E, F, D)``. The port keeps
an :class:`~repro_torch.models.model.LM` whose ``named_parameters()`` are
unstacked and ``(out, in)`` (expert stacks and the sLSTM recurrence as in
JAX). The maps below work leaf by leaf on numpy arrays or tensors alike
and keep their dtype (bfloat16 included), so the same code serves the
interop helpers, which carry parameters across through numpy, and the
trainer, which writes and reads JAX's checkpoint layout.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig


def _attention(pre: tuple, name: str, cfg: ModelConfig):
    """Leaves of one attention block (self- or cross-attention) at JAX path
    ``pre`` and port name ``name``."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    heads = {"q": H, "k": KV, "v": KV}
    out = [(pre + (f"w{x}",), f"{name}.w{x}", "in", (D, n, hd)) for x, n in heads.items()]
    out.append((pre + ("wo",), f"{name}.wo", "out", (H, hd, D)))
    if cfg.qkv_bias:
        out += [(pre + (f"b{x}",), f"{name}.b{x}", "flat", (n, hd)) for x, n in heads.items()]
    if cfg.qk_norm:
        out += [(pre + (f"{x}_norm", "scale"), f"{name}.{x}_norm.scale", "same", (hd,))
                for x in ("q", "k")]
    return out


def _mlp(pre: tuple, name: str, d: int, ff: int):
    return [(pre + ("wi",), f"{name}.wi", "in", (d, ff)),
            (pre + ("wg",), f"{name}.wg", "in", (d, ff)),
            (pre + ("wo",), f"{name}.wo", "out", (ff, d))]


def _norm(pre: tuple, name: str, d: int):
    return [(pre + ("scale",), f"{name}.scale", "same", (d,))]


def _block(pre: tuple, name: str, kind: str, cfg: ModelConfig):
    """Leaves of one sequence block of ``kind``."""
    D, H = cfg.d_model, cfg.n_heads
    if kind == "attn":
        return _attention(pre, name, cfg)
    if kind == "mamba":
        DI, N = cfg.ssm_expand * D, cfg.ssm_state
        shapes = {"in_proj": ("in", (D, 2 * DI)), "conv": ("same", (cfg.ssm_conv, DI)),
                  "x_proj": ("in", (DI, 2 * N + 1)), "dt_bias": ("same", (DI,)),
                  "a_log": ("same", (DI, N)), "d_skip": ("same", (DI,)),
                  "out_proj": ("in", (DI, D))}
    elif kind == "mlstm":
        DI = 2 * D
        shapes = {"up": ("in", (D, 2 * DI)), "wq": ("in", (DI, DI)), "wk": ("in", (DI, DI)),
                  "wv": ("in", (DI, DI)), "wif": ("in", (DI, 2 * H)),
                  "if_bias": ("same", (2 * H,)), "down": ("in", (DI, D))}
    else:
        hd = D // H
        shapes = {"wx": ("in", (D, 4 * D)), "r": ("same", (H, hd, 4 * hd)),
                  "bias": ("same", (4 * D,)), "down": ("in", (D, D))}
    return [(pre + (k,), f"{name}.{k}", kind_, shape) for k, (kind_, shape) in shapes.items()]


def _moe(pre: tuple, name: str, cfg: ModelConfig):
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.expert_ff
    out = [(pre + ("router",), f"{name}.router", "in", (D, E)),
           (pre + ("wi",), f"{name}.wi", "same", (E, D, Fe)),
           (pre + ("wg",), f"{name}.wg", "same", (E, D, Fe)),
           (pre + ("wo",), f"{name}.wo", "same", (E, Fe, D))]
    if cfg.n_shared_experts:
        out += _mlp(pre + ("shared",), f"{name}.shared", D, Fe * cfg.n_shared_experts)
    return out


def leaf_map(cfg: ModelConfig):
    """``(JAX path, port name, kind, JAX shape)`` of every parameter leaf of
    every family. Leaves stacked over a leading axis in JAX (under
    ``layers``, over the periods; under ``encoder``, over the encoder
    layers) have a port name holding ``{p}``, filled with the index, and
    their shape is one slice's. ``kind`` says how a JAX leaf becomes the
    port's tensor: ``"in"`` (in, *out) -> (prod(out), in); ``"out"`` (*in,
    D) -> (D, prod(in)); ``"flat"`` -> 1-D; ``"same"`` unchanged."""
    D, V = cfg.d_model, cfg.vocab
    out = []
    if cfg.frontend != "embed":
        out.append((("embed",), "embed", "same", (V, D)))
    out += _norm(("final_norm",), "final_norm", D)
    if not cfg.tie_embeddings:
        out.append((("lm_head",), "lm_head", "in", (D, V)))
    for i, kind in enumerate(cfg.block_pattern):
        pre, name = ("layers",), "layers.{p}"
        out += _block(pre + (f"b{i}",), f"{name}.b{i}", kind, cfg)
        out += _norm(pre + (f"ln_b{i}",), f"{name}.ln_b{i}", D)
        if cfg.cross_attention and kind == "attn":
            out += _attention(pre + (f"x{i}",), f"{name}.x{i}", cfg)
            out += _norm(pre + (f"ln_x{i}",), f"{name}.ln_x{i}", D)
        mk = cfg.mlp_pattern[i % len(cfg.mlp_pattern)]
        if mk != "none":
            out += (_mlp(pre + (f"m{i}",), f"{name}.m{i}", D, cfg.d_ff) if mk == "dense"
                    else _moe(pre + (f"m{i}",), f"{name}.m{i}", cfg))
            out += _norm(pre + (f"ln_m{i}",), f"{name}.ln_m{i}", D)
    if cfg.encoder_layers:
        pre, name = ("encoder",), "encoder.{p}"
        out += _attention(pre + ("attn",), f"{name}.attn", cfg)
        out += _mlp(pre + ("mlp",), f"{name}.mlp", D, cfg.d_ff)
        out += _norm(pre + ("ln_a",), f"{name}.ln_a", D)
        out += _norm(pre + ("ln_m",), f"{name}.ln_m", D)
        out += _norm(("enc_norm",), "enc_norm", D)
    return out


def stacked(cfg: ModelConfig, path: tuple) -> int | None:
    """How many slices a JAX leaf at ``path`` stacks, or None."""
    return {"layers": cfg.n_periods, "encoder": cfg.encoder_layers}.get(path[0])


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
        n = stacked(cfg, path)
        if n is None:
            out[name] = _to_port(a, kind)
            continue
        for p in range(n):
            out[name.format(p=p)] = _to_port(a[p], kind)
    return out


def named_to_jax(named: dict, cfg: ModelConfig) -> dict:
    """The inverse of :func:`named_from_jax`: ``{port parameter name:
    leaf}`` (numpy arrays or tensors) -> the JAX pytree layout, per-period
    and encoder leaves stacked, dtypes kept. Tensors stay on their
    device."""
    tree: dict = {}

    def put(path, a):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a

    for path, name, kind, shape in leaf_map(cfg):
        n = stacked(cfg, path)
        if n is None:
            put(path, _to_jax(named[name], kind, shape))
            continue
        parts = [_to_jax(named[name.format(p=p)], kind, shape) for p in range(n)]
        put(path, torch.stack(parts) if isinstance(parts[0], torch.Tensor) else np.stack(parts))
    return tree
