"""Carry state across from the JAX package, through plain numpy.

The JAX side (``repro.core.forest_to_numpy``, ``QmcStreams.snapshot()``,
``ForestPool.snapshot()``, the samplers' and the engine's ``snapshot()``,
model parameters and caches as numpy pytrees) produces numpy dicts and
lists; these functions turn them into the port's objects, so
``repro_torch`` itself never imports ``repro``. The samplers, streams and
the engine take such dicts directly in their own ``restore``. Model
parameters go both ways (``params_from_jax``, ``params_to_jax``; the
latter also takes gradients or AdamW moments keyed by parameter name), and
a JAX ``OptState`` comes across with ``opt_state_from_jax``.
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


def _leaf_map(cfg: ModelConfig):
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


def _to_port(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "in":
        return a.reshape(a.shape[0], -1).T
    if kind == "out":
        return a.reshape(-1, a.shape[-1]).T
    return a.reshape(-1) if kind == "flat" else a


def _to_jax(a: np.ndarray, kind: str, shape) -> np.ndarray:
    return (a.T if kind in ("in", "out") else a).reshape(shape)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def named_from_jax(tree_np: dict, cfg: ModelConfig) -> dict[str, np.ndarray]:
    """A JAX parameter pytree (or a tree of the same structure: gradients,
    ``m``, ``v``) with numpy leaves -> ``{port parameter name: array}`` in the
    port's layout (unstacked, ``(out, in)``), dtypes kept."""
    out = {}
    for path, name, kind, _shape in _leaf_map(cfg):
        a = np.asarray(_get(tree_np, path))
        if path[0] != "layers":
            out[name] = _to_port(a, kind)
            continue
        for p in range(cfg.n_periods):
            out[name.format(p=p)] = _to_port(a[p], kind)
    return out


def params_to_jax(params, cfg: ModelConfig | None = None) -> dict:
    """The inverse of :func:`named_from_jax`: a :class:`DenseLM` (or a
    ``{port parameter name: tensor}`` mapping such as its gradients or AdamW
    moments, with ``cfg``) -> the JAX pytree layout with numpy float32
    leaves: per-period leaves stacked over the periods, weights ``(in,
    out)``, q/k/v ``(D, heads, hd)``, biases ``(heads, hd)``."""
    cfg = cfg or params.cfg
    named = dict(params.named_parameters()) if isinstance(params, DenseLM) else params
    tree: dict = {}

    def put(path, a):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a

    def leaf(name, kind, shape):
        return _to_jax(named[name].detach().to(torch.float32).cpu().numpy(), kind, shape)

    for path, name, kind, shape in _leaf_map(cfg):
        if path[0] != "layers":
            put(path, leaf(name, kind, shape))
            continue
        put(path, np.stack([leaf(name.format(p=p), kind, shape)
                            for p in range(cfg.n_periods)]))
    return tree


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """numpy (float32, or ml_dtypes bfloat16 read as float32) -> tensor."""
    bf16 = str(np.asarray(a).dtype) == "bfloat16"
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(device=device, dtype=dtype or (torch.bfloat16 if bf16 else torch.float32))


@torch.no_grad()
def params_from_jax(params_np: dict, cfg: ModelConfig, device="cuda",
                    param_dtype=None) -> DenseLM:
    """A JAX ``init_params`` pytree with numpy leaves (stacked over periods:
    ``layers.b{i}.wq`` (P, D, H, hd), ``bq`` (P, H, hd), ``wo`` (P, H, hd,
    D), ``ln_b{i}.scale`` (P, D), ``m{i}.{wi,wg,wo}``, ``embed``,
    ``final_norm``, and ``lm_head`` (D, V) when untied) -> the port's
    :class:`DenseLM` on ``device``, weights transposed to ``(out, in)`` and
    stored in ``param_dtype`` (default the model dtype; ``torch.float32``
    keeps the JAX float32 masters exactly), norm scales in float32."""
    model = DenseLM(cfg, device, param_dtype)
    named = named_from_jax(params_np, cfg)
    for name, p in model.named_parameters():
        p.copy_(torch.from_numpy(np.array(named[name], np.float32)))  # casts to p's dtype
    return model


def opt_state_from_jax(opt_np, cfg: ModelConfig, device="cuda"):
    """A JAX ``OptState`` (``step``, ``m``, ``v``) with numpy leaves -> the
    port's :class:`~repro_torch.train.optimizer.OptState` on ``device``:
    ``m``/``v`` keyed by port parameter name, in the port's layout, in
    their JAX dtype (float32 or bfloat16)."""
    from repro_torch.train.optimizer import OptState

    dev = resolve(device)
    step, m, v = opt_np
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
        m={k: _tensor(np.ascontiguousarray(a), dev) for k, a in named_from_jax(m, cfg).items()},
        v={k: _tensor(np.ascontiguousarray(a), dev) for k, a in named_from_jax(v, cfg).items()})


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
