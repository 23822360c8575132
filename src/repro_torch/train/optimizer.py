"""AdamW with warmup and a cosine schedule, over a :class:`~repro_torch.models.LM`'s
parameters.

The arithmetic of the JAX package's ``train/optimizer.py``, in float32:
the global gradient norm over every leaf, clipping by ``grad_clip``, the
schedule and the bias corrections ``1 - b ** step`` in float32, moments
updated in float32 and stored in ``opt_dtype`` (``"bfloat16"`` halves
them), the parameter updated in float32 and stored back in its dtype. State
is keyed by parameter name (``model.named_parameters()``). The JAX function
returns new parameters and state; the port updates both IN PLACE (saving a
copy of the parameters and moments per step) and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    opt_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor   # () int32: updates applied so far
    m: dict              # parameter name -> first moment
    v: dict              # parameter name -> second moment


def _params(params) -> dict:
    """``{name: parameter}`` of a module, or the mapping as given."""
    return dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays parameter ``name``. The JAX optimizer decays the
    leaves of rank >= 2 (``p.ndim >= 2``), and its per-layer leaves are
    stacked over the periods (the encoder's over its layers), one axis more
    than the port's tensors under ``layers.`` and ``encoder.``: so there
    every per-layer leaf, norm scales and QKV biases included, is decayed,
    and of the top-level leaves only the norm scales (D,) are not. The rule
    reads the JAX leaf's rank, not the port tensor's (ROADMAP C8)."""
    jax_rank = p.dim() + 1 if name.startswith(("layers.", "encoder.")) else p.dim()
    return jax_rank >= 2


def schedule(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor), float32: linear warmup, then a
    cosine from ``lr`` down to ``min_lr_ratio * lr`` at ``total_steps``."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / float(max(c.warmup_steps, 1)), max=1.0)
    prog = torch.clamp((s - c.warmup_steps) / float(max(c.total_steps - c.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return c.lr * warm * (c.min_lr_ratio + (1 - c.min_lr_ratio) * cos)


def init_opt(c: AdamWConfig, params) -> OptState:
    """Zero moments in ``c.opt_dtype`` beside each parameter, step 0."""
    dt = torch.bfloat16 if c.opt_dtype == "bfloat16" else torch.float32
    ps = _params(params)
    dev = next(iter(ps.values())).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in ps.items()},
        v={k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in ps.items()})


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor (float32)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32))) for t in tensors))


@torch.no_grad()
def apply_updates(c: AdamWConfig, params, grads: dict, st: OptState):
    """One AdamW step on ``params`` (a module or ``{name: tensor}``) with
    ``grads`` (``{name: gradient}``); parameters and moments are updated in
    place. Returns ``(params, new state, {"grad_norm", "lr"})``."""
    ps = _params(params)
    gnorm = global_norm(grads[k] for k in ps)
    scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = st.step + 1
    lr = schedule(c, step)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(c.b1, dtype=torch.float32, device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(c.b2, dtype=torch.float32, device=sf.device), sf)
    f32 = torch.float32
    for name, p in ps.items():
        # The same products and sums in the same order as JAX's formula, so
        # the same bits; float32 state updates in place, which holds a
        # tensor's float32 temporaries to about two of its size (the
        # out-of-place form held six of an embedding table at once).
        m, v = st.m[name], st.v[name]
        g = grads[name].to(f32) * scale
        m32 = m.mul_(c.b1) if m.dtype == f32 else m.to(f32) * c.b1
        m32.add_(g * (1 - c.b1))
        v32 = v.mul_(c.b2) if v.dtype == f32 else v.to(f32) * c.b2
        v32.add_(g.mul_(g).mul_(1 - c.b2))
        del g
        u = (m32 / b1c).div_((v32 / b2c).sqrt_().add_(c.eps))
        if decays(name, p):
            u.add_(c.weight_decay * p.to(f32))
        if p.dtype == f32:
            p.sub_(lr * u)
        else:
            p.copy_(p.to(f32) - lr * u)
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
    return params, OptState(step, st.m, st.v), {"grad_norm": gnorm, "lr": lr}
