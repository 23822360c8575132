"""GPipe microbatch pipeline over a process group: the port of the JAX
package's ``dist/pipeline.py``.

``gpipe(block, mesh, axis)`` turns a per-layer ``block(W, h) -> h`` into a
pipelined ``f(Ws, xs)`` where ``Ws`` stacks the L layer parameters on dim 0
and ``xs`` stacks M microbatches on dim 0. The mesh dim ``axis`` (size S)
carries the pipeline; its process group takes the place of JAX's mesh axis.
Stage ``s`` (the rank's coordinate on ``axis``) owns layers ``s*L/S ..
(s+1)*L/S`` (every rank passes the whole ``Ws``, as the JAX caller passes
one global array, and takes its own slice), microbatches stream through the
stages, and stage boundaries are one ring permute per tick.

Schedule (JAX's): T = M + S - 1 ticks; at tick ``t`` stage ``s`` runs
microbatch ``t - s`` through its local layers. Stage 0 ingests ``xs[t]``
and the last stage accumulates its output into slot ``t - (S - 1)``, both
selected with ``torch.where`` as JAX selects with ``jnp.where``, so every
stage's graph holds the same permutes and sums and the backward's
collectives pair up across the stages; a final sum over the group
replicates the result (only the last stage adds non-zeros, so the sum is
exact).

* **Matches sequential execution exactly**: every microbatch sees the same
  per-layer op sequence as a plain loop.
* **Differentiable**: the ring permute is an autograd function over
  ``batch_isend_irecv`` whose backward is the reverse permute; the final
  sum's backward hands each stage the (replicated) cotangent. The gradient
  of ``Ws`` on a rank holds its stage's layers (zeros elsewhere): summed
  over the group it is the sequential loop's gradient.

Mesh dims other than ``axis`` are not touched.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to group rank ``(r + shift) % S``; return what rank
    ``(r - shift) % S`` sent."""
    S, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + shift) % S), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % S), group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


class _Ring(torch.autograd.Function):
    """``ppermute`` over the ring ``i -> i + 1``; backward ``i -> i - 1``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _permute(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -1), None


class _SumReplicated(torch.autograd.Function):
    """``psum`` of a per-stage tensor into a result every stage holds; the
    cotangent of that replicated result is the same on every stage, so the
    backward passes it through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def gpipe(block, mesh, axis: str):
    """Build the pipelined callable. ``block(W, h) -> h`` must be shape
    preserving; ``Ws.shape[0]`` must be divisible by the size of mesh dim
    ``axis``."""
    group = mesh.get_group(axis)
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = dist.get_rank(group)

    def stage(ws, xs):
        M = xs.shape[0]
        first = torch.tensor(idx == 0, device=xs.device)
        last = torch.tensor(idx == S - 1, device=xs.device)

        def local(h):
            for W in ws:
                h = block(W, h)
            return h

        outs = [torch.zeros_like(xs[0]) for _ in range(M)]
        carry = torch.zeros_like(xs[0])
        for t in range(M + S - 1):
            inp = torch.where(first, xs[min(t, M - 1)], carry)
            y = local(inp)
            carry = _Ring.apply(y, group) if S > 1 else y
            j = t - (S - 1)
            if 0 <= j < M:   # the last stage finished microbatch j
                outs[j] = outs[j] + torch.where(last, y, torch.zeros_like(y))
        out = torch.stack(outs)
        return _SumReplicated.apply(out, group) if S > 1 else out

    def pipelined(Ws, xs):
        L = Ws.shape[0]
        if L % S != 0:
            raise ValueError(f"layers ({L}) must divide over pipeline axis ({S})")
        n = L // S
        return stage(Ws[idx * n:(idx + 1) * n], xs)

    return pipelined
