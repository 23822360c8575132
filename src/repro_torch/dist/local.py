"""Attention over DTensors by local shards.

Kernel B10 (``kernels.flash_attention``) and the materialized attention
take plain tensors. Under a sharding policy the attention's inputs are
DTensors: q (B, S, H, hd) and k/v (B, S, KV, hd). :func:`local_attention`
runs the attention of each rank's own rows and query heads:

* q keeps a batch shard (``Shard(0)``) or a head shard (``Shard(2)``) on
  each mesh dim; anything else on q (a sequence shard from ``act_seq``, a
  partial sum) is gathered first, as GSPMD gathers the sequence before
  attention. k/v take q's batch shard and are otherwise replicated.
* Local query head ``h`` is global head ``h0 + h`` (``h0`` the rank's
  first head) and reads global KV head ``(h0 + h) // (H / KV)``. Where the
  local heads cover whole KV groups the KV heads are a slice (GQA kept),
  else one KV head is picked per query head. So a policy that shards q's
  heads but leaves k/v whole (KV heads that do not divide the TP size)
  reads the right KV head on every rank.
* The output is ``DTensor.from_local`` at q's placements. In the backward,
  k/v's gradients are partial sums over the head-sharded mesh dims.

:func:`local_decode_attention` is the decode step's form: the cache is a
DTensor sharded by batch and/or KV heads; the new key and value are
written IN PLACE into the rank's local shard at ``(row, pos[row])``, and
the rank attends its rows and heads over it. A sequence-sharded cache is
not covered (``NotImplementedError``).

The few DTensor helpers the model, the optimizer and the serve step share
live here too: :func:`whole`, :func:`replicate`, :func:`gather_dim`,
:func:`embedding_table` and :func:`local_pick`.
"""
from __future__ import annotations

import torch


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor on every rank (a partial
    sum is reduced); a plain tensor as is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def replicate(t: torch.Tensor, mesh):
    """Plain ``t`` (the same on every rank) as a DTensor replicated on
    every dim of ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def gather_dim(t, d: int):
    """DTensor ``t`` with dim ``d`` gathered (replicated on every mesh dim
    that shards it)."""
    from torch.distributed.tensor import Replicate, Shard

    pl = [Replicate() if p == Shard(d) else p for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


def embedding_table(emb: torch.Tensor) -> torch.Tensor:
    """The (V, D) table as DTensor's lookup takes it: its masked lookup
    takes the vocabulary sharded over one mesh dim, and over two it raises
    (torch 2.13), so then the vocabulary is gathered. A plain table as
    is."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(emb, DTensor) and sum(p == Shard(0) for p in emb.placements) > 1:
        return gather_dim(emb, 0)
    return emb


def local_pick(lg, idx):
    """``lg[..., idx]`` elementwise for DTensors ``lg`` (B, S, V) and
    ``idx`` (B, S): each rank picks from its own rows with the vocabulary
    whole (DTensor's own gather of a vocabulary-sharded tensor, a masked
    partial result, raises in torch 2.13)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = lg.device_mesh
    pl = [p if p in (Shard(0), Shard(1)) else Replicate() for p in lg.placements]
    lg, idx = lg.redistribute(mesh, pl), idx.redistribute(mesh, pl)
    out = torch.take_along_dim(lg.to_local(), idx.to_local()[..., None], dim=-1)[..., 0]
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=idx.shape,
                              stride=(idx.shape[1], 1))


def _shard_dim(p):
    from torch.distributed.tensor import Shard

    return p.dim if isinstance(p, Shard) else None


def _offsets(t):
    """The global offset of this rank's local shard of DTensor ``t``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    _, off = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return off


def _kv_heads(kl: torch.Tensor, h0: int, Hl: int, G: int, kv0: int = 0) -> torch.Tensor:
    """The KV heads local query heads ``h0..h0+Hl`` read (global KV head
    ``(h0 + h) // G``; ``kv0`` the local KV shard's first global head): a
    slice where the local heads cover whole groups, else one head per
    query head."""
    if h0 % G == 0 and Hl % G == 0:
        a = h0 // G - kv0
        return kl[:, :, a:a + Hl // G]
    idx = (torch.arange(h0, h0 + Hl, device=kl.device) // G) - kv0
    return kl.index_select(2, idx)


def _wrap(o: torch.Tensor, mesh, placements, shape):
    """The local output ``o`` as a DTensor of global ``shape`` (made
    contiguous, so its global strides are the contiguous ones)."""
    from torch.distributed.tensor import DTensor

    o = o.contiguous()
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(o, mesh, placements, run_check=False, shape=shape,
                              stride=tuple(stride))


def local_attention(core, q, k, v):
    """``core(q, k, v)`` (plain (B, S, heads, hd) tensors, GQA by ``h //
    (H / KV)``) over DTensors q, k, v by local shards (module docstring);
    returns a DTensor at q's (canonical) placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    qp = [p if _shard_dim(p) in (0, 2) else Replicate() for p in q.placements]
    kp = [Shard(0) if _shard_dim(p) == 0 else Replicate() for p in qp]
    kgrad = [Partial() if _shard_dim(p) == 2 else r for p, r in zip(qp, kp)]
    q = q.redistribute(mesh, qp)
    k = k.redistribute(mesh, kp)
    v = v.redistribute(mesh, kp)
    H, KV = q.shape[2], k.shape[2]
    h0 = _offsets(q)[2]
    ql = q.to_local()
    kl = _kv_heads(k.to_local(grad_placements=kgrad), h0, ql.shape[2], H // KV)
    vl = _kv_heads(v.to_local(grad_placements=kgrad), h0, ql.shape[2], H // KV)
    return _wrap(core(ql, kl, vl), mesh, qp, q.shape)


@torch.no_grad()
def local_decode_attention(core, q, k, v, ck, cv, pos: torch.Tensor):
    """One decode token over a DTensor cache view ck/cv (B, S, KV, hd):
    k/v (B, 1, KV, hd) are written in place into the local shard at
    ``(row, pos[row])``, then ``core(q_local, ck_local, cv_local,
    pos_local)`` runs the rank's rows and query heads. Returns a DTensor at
    q's placements."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = ck.device_mesh
    qp, kp = [], []
    for cp, p in zip(ck.placements, q.placements):
        d = _shard_dim(cp)
        if d == 1:
            raise NotImplementedError(
                "decode over a sequence-sharded KV cache is not ported (ROADMAP A5)")
        if d == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif d == 2:
            qp.append(Shard(2))
            kp.append(Shard(2))
        else:
            qp.append(Shard(2) if _shard_dim(p) == 2 else Replicate())
            kp.append(Replicate())
    q = q.redistribute(mesh, qp)
    k = k.redistribute(mesh, kp)
    v = v.redistribute(mesh, kp)
    H, KV = q.shape[2], ck.shape[2]
    b0, _, h0, _ = _offsets(q)
    cb0, _, kv0, _ = _offsets(ck)
    ql, ckl, cvl = q.to_local(), ck.to_local(), cv.to_local()
    if cb0 != b0 or ckl.shape[0] != ql.shape[0]:
        raise RuntimeError("decode: the query's rows and the cache's rows differ")
    pl = pos[b0:b0 + ql.shape[0]]
    rows = torch.arange(ql.shape[0], device=ql.device)
    ckl[rows, pl] = k.to_local()[:, 0].to(ckl.dtype)
    cvl[rows, pl] = v.to_local()[:, 0].to(cvl.dtype)
    kh = _kv_heads(ckl, h0, ql.shape[2], H // KV, kv0)
    vh = _kv_heads(cvl, h0, ql.shape[2], H // KV, kv0)
    return _wrap(core(ql, kh, vh, pl), mesh, qp, q.shape)
