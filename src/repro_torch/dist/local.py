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
DTensor sharded by batch, KV heads and/or sequence; the new key and value
are written IN PLACE into the local shard that holds ``(row, pos[row])``,
and the rank attends its rows and heads over its positions. Along a mesh
dim that shards the sequence (JAX's 2-D decode preset) each rank brings
its query heads of the other dims together, attends its slice of the
positions, and the slices are merged by log-sum-exp: the largest logit
and the sum of the exponentials over the slices, then the weights,
rounded to the model dtype as ``_sdpa`` rounds them, times the values,
summed over the slices.

:class:`Split` is the local form of the recurrent blocks and the MoE
(``models.ssm``, ``models.xlstm``, ``models.moe``): a block's channels,
heads or experts split over the mesh dims its weight shards them on, its
rows over those where the input is batch-sharded; the block runs on plain
local tensors (scans and loops included, so no DTensor op runs a step)
and its output is a partial sum over the split dims.

The few DTensor helpers the model, the optimizer and the serve step share
live here too: :func:`whole`, :func:`replicate`, :func:`gather_dim`,
:func:`embedding_table` and :func:`local_pick`.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # the mask value of the JAX package


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


def _seq_sharded_attention(q, k, v, keep, groups) -> torch.Tensor:
    """Materialized attention of one token over keys sliced over
    ``groups`` by position: q (B, 1, H, hd), this rank's slice k/v (B, Sl,
    KV, hd) (GQA by ``h // (H / KV)``), keep (B, Sl). The softmax of the
    whole sequence as ``_sdpa`` takes it: float32 logits, their largest
    over the slices (a max all-reduce) and the sum of their exponentials
    (a sum all-reduce); the weights rounded to q's dtype, their product
    with the values summed over the slices in float32 (a sum all-reduce)
    and rounded once to q's dtype. A slice with no key kept has its
    logits at -1e30, so its weights are 0. Returns (B, 1, H, hd)."""
    import torch.distributed as dist

    B, _, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k).to(torch.float32) / math.sqrt(hd)
    logits = torch.where(keep[:, None, None, :], logits, NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    e = torch.exp(logits - m)
    total = e.sum(-1, keepdim=True)
    for g in groups:
        dist.all_reduce(total, group=g)
    w = (e / total).to(q.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", w.to(torch.float32), v.to(torch.float32))
    for g in groups:
        dist.all_reduce(o, group=g)
    return o.reshape(B, 1, H, hd).to(q.dtype)


@torch.no_grad()
def local_decode_attention(core, q, k, v, ck, cv, pos: torch.Tensor):
    """One decode token over a DTensor cache view ck/cv (B, S, KV, hd):
    k/v (B, 1, KV, hd) are written in place into the local shard that
    holds ``(row, pos[row])``, then ``core(q_local, ck_local, cv_local,
    pos_local)`` runs the rank's rows and query heads; where the cache's
    sequence is sharded the positions are attended by slices and merged
    (module docstring). Returns a DTensor at q's placements (the query
    heads of a sequence-sharding dim whole)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = ck.device_mesh
    qp, kp, seq = [], [], []
    for i, (cp, p) in enumerate(zip(ck.placements, q.placements)):
        d = _shard_dim(cp)
        if d in (0, 2):
            qp.append(Shard(d))
            kp.append(Shard(d))
            continue
        if d == 1:
            seq.append(i)
        qp.append(Shard(2) if d is None and _shard_dim(p) == 2 else Replicate())
        kp.append(Replicate())
    q = q.redistribute(mesh, qp)
    k = k.redistribute(mesh, kp)
    v = v.redistribute(mesh, kp)
    H, KV = q.shape[2], ck.shape[2]
    b0, _, h0, _ = _offsets(q)
    cb0, s0, kv0, _ = _offsets(ck)
    ql, ckl, cvl = q.to_local(), ck.to_local(), cv.to_local()
    if cb0 != b0 or ckl.shape[0] != ql.shape[0]:
        raise RuntimeError("decode: the query's rows and the cache's rows differ")
    pl = pos[b0:b0 + ql.shape[0]]
    rows = torch.arange(ql.shape[0], device=ql.device)
    kl, vl = k.to_local()[:, 0], v.to_local()[:, 0]
    if seq:
        here = (pl >= s0) & (pl < s0 + ckl.shape[1])
        rows, kl, vl = rows[here], kl[here], vl[here]
    ckl[rows, pl[rows] - s0] = kl.to(ckl.dtype)
    cvl[rows, pl[rows] - s0] = vl.to(cvl.dtype)
    kh = _kv_heads(ckl, h0, ql.shape[2], H // KV, kv0)
    vh = _kv_heads(cvl, h0, ql.shape[2], H // KV, kv0)
    if not seq:
        return _wrap(core(ql, kh, vh, pl), mesh, qp, q.shape)
    keep = (s0 + torch.arange(kh.shape[1], device=ql.device))[None] <= pl[:, None]
    o = _seq_sharded_attention(ql, kh, vh, keep, [mesh.get_group(i) for i in seq])
    return _wrap(o, mesh, qp, q.shape)


class Split:
    """The local form of one block (module docstring). ``x`` is the
    block's DTensor input (B, ...); the split dims are the mesh dims on
    which weight ``w`` is ``Shard(0)`` (its leading dim holds the block's
    heads, channels or experts), dropped (the block then runs whole on
    every rank of them) where they do not divide ``units``, the number of
    those; the batch dims are the others on which ``x`` is batch-sharded.
    Every other mesh dim computes the same on each rank.

    Gradients: an input read on the local rows is batch-sharded in its
    gradient and a partial sum over the split dims (each rank reads it
    for its own part); a weight gathered whole on the split dims is a
    partial sum there, one read by its local slice keeps that shard; every
    weight is a partial sum over the batch dims."""

    def __init__(self, x, w, units: int):
        from torch.distributed.tensor import Shard

        self.mesh = mesh = x.device_mesh
        C = tuple(i for i, p in enumerate(w.placements) if p == Shard(0))
        if units % math.prod(mesh.size(i) for i in C):
            C = ()
        self.C, self.n = C, math.prod(mesh.size(i) for i in C)
        self.Bd = tuple(i for i, p in enumerate(x.placements) if p == Shard(0) and i not in C)
        self.B = x.shape[0]
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        self.b0 = compute_local_shape_and_global_offset(x.shape, mesh,
                                                        self.placements(None))[1][0]

    def placements(self, cdim, bdim=0, partial: bool = False) -> list:
        """``bdim`` sharded over the batch dims, ``cdim`` over the split dims
        (``Partial()`` there when ``partial``); ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        out = []
        for i in range(self.mesh.ndim):
            if i in self.C:
                out.append(Partial() if partial else Shard(cdim) if cdim is not None
                           else Replicate())
            elif i in self.Bd and bdim is not None:
                out.append(Shard(bdim))
            else:
                out.append(Replicate())
        return out

    def _grads(self, cdim, bdim) -> list:
        from torch.distributed.tensor import Partial, Replicate, Shard

        return [(Shard(cdim) if cdim is not None else Partial()) if i in self.C
                else (Shard(bdim) if bdim is not None else Partial()) if i in self.Bd
                else Replicate() for i in range(self.mesh.ndim)]

    def units(self, n: int) -> tuple[int, int]:
        """The rank's ``[u0, u1)`` of ``n`` units split over the split dims."""
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        shape, off = compute_local_shape_and_global_offset((n,), self.mesh, self.placements(0, None))
        return off[0], off[0] + shape[0]

    def rows(self, x) -> torch.Tensor:
        """The local rows of ``x`` (every split dim's rank reads them all)."""
        return x.redistribute(self.mesh, self.placements(None)).to_local(
            grad_placements=self._grads(None, 0))

    def weight(self, w, cdim: int | None = None) -> torch.Tensor:
        """Weight ``w`` whole but for ``cdim`` split over the split dims
        (``None``: whole there too)."""
        return w.redistribute(self.mesh, self.placements(cdim, None)).to_local(
            grad_placements=self._grads(cdim, None))

    def _global(self, t, dim: int | None) -> tuple:
        shape = [self.B if self.Bd else t.shape[0], *t.shape[1:]]
        if dim is not None:
            shape[dim] *= self.n
        return tuple(shape)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Local rows ``t`` split on ``dim`` over the split dims, gathered
        whole on every rank of them."""
        if not self.C:
            return t
        d = _wrap(t, self.mesh, self.placements(dim), self._global(t, dim))
        return d.redistribute(self.mesh, self.placements(None)).to_local(
            grad_placements=self.placements(None, partial=True))

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Local rows ``t``, a partial sum over the split dims, summed."""
        if not self.C:
            return t
        d = _wrap(t, self.mesh, self.placements(None, partial=True), self._global(t, None))
        return d.redistribute(self.mesh, self.placements(None)).to_local(
            grad_placements=self.placements(None, partial=True))

    def out(self, t: torch.Tensor, partial: bool = True):
        """The block's local output rows as a DTensor: a partial sum over the
        split dims (``partial``), else whole there."""
        return _wrap(t, self.mesh, self.placements(None, partial=partial), self._global(t, None))

    def whole_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Local rows ``t`` (the same on every split rank) gathered over the
        batch dims (no gradient)."""
        if not self.Bd:
            return t
        return _wrap(t, self.mesh, self.placements(None), self._global(t, None)).full_tensor()

    def scalar(self, t: torch.Tensor):
        """A local partial sum over the split and the batch dims (a loss
        term of the rank's rows and units) as a DTensor."""
        from torch.distributed.tensor import Partial, Replicate

        return _wrap(t, self.mesh, [Partial() if i in self.C or i in self.Bd else Replicate()
                                    for i in range(self.mesh.ndim)], tuple(t.shape))

    def state_in(self, c, cdim: int | None) -> torch.Tensor:
        """A decode-cache leaf (B, ...) (a DTensor, or plain and taken as
        replicated) as the local rows with ``cdim`` split."""
        from torch.distributed.tensor import DTensor

        if not isinstance(c, DTensor):
            c = replicate(c, self.mesh)
        return c.redistribute(self.mesh, self.placements(cdim)).to_local()

    def state_out(self, t: torch.Tensor, cdim: int | None):
        """A new decode state's local rows as a DTensor (``cdim`` split)."""
        return _wrap(t, self.mesh, self.placements(cdim), self._global(t, cdim))
