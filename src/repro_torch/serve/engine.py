"""Serving engine: continuous batching over a fixed slot pool.

Requests queue in; free slots prefill (one request at a time) and then join
the batched decode step. Each step runs the whole slot pool through
``decode_step`` and the :class:`TokenSampler` (kernels ``cdf_scan`` and
``sample_rows``); finished slots (EOS, ``max_new``, the ``max_seq`` KV
budget) are recycled. The KV cache holds every slot in its batch dimension:
a prefill's cache is spliced into its slot, and decode writes each row at
its own position.

A request may carry its own static categorical (``Request.prior``): it
bypasses the model, joins a :class:`PooledForestSampler`'s pool on admit,
drains with every other prior-backed slot in one batched pool call per step,
and its tenant is evicted on retirement. With ``params=None`` the engine
serves prior traffic only. A request may instead carry ``Request.prior2d``,
an environment or density map: every such request shares the engine's one
:class:`SpatialSampler` (the first one's map; later ones must carry the same
map), all of them drain in one ``sample_flat`` call per step, and each
emitted token is a flat texel id.

The port of the JAX package's ``serve/engine.py``; snapshots are the same
dicts, so a JAX engine snapshot, model-backed or not, restores here.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve, to_device
from repro_torch.models.config import ModelConfig
from repro_torch.robust.errors import RequestError, ServingError
from repro_torch.robust.validate import classify_weights

from .sampler import PooledForestSampler, SpatialSampler, TokenSampler


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int = 32
    eos: int | None = None
    prior: np.ndarray | None = None  # per-request categorical (pool path)
    # sampling method of the prior's pool slot: "forest", "alias" or "auto"
    method: str = "auto"
    # 2-D map request: the engine's shared map (every prior2d request must
    # carry the same one); tokens are flat texel ids
    prior2d: Any | None = None
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # set when the engine retires the request on a fault instead of serving
    # it (``on_fault="retire"``): "<code>: <detail>"
    error: str | None = None


class ServeEngine:
    """``on_fault="raise"`` (default) surfaces a malformed request as the
    structured exception from :meth:`submit`/:meth:`step`; ``"retire"``
    retires the offending request with ``Request.error`` set while every
    other live slot keeps serving."""

    def __init__(self, params: Any, cfg: ModelConfig | None, n_slots: int = 8,
                 max_seq: int = 512, sampler: TokenSampler | None = None,
                 prior_sampler: PooledForestSampler | None = None,
                 spatial_sampler: SpatialSampler | None = None,
                 on_fault: str = "raise", device="cuda"):
        if on_fault not in ("raise", "retire"):
            raise ValueError(f"on_fault must be 'raise' or 'retire', got {on_fault!r}")
        self.device = resolve(device)
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.on_fault = on_fault
        self.sampler = sampler or TokenSampler(n_slots=n_slots, device=self.device)
        self.prior_sampler = prior_sampler
        self.prior_handles: dict[int, Any] = {}  # slot -> pool Handle
        self.spatial_sampler = spatial_sampler
        self.spatial_slots: set[int] = set()  # slots on the 2-D map drain
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * n_slots
        if params is not None:
            from repro_torch.models import init_cache

            self.cache = init_cache(cfg, n_slots, max_seq, self.device)
        else:
            self.cache = None
        self.pos = np.zeros(n_slots, np.int32)
        self.last_tok = np.zeros(n_slots, np.int32)
        self.steps = 0

    def _prior_policy(self) -> str:
        return self.prior_sampler.pool.policy if self.prior_sampler else "reject"

    def _validate(self, req: Request) -> None:
        """Submit-time structural validation of a prior (dtype, sign,
        finiteness, shape) with the structured taxonomy; weight-value
        violations defer to the pool's admission policy when it is lenient."""
        if req.prior is not None:
            try:
                _, code = classify_weights(req.prior)
            except ServingError as e:
                raise RequestError(f"request {req.rid}: prior {e.code}: {e}") from None
            if code is not None and self._prior_policy() == "reject":
                raise RequestError(f"request {req.rid}: prior {code}")
        if req.prior2d is not None:
            try:
                rows = [np.asarray(r, np.float64) for r in req.prior2d]
            except (TypeError, ValueError) as e:
                raise RequestError(f"request {req.rid}: prior2d bad_dtype: {e}") from None
            if not rows or any(r.ndim != 1 or r.size == 0 for r in rows):
                raise RequestError(
                    f"request {req.rid}: prior2d bad_shape: want non-empty 1-D rows")
            for r in rows:
                _, code = classify_weights(r, allow_zero_total=True)
                if code is not None:
                    raise RequestError(f"request {req.rid}: prior2d {code}")
            if self.spatial_sampler is not None:
                have = self.spatial_sampler.map.rows_raw
                if len(rows) != len(have) or any(
                        a.shape != b.shape for a, b in zip(rows, have)):
                    raise RequestError(
                        f"request {req.rid}: prior2d map_mismatch: shape differs "
                        "from the engine's shared map")

    def submit(self, req: Request) -> None:
        if req.prior is not None and req.prior2d is not None:
            raise RequestError("a request carries prior OR prior2d, not both")
        if req.prior is None and req.prior2d is None and self.params is None:
            raise RequestError(
                "engine has no model (params=None); submit prior-backed requests only")
        self._validate(req)
        self.queue.append(req)

    def _same_map(self, img) -> bool:
        rows = [np.asarray(r, np.float64) for r in img]
        have = self.spatial_sampler.map.rows_raw
        return len(rows) == len(have) and all(
            a.shape == b.shape and np.array_equal(a, b) for a, b in zip(rows, have))

    def _fail_request(self, s: int, err: Exception) -> None:
        """Retire one request with a structured ``error``; the slot frees
        and every other live slot is untouched."""
        req = self.slots[s]
        if req is not None:
            req.error = f"{getattr(err, 'code', 'error')}: {err}"
            req.done = True
        self.slots[s] = None
        self.prior_handles.pop(s, None)
        self.spatial_slots.discard(s)

    def _admit_spatial(self, admitted: list[tuple[int, Request]]) -> None:
        """2-D admission wave: the first ``prior2d`` request makes the
        engine's :class:`SpatialSampler`; later ones must carry the same map
        (a per-request map belongs in the pool path). The wave draws its
        first texels in one ``sample_flat`` drain."""
        if self.spatial_sampler is None:
            self.spatial_sampler = SpatialSampler(
                admitted[0][1].prior2d, n_slots=self.n_slots, device=self.device)
        kept = []
        for s, req in admitted:
            if not self._same_map(req.prior2d):
                err = RequestError(
                    f"request {req.rid}: prior2d differs from the engine's shared "
                    "map; per-request distributions go through Request.prior (the "
                    "pool path)")
                if self.on_fault == "retire":
                    self._fail_request(s, err)
                    continue
                self.slots[s] = None
                raise err
            self.spatial_slots.add(s)
            kept.append((s, req))
        if not kept:
            return
        toks = self.spatial_sampler.sample_flat(np.asarray([s for s, _ in kept]))
        for (s, req), tok in zip(kept, toks):
            self.pos[s] = 0
            self.last_tok[s] = int(tok)
            req.out.append(int(tok))

    def _admit_priors(self, admitted: list[tuple[int, Request]]) -> None:
        """Prior-backed admission wave: no prefill, no KV; the wave joins the
        pool through the batched builders and draws its first tokens in one
        batched drain."""
        if self.prior_sampler is None:
            self.prior_sampler = PooledForestSampler(n_slots=self.n_slots,
                                                     device=self.device)
        try:
            hs = self.prior_sampler.add_many([r.prior for _, r in admitted],
                                             method=[r.method for _, r in admitted])
        except ValueError:
            if self.on_fault != "retire":
                for s, _ in admitted:
                    self.slots[s] = None
                raise
            # isolate: re-admit one by one, retiring only the bad tenants
            kept, hs = [], []
            for s, req in admitted:
                try:
                    hs.append(self.prior_sampler.add(req.prior, method=req.method))
                    kept.append((s, req))
                except ValueError as e:
                    self._fail_request(s, e)
            admitted = kept
            if not admitted:
                return
        for (s, _), h in zip(admitted, hs):
            self.prior_handles[s] = h
        toks = self.prior_sampler.sample(hs, np.asarray([s for s, _ in admitted]))
        for (s, req), tok in zip(admitted, toks):
            self.pos[s] = 0
            self.last_tok[s] = int(tok)
            req.out.append(int(tok))

    def _prefill(self, s: int, req: Request) -> None:
        """Prefill one request alone and splice its cache into slot ``s``
        of the batched cache (leaves without a slot axis, the ``len``
        counters, are left as they are)."""
        from repro_torch.models import prefill

        tokens = to_device(np.asarray(req.prompt)[None, :], self.device, torch.int64)
        logits, cache1, _ = prefill(self.params, self.cfg, {"tokens": tokens},
                                    max_seq=self.max_seq)
        tok = self.sampler.sample(logits, np.array([s]))[0]
        for b, leaves in cache1.items():
            for name, one in leaves.items():
                big = self.cache[b][name]
                if one.dim() >= 2 and big.shape[1] == self.n_slots:
                    big[:, s] = one[:, 0]
        self.pos[s] = len(req.prompt)
        self.last_tok[s] = tok
        req.out.append(int(tok))

    def _admit(self) -> None:
        priors: list[tuple[int, Request]] = []
        spatial: list[tuple[int, Request]] = []
        for s in range(self.n_slots):
            if self.slots[s] is None and self.queue:
                req = self.queue.popleft()
                self.slots[s] = req
                if req.prior is not None:
                    priors.append((s, req))
                elif req.prior2d is not None:
                    spatial.append((s, req))
                else:
                    self._prefill(s, req)
        if priors:
            self._admit_priors(priors)
        if spatial:
            self._admit_spatial(spatial)

    def _retire(self) -> None:
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            if (
                len(req.out) >= req.max_new
                or (req.eos is not None and req.out and req.out[-1] == req.eos)
                # max_seq is a KV budget; prior and 2-D slots hold no KV
                or (s not in self.prior_handles and s not in self.spatial_slots
                    and self.pos[s] >= self.max_seq - 1)
            ):
                req.done = True
                self.slots[s] = None
                h = self.prior_handles.pop(s, None)
                if h is not None:
                    try:
                        self.prior_sampler.remove(h)
                    except ValueError:
                        # already evicted through an outside reference: the
                        # slot frees either way
                        if self.on_fault != "retire":
                            raise
                # a 2-D slot holds no handle (the map is shared): it just
                # leaves the drain set, and its stream keeps its counter
                self.spatial_slots.discard(s)

    def step(self) -> None:
        self._admit()
        active = [s for s, r in enumerate(self.slots) if r is not None]
        if not active:
            return
        model_slots = [s for s in active
                       if s not in self.prior_handles and s not in self.spatial_slots]
        prior_slots = [s for s in active if s in self.prior_handles]
        spatial_slots = [s for s in active if s in self.spatial_slots]
        if model_slots:
            from repro_torch.models import decode_step

            # decode writes every row at its own pos, so idle slots overwrite
            # their own stale cell; only the active rows are sampled. Every
            # row feeds its last token, as in the JAX engine, clamped to the
            # vocabulary as JAX's gather clamps it: a prior or 2-D slot's
            # last_tok is a pool index or a flat texel id. Idle rows matter
            # under MoE, where they take capacity in the same dispatch groups.
            tokens = np.minimum(self.last_tok, self.cfg.vocab - 1)
            logits, self.cache = decode_step(self.params, self.cfg, self.cache,
                                             tokens, self.pos)
            act = np.asarray(model_slots)
            toks = self.sampler.sample(logits[to_device(act, self.device)], act)
            for i, s in enumerate(model_slots):
                tok = int(toks[i])
                self.slots[s].out.append(tok)
                self.last_tok[s] = tok
                self.pos[s] += 1
        if prior_slots and self.on_fault == "retire":
            # a slot whose pool handle went stale (evicted through an outside
            # pool reference) retires instead of poisoning the batched drain
            live = []
            for s in prior_slots:
                try:
                    self.prior_sampler.pool._check(self.prior_handles[s])
                    live.append(s)
                except ValueError as e:
                    self._fail_request(s, e)
            prior_slots = live
        if prior_slots:
            hs = [self.prior_handles[s] for s in prior_slots]
            toks = self.prior_sampler.sample(hs, np.asarray(prior_slots))
            for i, s in enumerate(prior_slots):
                tok = int(toks[i])
                self.slots[s].out.append(tok)
                self.last_tok[s] = tok
                # pos stays 0: prior slots hold no KV, and pos is decode's
                # write index for every row
        if spatial_slots:
            # every 2-D slot in one sample_flat drain; pos stays 0 as above
            toks = self.spatial_sampler.sample_flat(np.asarray(spatial_slots))
            for i, s in enumerate(spatial_slots):
                tok = int(toks[i])
                self.slots[s].out.append(tok)
                self.last_tok[s] = tok
        self._retire()
        self.steps += 1

    def run(self, max_steps: int = 1000) -> None:
        while (self.queue or any(self.slots)) and self.steps < max_steps:
            self.step()

    # ---------------------------------------------------------- persistence

    @staticmethod
    def _req_state(r: Request | None):
        if r is None:
            return None
        return dict(
            rid=r.rid, prompt=np.asarray(r.prompt), max_new=r.max_new, eos=r.eos,
            prior=None if r.prior is None else np.asarray(r.prior, np.float64),
            method=r.method,
            prior2d=None if r.prior2d is None
            else [np.asarray(row, np.float64) for row in r.prior2d],
            out=list(r.out), done=r.done, error=r.error,
        )

    @staticmethod
    def _req_restore(d) -> Request | None:
        if d is None:
            return None
        return Request(
            rid=int(d["rid"]), prompt=np.asarray(d["prompt"]),
            max_new=int(d["max_new"]), eos=d["eos"],
            prior=None if d["prior"] is None else np.asarray(d["prior"]),
            method=d["method"],
            prior2d=None if d.get("prior2d") is None
            else [np.asarray(row) for row in d["prior2d"]],
            out=[int(t) for t in d["out"]], done=bool(d["done"]), error=d["error"],
        )

    def snapshot(self) -> dict:
        """The serving state in the JAX package's format: requests, slot
        positions, pool handles, every sampler's exact stream state and the
        KV cache leaves (``tree_leaves`` order), not the parameters."""
        from repro_torch.interop import cache_to_leaves

        return dict(
            kind="serve_engine",
            n_slots=self.n_slots, max_seq=self.max_seq, on_fault=self.on_fault,
            has_model=self.params is not None, steps=self.steps,
            pos=self.pos.copy(), last_tok=self.last_tok.copy(),
            queue=[self._req_state(r) for r in self.queue],
            slots=[self._req_state(r) for r in self.slots],
            prior_handles={int(s): tuple(h) for s, h in self.prior_handles.items()},
            spatial_slots=set(self.spatial_slots),
            sampler=self.sampler.snapshot(),
            prior_sampler=None if self.prior_sampler is None
            else self.prior_sampler.snapshot(),
            spatial_sampler=None if self.spatial_sampler is None
            else self.spatial_sampler.snapshot(),
            cache=None if self.cache is None else cache_to_leaves(self.cache),
        )

    @classmethod
    def restore(cls, state: dict, params: Any = None, cfg: ModelConfig | None = None,
                device="cuda") -> "ServeEngine":
        """An engine from a snapshot of either package. A model-backed
        snapshot needs the (unsnapshotted) ``params``/``cfg`` passed back;
        JAX parameters convert with ``interop.params_from_jax``."""
        from repro_torch.interop import cache_from_jax
        from repro_torch.pool import Handle

        if state.get("kind") != "serve_engine":
            raise ValueError(f"not a ServeEngine snapshot: {state.get('kind')!r}")
        if state["has_model"] and params is None:
            raise ValueError("snapshot was model-backed: pass params and cfg")
        eng = cls(params if state["has_model"] else None, cfg,
                  n_slots=int(state["n_slots"]), max_seq=int(state["max_seq"]),
                  on_fault=state.get("on_fault", "raise"), device=device)
        eng.steps = int(state["steps"])
        eng.pos = np.asarray(state["pos"], np.int32).copy()
        eng.last_tok = np.asarray(state["last_tok"], np.int32).copy()
        eng.queue = deque(cls._req_restore(d) for d in state["queue"])
        eng.slots = [cls._req_restore(d) for d in state["slots"]]
        eng.prior_handles = {
            int(s): Handle(int(h[0]), int(h[1]), int(h[2]), int(h[3]), str(h[4]))
            for s, h in state["prior_handles"].items()
        }
        eng.spatial_slots = {int(s) for s in state.get("spatial_slots", ())}
        eng.sampler = TokenSampler.restore(state["sampler"], device=eng.device)
        if state["prior_sampler"] is not None:
            eng.prior_sampler = PooledForestSampler.restore(state["prior_sampler"],
                                                            device=eng.device)
        if state.get("spatial_sampler") is not None:
            eng.spatial_sampler = SpatialSampler.restore(state["spatial_sampler"],
                                                         device=eng.device)
        if state["cache"] is not None and eng.cache is not None:
            eng.cache = cache_from_jax(state["cache"], cfg, eng.n_slots, eng.max_seq,
                                       eng.device)
        return eng
