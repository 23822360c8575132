"""Serving samplers with per-slot QMC uniform streams.

:class:`QmcStreams` is the numpy stream oracle (the exact 24-bit fixed-point
pipeline of :mod:`repro_torch.core.lds`; same seed => bit-equal points and
counters to the JAX package's). :class:`DeviceQmcStreams` keeps the same
state as tensors on the card and advances it in one pre-pass per drain
(:func:`_stream_prepass`), bit-equal to the oracle, duplicate slots
included; :class:`Qmc2Streams` and :class:`DeviceQmc2Streams` are the 2-D
pair (u the radical inverse, v Sobol' dimension 1, one counter a slot).
:class:`ForestSampler` builds one radix forest on its device and inverts
the CDF at the slots' stream points (monotone warp, so the stratification
survives). :class:`PooledForestSampler` serves many small tenant
distributions from one :class:`~repro_torch.pool.ForestPool`: QMC tenants
drain through the stream-aware descent kernel, PRNG tenants through the
alias kernels. :class:`SpatialSampler` serves one 2-D map
(:class:`~repro_torch.spatial.Map2DSampler`) at the slots' 2-D stream
points, which stay on the device between the streams and the drain.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.alias import build_alias, sample_alias
from repro_torch.core.cdf import normalize_weights, updated_weights
from repro_torch.core.forest import build_forest
from repro_torch.core.lds import (
    QMC_SCALE,
    qmc2_point,
    qmc2_point_np,
    qmc_bits24_np,
    qmc_offset_bits_np,
    qmc_point,
)
from repro_torch.core.sample import PackedForestHolder, sample_forest
from repro_torch.device import resolve, to_device
from repro_torch.kernels import ops


class QmcStreams:
    """Per-slot low-discrepancy uniform streams with Cranley-Patterson
    rotations (slot-hash offsets keep slots decorrelated but stratified)."""

    def __init__(self, n_slots: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.offset_bits = qmc_offset_bits_np(rng.random(n_slots))
        self.offsets = self.offset_bits.astype(np.float32) * QMC_SCALE
        self.counters = np.zeros(n_slots, np.uint32)

    def next(self, slots: np.ndarray | None = None) -> np.ndarray:
        """One stream point per requested slot occurrence. A slot repeated
        k times in one call draws its next k distinct stream points (the
        j-th occurrence, in call order, at counter+j) and its counter
        advances by k."""
        if slots is None:
            slots = np.arange(len(self.offset_bits))
        slots = np.asarray(slots)
        rank = _occurrence_rank_np(slots)
        xi = qmc_bits24_np(
            self.counters[slots] + rank, self.offset_bits[slots]
        ).astype(np.float32) * QMC_SCALE
        np.add.at(self.counters, slots, 1)
        return xi

    def snapshot(self) -> dict:
        """Exact stream state (offset bits + counters)."""
        return dict(kind="qmc_streams",
                    offset_bits=self.offset_bits.copy(),
                    counters=self.counters.copy())

    @classmethod
    def restore(cls, state: dict) -> "QmcStreams":
        s = cls.__new__(cls)
        s.offset_bits = np.asarray(state["offset_bits"], np.uint32).copy()
        s.offsets = s.offset_bits.astype(np.float32) * QMC_SCALE
        s.counters = np.asarray(state["counters"], np.uint32).copy()
        return s


def _occurrence_rank_np(slots: np.ndarray) -> np.ndarray:
    """Per-occurrence rank of each slot within one call (call order): the
    j-th occurrence of a slot gets rank j. Stable sort + searchsorted."""
    order = np.argsort(slots, kind="stable")
    sorted_slots = slots[order]
    first = np.searchsorted(sorted_slots, sorted_slots, side="left")
    rank = np.empty(len(slots), np.uint32)
    rank[order] = (np.arange(len(slots)) - first).astype(np.uint32)
    return rank


class ForestSampler(PackedForestHolder):
    """Shared-distribution serving sampler: ONE static distribution (draft
    prior, data mixture, env-map row), many draws per step.

    Builds the radix forest once on ``device``; every :meth:`sample` call
    inverts the CDF at the slots' QMC stream points through the
    ``forest_sample`` kernel. :meth:`update_weights` swaps the distribution
    in place and the slot streams continue uninterrupted."""

    def __init__(self, weights, m: int | None = None, sharded: bool = False,
                 n_slots: int = 64, seed: int = 0, device="cuda"):
        if sharded:
            raise NotImplementedError(
                "sharded ForestSampler is not ported yet (ROADMAP item A7)")
        self.device = resolve(device)
        self._raw = np.asarray(weights, np.float64)
        w = normalize_weights(self._raw)
        m = m or max(len(w), 16)
        self.streams = QmcStreams(n_slots, seed)
        self.forest = build_forest(w, m, device=self.device)

    @classmethod
    def from_state(cls, forest_numpy: dict, streams_state: dict,
                   device="cuda") -> "ForestSampler":
        """A sampler over an existing forest and stream state, both plain
        numpy: the dict of ``forest_to_numpy`` (of either package) and a
        ``QmcStreams.snapshot()``. Later draws equal the source sampler's.
        The raw weights for delta updates are the forest's interval widths."""
        from repro_torch.interop import forest_from_numpy

        s = cls.__new__(cls)
        s.device = resolve(device)
        s.forest = forest_from_numpy(forest_numpy, s.device)
        s._raw = np.diff(np.asarray(forest_numpy["cdf"], np.float64))
        s.streams = QmcStreams.restore(streams_state)
        return s

    def update_weights(self, weights=None, *, delta=None) -> None:
        """In-place distribution update (new full weights, or a delta added
        to the current raw weights); slot streams keep their counters."""
        self._raw, w = updated_weights(self._raw, weights, delta=delta)
        self.forest = build_forest(w, self.forest.m, device=self.device)

    def sample(self, slots: np.ndarray) -> np.ndarray:
        xi = self.streams.next(slots)
        idx = sample_forest(self.forest, xi, device=self.device, packed=self._packed)
        return idx.cpu().numpy()


def _advance(counters: torch.Tensor, slots: torch.Tensor):
    """The counter side of one stream drain on the device: per-occurrence
    rank (stable sort, equal to ``_occurrence_rank_np``), each lane's
    rank-adjusted counter and the advanced per-slot counters. The 32-bit
    state is int32 bit views in and out: sums are taken in int64 and
    narrowed, which keeps the low 32 bits (the uint32 wrap). Sentinel lanes
    (``slots < 0``) get counter 0 and advance nothing. Returns ``(valid,
    slot or 0, counter, new counters)``."""
    S, Q = counters.shape[0], slots.shape[0]
    valid = slots >= 0
    # sentinels sort after every real slot so they never perturb real ranks
    key = torch.where(valid, slots, S)
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    first = torch.searchsorted(sk, sk, right=False)
    rank = torch.empty(Q, dtype=torch.int64, device=slots.device)
    rank[order] = torch.arange(Q, device=slots.device) - first
    sl = torch.where(valid, slots, 0)
    ctr = torch.where(valid, (counters[sl].to(torch.int64) + rank).to(torch.int32), 0)
    new_counters = counters.to(torch.int64).index_add(
        0, sl, valid.to(torch.int64)).to(torch.int32)
    return valid, sl, ctr, new_counters


def _stream_prepass(counters: torch.Tensor, offset_bits: torch.Tensor,
                    slots: torch.Tensor):
    """Device twin of one ``QmcStreams.next`` drain (:func:`_advance`): the
    per-lane counters and offsets, the drawn points, and the advanced
    per-slot counters. Sentinel lanes draw a dead point."""
    valid, sl, ctr, new_counters = _advance(counters, slots)
    off = torch.where(valid, offset_bits[sl], 0)
    return ctr, off, qmc_point(ctr, off), new_counters


def _stream_prepass2(counters: torch.Tensor, offset_u: torch.Tensor,
                     offset_v: torch.Tensor, slots: torch.Tensor):
    """Device twin of one ``Qmc2Streams.next`` drain, the 2-D sibling of
    :func:`_stream_prepass` (same sentinel lanes and duplicate-slot ranks):
    the points ``(u, v)`` and the advanced per-slot counters."""
    valid, sl, ctr, new_counters = _advance(counters, slots)
    ou = torch.where(valid, offset_u[sl], 0)
    ov = torch.where(valid, offset_v[sl], 0)
    u, v = qmc2_point(ctr, ou, ov)
    return u, v, new_counters


def _i32_bits(a: np.ndarray) -> np.ndarray:
    return np.array(a, np.uint32).view(np.int32)


class DeviceQmcStreams:
    """Device twin of :class:`QmcStreams`: the per-slot counters and
    Cranley-Patterson offset bits live as tensors on ``device`` (int32 bit
    views of the uint32 values, the form the stream-aware drain kernel
    reads) and a drain advances them in :func:`_stream_prepass`, with no
    host-side counter mutation. Same seed => bit-equal offsets, counters
    and points to the host class.

    ``draw`` is the pool-facing protocol: the per-lane rank-adjusted
    ``(counter, offset_bits, xi)`` that feed the stream-aware drain kernel
    (which recomputes the same ``xi``). ``next`` matches the host API."""

    def __init__(self, n_slots: int, seed: int = 0, device="cuda"):
        rng = np.random.default_rng(seed)
        self.device = resolve(device)
        self.offset_bits = to_device(
            _i32_bits(qmc_offset_bits_np(rng.random(n_slots))), self.device)
        self.counters = torch.zeros(n_slots, dtype=torch.int32, device=self.device)

    @property
    def n_slots(self) -> int:
        return int(self.offset_bits.shape[0])

    @property
    def offsets(self) -> np.ndarray:
        return self.offset_bits.cpu().numpy().astype(np.float32) * QMC_SCALE

    def draw(self, slots):
        """Advance every requested slot occurrence and return the per-lane
        stream state ``(counter, offset_bits, xi)``, each (Q,) on the
        device (int32 bits, int32 bits, float32)."""
        s = to_device(np.asarray(slots, np.int64), self.device)
        ctr, off, xi, self.counters = _stream_prepass(self.counters, self.offset_bits, s)
        return ctr, off, xi

    def next(self, slots: np.ndarray | None = None) -> np.ndarray:
        """Host-API-compatible drain (returns the points as numpy)."""
        if slots is None:
            slots = np.arange(self.n_slots)
        return self.draw(slots)[2].cpu().numpy()

    def snapshot(self) -> dict:
        return dict(kind="device_qmc_streams",
                    offset_bits=self.offset_bits.cpu().numpy().view(np.uint32).copy(),
                    counters=self.counters.cpu().numpy().view(np.uint32).copy())

    @classmethod
    def restore(cls, state: dict, device="cuda") -> "DeviceQmcStreams":
        """From a stream snapshot of either package (host or device kind)."""
        s = cls.__new__(cls)
        s.device = resolve(device)
        s.offset_bits = to_device(_i32_bits(state["offset_bits"]), s.device)
        s.counters = to_device(_i32_bits(state["counters"]), s.device)
        return s


class Qmc2Streams:
    """Per-slot 2-D low-discrepancy streams (numpy, the oracle of the 2-D
    pair): u is the base-2 radical inverse (Sobol' dim 0), v Sobol' dim 1,
    each with its own per-slot rotation; one counter a slot drives both, so
    a point is one sequence element. Same seed => bit-equal offsets,
    counters and points to :class:`DeviceQmc2Streams` and to the JAX
    package's."""

    def __init__(self, n_slots: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.offset_u = qmc_offset_bits_np(rng.random(n_slots))
        self.offset_v = qmc_offset_bits_np(rng.random(n_slots))
        self.counters = np.zeros(n_slots, np.uint32)

    def next(self, slots: np.ndarray | None = None):
        """One 2-D point per requested slot occurrence (duplicates get
        consecutive points, as in :class:`QmcStreams`): ``(u, v)``
        float32 arrays."""
        if slots is None:
            slots = np.arange(len(self.offset_u))
        slots = np.asarray(slots)
        ctr = self.counters[slots] + _occurrence_rank_np(slots)
        u, v = qmc2_point_np(ctr, self.offset_u[slots], self.offset_v[slots])
        np.add.at(self.counters, slots, 1)
        return u, v

    def snapshot(self) -> dict:
        return dict(kind="qmc2_streams", offset_u=self.offset_u.copy(),
                    offset_v=self.offset_v.copy(), counters=self.counters.copy())

    @classmethod
    def restore(cls, state: dict) -> "Qmc2Streams":
        s = cls.__new__(cls)
        s.offset_u = np.asarray(state["offset_u"], np.uint32).copy()
        s.offset_v = np.asarray(state["offset_v"], np.uint32).copy()
        s.counters = np.asarray(state["counters"], np.uint32).copy()
        return s


class DeviceQmc2Streams:
    """Device twin of :class:`Qmc2Streams`: counters and both rotations live
    on ``device`` as int32 bit views, and a drain advances them in
    :func:`_stream_prepass2` with no host-side counter mutation. Same seed
    => bit-equal points and counters to the host class."""

    def __init__(self, n_slots: int, seed: int = 0, device="cuda"):
        rng = np.random.default_rng(seed)
        self.device = resolve(device)
        self.offset_u = to_device(_i32_bits(qmc_offset_bits_np(rng.random(n_slots))),
                                  self.device)
        self.offset_v = to_device(_i32_bits(qmc_offset_bits_np(rng.random(n_slots))),
                                  self.device)
        self.counters = torch.zeros(n_slots, dtype=torch.int32, device=self.device)

    @property
    def n_slots(self) -> int:
        return int(self.offset_u.shape[0])

    def draw(self, slots):
        """Advance every requested slot occurrence; returns the ``(u, v)``
        points, each (Q,) float32 on the device."""
        s = to_device(np.asarray(slots, np.int64), self.device)
        u, v, self.counters = _stream_prepass2(self.counters, self.offset_u,
                                               self.offset_v, s)
        return u, v

    def next(self, slots: np.ndarray | None = None):
        """Host-API-compatible drain: ``(u, v)`` as numpy."""
        if slots is None:
            slots = np.arange(self.n_slots)
        u, v = self.draw(slots)
        return u.cpu().numpy(), v.cpu().numpy()

    def snapshot(self) -> dict:
        def u32(t):
            return t.cpu().numpy().view(np.uint32).copy()

        return dict(kind="device_qmc2_streams", offset_u=u32(self.offset_u),
                    offset_v=u32(self.offset_v), counters=u32(self.counters))

    @classmethod
    def restore(cls, state: dict, device="cuda") -> "DeviceQmc2Streams":
        """From a 2-D stream snapshot of either package (host or device)."""
        s = cls.__new__(cls)
        s.device = resolve(device)
        s.offset_u = to_device(_i32_bits(state["offset_u"]), s.device)
        s.offset_v = to_device(_i32_bits(state["offset_v"]), s.device)
        s.counters = to_device(_i32_bits(state["counters"]), s.device)
        return s


def restore_streams(state: dict | None, device="cuda"):
    """A stream snapshot of either package back to its class by ``kind``;
    the device kinds restore onto ``device``."""
    if state is None:
        return None
    kind = state["kind"]
    if kind == "qmc_streams":
        return QmcStreams.restore(state)
    if kind == "qmc2_streams":
        return Qmc2Streams.restore(state)
    if kind == "device_qmc_streams":
        return DeviceQmcStreams.restore(state, device=device)
    if kind == "device_qmc2_streams":
        return DeviceQmc2Streams.restore(state, device=device)
    raise ValueError(f"unknown stream kind {kind!r}")


def _rng_state(rng):
    return None if rng is None else rng.bit_generator.state


def _rng_restore(state):
    if state is None:
        return None
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    return rng


class PooledForestSampler:
    """Multi-tenant serving sampler: many per-request categoricals (draft
    priors, per-client mixtures, per-cell densities) in ONE
    :class:`~repro_torch.pool.ForestPool` on ``device``, drained in bulk.

    ``add``/``add_many`` admit tenants and return pool handles; ``sample``
    resolves one draw per slot against that slot's tenant. Under
    ``streams="qmc"`` (default) the slot streams live on the device
    (:class:`DeviceQmcStreams`) and a drain is one ``sample_streams`` call:
    one pre-pass ranks duplicate slots and advances every counter, and each
    touched forest size class resolves its lanes with one
    ``forest_sample_batched_streams`` launch that computes the points in
    the kernel. ``device_streams=False`` uses the host :class:`QmcStreams`
    oracle instead (equal draws). ``streams="prng"`` draws uniforms from one
    seeded numpy generator. ``method="auto"`` picks alias under PRNG
    streams and forest under QMC streams: the descent is spent only where a
    stratified stream would be destroyed by the non-monotone alias map.
    Slot streams keep their counters across tenant churn."""

    def __init__(self, n_slots: int = 64, seed: int = 0, min_class: int = 8,
                 m: int | None = None, device_streams: bool = True,
                 streams: str = "qmc", policy: str = "reject", device="cuda"):
        from repro_torch.pool import ForestPool

        if streams not in ("qmc", "prng"):
            raise ValueError(f"streams must be 'qmc' or 'prng', got {streams!r}")
        self.device = resolve(device)
        self.pool = ForestPool(min_class=min_class, m=m, policy=policy,
                               device=self.device)
        self.stream_kind = streams
        self.device_streams = device_streams and streams == "qmc"
        if streams == "qmc":
            self.streams = (
                DeviceQmcStreams(n_slots, seed, device=self.device)
                if device_streams else QmcStreams(n_slots, seed))
            self.rng = None
        else:
            self.streams = None
            self.rng = np.random.default_rng(seed)

    def _resolve(self, method: str) -> str:
        if method == "auto":
            return "alias" if self.stream_kind == "prng" else "forest"
        return method

    def add(self, weights, method: str = "auto"):
        """Admit one tenant; returns its pool handle."""
        return self.pool.insert(weights, method=self._resolve(method))

    def add_many(self, weights_list, method="auto"):
        """Admit an admission wave through the batched builders. ``method``
        is one choice for the wave or a per-tenant sequence."""
        if isinstance(method, str):
            methods = [self._resolve(method)] * len(weights_list)
        else:
            methods = [self._resolve(m) for m in method]
        return self.pool.insert_many(weights_list, method=methods)

    def update(self, handle, weights=None, *, delta=None) -> None:
        self.pool.update_weights(handle, weights, delta=delta)

    def remove(self, handle) -> None:
        self.pool.evict(handle)

    def sample(self, handles, slots: np.ndarray) -> np.ndarray:
        """One draw per slot from that slot's tenant distribution:
        ``handles[i]`` pairs with ``slots[i]``'s stream."""
        if self.stream_kind == "prng":
            xi = self.rng.random(len(slots)).astype(np.float32)
            return self.pool.sample(handles, xi)
        if self.device_streams:
            return self.pool.sample_streams(handles, np.asarray(slots), self.streams)
        return self.pool.sample(handles, self.streams.next(np.asarray(slots)))

    def snapshot(self) -> dict:
        """Pool arenas + exact stream/PRNG state, as plain numpy dicts."""
        return dict(
            kind="pooled_forest_sampler",
            pool=self.pool.snapshot(),
            stream_kind=self.stream_kind,
            device_streams=self.device_streams,
            streams=None if self.streams is None else self.streams.snapshot(),
            rng=_rng_state(self.rng),
        )

    @classmethod
    def restore(cls, state: dict, device="cuda") -> "PooledForestSampler":
        """From a snapshot of either package; later drains on the same
        handles and slots equal the source sampler's."""
        from repro_torch.pool import ForestPool

        if state.get("kind") != "pooled_forest_sampler":
            raise ValueError(
                f"not a PooledForestSampler snapshot: {state.get('kind')!r}")
        s = cls(n_slots=1, streams=state["stream_kind"],
                device_streams=state["device_streams"], device=device)
        s.pool = ForestPool.restore(state["pool"], device=device)
        s.streams = restore_streams(state["streams"], s.device)
        s.rng = _rng_restore(state["rng"])
        return s


class SpatialSampler:
    """2-D serving sampler: one shared environment or density map
    (:class:`~repro_torch.spatial.Map2DSampler`) drained at per-slot 2-D
    QMC stream points, on ``device``.

    Each ``sample`` call draws one 2-D point per slot occurrence
    (``streams="qmc"``: the 24-bit Sobol' pair, counters on the device
    unless ``device_streams=False``; ``streams="prng"``: a seeded numpy
    generator) and resolves the batch through
    :meth:`~repro_torch.spatial.Map2DSampler.sample_map`. Both warps are
    monotone, so the streams' 2-D stratification survives into texel space.
    :meth:`update` re-targets dirty rows in place; slot streams keep their
    counters."""

    def __init__(self, img, n_slots: int = 64, seed: int = 0, streams: str = "qmc",
                 device_streams: bool = True, device="cuda", **map_kwargs):
        from repro_torch.spatial import Map2DSampler

        if streams not in ("qmc", "prng"):
            raise ValueError(f"streams must be 'qmc' or 'prng', got {streams!r}")
        self.device = resolve(device)
        self.map = Map2DSampler(img, device=self.device, **map_kwargs)
        self.stream_kind = streams
        self.device_streams = device_streams and streams == "qmc"
        if streams == "qmc":
            self.streams = (
                DeviceQmc2Streams(n_slots, seed, device=self.device)
                if device_streams else Qmc2Streams(n_slots, seed))
            self.rng = None
        else:
            self.streams = None
            self.rng = np.random.default_rng(seed)

    def _points(self, slots: np.ndarray):
        if self.stream_kind == "prng":
            pts = self.rng.random((len(slots), 2)).astype(np.float32)
            return pts[:, 0], pts[:, 1]
        if self.device_streams:
            return self.streams.draw(slots)
        return self.streams.next(slots)

    def _drain(self, slots):
        r, c, _, _ = self.map.sample_map(self._points(np.asarray(slots)))
        return r, c

    def sample(self, slots: np.ndarray):
        """One (row, col) texel per slot occurrence, as numpy int32."""
        rc = torch.stack(self._drain(slots)).cpu().numpy()
        return rc[0], rc[1]

    def sample_flat(self, slots: np.ndarray) -> np.ndarray:
        """One flat texel id per slot occurrence (the engine's token form)."""
        return self.map.flat_index(*self._drain(slots)).cpu().numpy()

    def update(self, delta_rows: dict, *, delta: bool = False) -> dict:
        """Patch dirty map rows in place (O(dirty rows); see
        :meth:`~repro_torch.spatial.Map2DSampler.update_map`)."""
        return self.map.update_map(delta_rows, delta=delta)

    def snapshot(self) -> dict:
        """Map rows, build settings and exact stream state, in the JAX
        package's format. Restore rebuilds the map (bit-identical arrays)
        and resumes the streams where they stopped."""
        m = self.map
        return dict(
            kind="spatial_sampler",
            rows=[np.asarray(r, np.float64) for r in m.rows_raw],
            map_kwargs=dict(m_marginal=m.m_marginal, min_class=m.min_class,
                            fallback_slack=m.fallback_slack, coalesce=m.coalesce,
                            policy=m.policy),
            stream_kind=self.stream_kind,
            device_streams=self.device_streams,
            streams=None if self.streams is None else self.streams.snapshot(),
            rng=_rng_state(self.rng),
        )

    @classmethod
    def restore(cls, state: dict, device="cuda") -> "SpatialSampler":
        """From a snapshot of either package; a JAX snapshot's
        ``map_kwargs["use_pallas"]`` is ignored (the kernels follow the
        device)."""
        if state.get("kind") != "spatial_sampler":
            raise ValueError(f"not a SpatialSampler snapshot: {state.get('kind')!r}")
        kwargs = {k: v for k, v in state["map_kwargs"].items() if k != "use_pallas"}
        s = cls([np.asarray(r, np.float64) for r in state["rows"]], n_slots=1,
                streams=state["stream_kind"], device_streams=state["device_streams"],
                device=device, **kwargs)
        s.streams = restore_streams(state["streams"], s.device)
        s.rng = _rng_restore(state["rng"])
        return s


class TokenSampler:
    """Decode-token sampler over per-slot uniforms. Modes:

    * ``inverse_qmc``: softmax -> CDF rows (``ops.fused_cdf``, kernel
      ``cdf_scan``) and the per-row tiled inverse (``ops.sample_rows``,
      kernel ``sample_rows``), at the slots' :class:`QmcStreams` points;
    * ``inverse_rng``: the same mapping at uniforms from one seeded numpy
      generator (the Monte Carlo baseline);
    * ``alias``: a per-row host Vose build on the softmax and one
      ``sample_alias`` draw (the paper's antagonist, serial by design).

    Every mode draws through :meth:`uniforms`, so mode comparisons contrast
    mappings, not randomness. ``temperature`` divides the logits in their
    own dtype. ``use_pallas`` is accepted so that a JAX snapshot or call
    restores as is, and ignored: the kernel wrappers choose by device."""

    def __init__(self, mode: str = "inverse_qmc", n_slots: int = 64,
                 temperature: float = 1.0, seed: int = 0, use_pallas: bool = True,
                 device="cuda"):
        if mode not in ("inverse_qmc", "inverse_rng", "alias"):
            raise ValueError(f"unknown TokenSampler mode {mode!r}")
        self.mode = mode
        self.temperature = temperature
        self.device = resolve(device)
        self.streams = QmcStreams(n_slots, seed)
        self.rng = np.random.default_rng(seed)
        self.use_pallas = use_pallas

    def uniforms(self, slots: np.ndarray) -> np.ndarray:
        if self.mode == "inverse_qmc":
            return self.streams.next(slots)
        return self.rng.random(len(slots)).astype(np.float32)

    def sample(self, logits, slots: np.ndarray) -> np.ndarray:
        """logits (B, V) -> token ids (B,) int32, one per slot."""
        logits = to_device(logits, self.device) / self.temperature
        xi = self.uniforms(slots)
        if self.mode == "alias":
            p = torch.softmax(logits, dim=-1).cpu().double().numpy()
            out = np.empty(len(slots), np.int32)
            for i in range(len(slots)):  # serial build per row: the point
                t = build_alias(p[i], device="cpu")
                out[i] = int(sample_alias(t, torch.tensor([xi[i]]))[0])
            return out
        cdf = ops.fused_cdf(logits, softmax=True)
        idx = ops.sample_rows(cdf, to_device(xi, self.device)[:, None])
        return idx[:, 0].cpu().numpy()

    def snapshot(self) -> dict:
        return dict(
            kind="token_sampler", mode=self.mode,
            temperature=self.temperature, use_pallas=self.use_pallas,
            streams=self.streams.snapshot(), rng=_rng_state(self.rng),
        )

    @classmethod
    def restore(cls, state: dict, device="cuda") -> "TokenSampler":
        """From a snapshot of either package."""
        if state.get("kind") != "token_sampler":
            raise ValueError(f"not a TokenSampler snapshot: {state.get('kind')!r}")
        s = cls(mode=state["mode"], n_slots=1, temperature=state["temperature"],
                use_pallas=state["use_pallas"], device=device)
        s.streams = restore_streams(state["streams"], s.device)
        s.rng = _rng_restore(state["rng"])
        return s
