"""Pool serving walkthrough on the PyTorch/CUDA port: thousands of
per-tenant categoricals, a handful of kernels, one batched drain per step
(``repro_torch.pool``). The twin of ``examples/pool_serving.py``.

  PYTHONPATH=src python examples/torch_pool_serving.py [--device cpu]

The scenario the paper's serving north star implies but a single forest
cannot cover: every request owns its OWN small distribution (per-request
token prior, per-client mixture, per-cell density). The pool packs them
into power-of-two size-class arenas, builds admission waves with the
batched builder (B distributions, one launch), and resolves a mixed
``(tenant, uniform)`` batch with one ``forest_sample_batched`` launch over
every touched size class. The serving hot path goes one step further:
per-slot QMC stream state lives on the device and a full drain is one
stream pre-pass plus one launch over the classes, with no host-side
bookkeeping (section 6).
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core import build_forest, normalize_weights, sample_forest
from repro_torch.core.alias import np_sample_alias_f32
from repro_torch.pool import ForestPool
from repro_torch.robust import (
    NegativeWeightError,
    QuarantinedError,
    load_serving,
    save_serving,
    verify_pool,
)
from repro_torch.serve import PooledForestSampler, Request, ServeEngine
from repro_torch.serve.sampler import DeviceQmcStreams, QmcStreams, restore_streams


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    rng = np.random.default_rng(0)

    # --- 1. Admit a heterogeneous tenant wave (ragged sizes, one batched
    #        build per size class).
    pool = ForestPool(device=dev)
    sizes = rng.integers(3, 200, size=48)
    tenants = [rng.random(s).astype(np.float64) ** 4 + 1e-6 for s in sizes]
    handles = pool.insert_many(tenants)
    st = pool.stats()
    print(f"admitted {st['tenants']} tenants into {len(st['classes'])} size "
          f"classes: {sorted(st['classes'])}")

    # --- 2. Every tenant's padded forest is bit-identical to its own
    #        single-distribution build (the batched-build contract).
    h, w = handles[7], tenants[7]
    padded = np.pad(normalize_weights(w), (0, h.size_class - len(w)))
    solo = build_forest(padded, pool.classes[h.size_class].m, device=dev)
    row = pool.forest_row(h)
    assert all(torch.equal(a, b) for a, b in zip(solo, row))
    print("tenant row == standalone build, bit for bit")

    # --- 3. Bulk mixed-batch sampling: draws against many tenants, one
    #        kernel launch over the size classes; elementwise equal to
    #        per-tenant descent.
    Q = 4096
    qh = [handles[i] for i in rng.integers(0, len(handles), Q)]
    xi = rng.random(Q).astype(np.float32)
    idx = pool.sample(qh, xi)
    spot = rng.integers(0, Q, 64)
    for q in spot:
        want = int(sample_forest(pool.forest_row(qh[q]), xi[q:q + 1], device=dev)[0])
        assert idx[q] == min(want, qh[q].n - 1)
    print(f"mixed-batch drain over {Q} draws agrees with per-tenant descent")

    # --- 4. In-place re-targeting routes through the forest_delta_update
    #        kernel: a bit-unchanged CDF skips the rebuild entirely.
    pool.update_weights(handles[0], delta=np.eye(handles[0].n)[0] * 0.25)
    pool.update_weights(handles[0], pool.weights(handles[0]).astype(np.float64))
    cls = pool.stats()["classes"][handles[0].size_class]
    print(f"updates: {cls['delta_rebuilds']} rebuilt, {cls['delta_skips']} "
          "skipped (no bits moved)")

    # --- 5. Eviction recycles rows through the free list; version counters
    #        invalidate stale handles instead of leaking a neighbor's tenant.
    pool.evict(handles[3])
    reused = pool.insert(rng.random(handles[3].n))
    assert reused.row == handles[3].row and reused.version == handles[3].version + 1
    try:
        pool.sample([handles[3]], [0.5])
    except ValueError:
        print("evicted handle raises; slot recycled with a version bump")

    # --- 6. The stream-aware one-launch drain: per-slot QMC stream state
    #        (counters + Cranley-Patterson offsets) lives ON THE DEVICE, one
    #        pre-pass ranks duplicate slots and advances every counter, and
    #        every forest size class resolves in a single launch that
    #        recomputes the stream points in the kernel. Bit-equal to the
    #        host QmcStreams oracle.
    dstreams = DeviceQmcStreams(8, seed=42, device=dev)   # 8 serving slots
    host = QmcStreams(8, seed=42)                         # the numpy oracle twin
    slots = rng.integers(0, 8, 512)                       # duplicates: best-of-n per slot
    live = [reused if h is handles[3] else h for h in handles]  # evicted [3]
    qh = [live[i] for i in rng.integers(0, len(live), 512)]
    got = pool.sample_streams(qh, slots, dstreams)        # the hot path
    want = pool.sample(qh, host.next(slots))              # oracle path
    assert np.array_equal(got, want)
    assert np.array_equal(host.counters, dstreams.counters.cpu().numpy().view(np.uint32))
    print("stream-aware drain == host-oracle drain, counters bit-equal "
          f"({len(set(slots.tolist()))} distinct slots over {len(slots)} draws)")

    # --- 7. The serving engine's multi-tenant path: prior-backed requests
    #        skip the model entirely, pure categorical traffic, one batched
    #        drain per step (params=None: no LM in the loop).
    eng = ServeEngine(params=None, cfg=None, n_slots=8, max_seq=64,
                      prior_sampler=PooledForestSampler(n_slots=8, device=dev),
                      device=dev)
    reqs = [
        Request(rid=i, prompt=np.zeros(1, np.int64), max_new=8,
                prior=rng.random(rng.integers(4, 60)) + 1e-3)
        for i in range(16)
    ]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=200)
    assert all(r.done and len(r.out) == 8 for r in reqs)
    assert all(all(0 <= t < len(r.prior) for t in r.out) for r in reqs)
    print(f"served {len(reqs)} prior-backed requests in {eng.steps} engine steps"
          f" over {eng.n_slots} slots")

    # --- 8. Per-tenant sampling method: the paper's forest-vs-alias tradeoff
    #        as a per-slot attribute. Stream-sensitive tenants (QMC
    #        best-of-n) keep the monotone forest descent; bulk PRNG tenants
    #        take packed O(1) alias tables: same pool, same free-list and
    #        version machinery, one mixed drain call, one launch a method.
    mixed = ForestPool(device=dev)
    ws = [rng.random(rng.integers(4, 60)) + 1e-3 for _ in range(24)]
    methods = ["forest" if i % 2 == 0 else "alias" for i in range(len(ws))]
    mh = mixed.insert_many(ws, method=methods)
    st = mixed.stats()
    print(f"mixed pool: {len(st['classes'])} forest classes + "
          f"{len(st['alias_classes'])} alias classes over {st['tenants']} tenants")
    xi = rng.random(len(mh)).astype(np.float32)
    out = mixed.sample(mh, xi)  # ONE call drains both methods
    for i, (h, x) in enumerate(zip(mh, xi)):
        if h.method == "alias":
            t = mixed.alias_row(h)
            want = int(np_sample_alias_f32(
                t.q.cpu().numpy(), t.alias.cpu().numpy(), np.array([x]))[0])
            assert out[i] == min(want, h.n - 1)
    print("alias lanes match the O(1) table oracle; forest lanes untouched")

    # Serving side: ``method="auto"`` resolves by stream kind. A PRNG
    # sampler (MC baseline, nothing to protect) admits to alias, a QMC
    # sampler keeps the monotone forest path so the stratification survives.
    prng_sampler = PooledForestSampler(n_slots=8, streams="prng", device=dev)
    qmc_sampler = PooledForestSampler(n_slots=8, device=dev)
    print(f"auto under prng streams -> {prng_sampler.add(ws[0]).method}; "
          f"auto under qmc streams -> {qmc_sampler.add(ws[0]).method}")
    eng2 = ServeEngine(params=None, cfg=None, n_slots=8, max_seq=64,
                       prior_sampler=prng_sampler, device=dev)
    reqs2 = [
        Request(rid=i, prompt=np.zeros(1, np.int64), max_new=4,
                prior=rng.random(rng.integers(4, 60)) + 1e-3,
                method=["auto", "forest", "alias"][i % 3])
        for i in range(12)
    ]
    for r in reqs2:
        eng2.submit(r)
    eng2.run(max_steps=100)
    assert all(r.done and len(r.out) == 4 for r in reqs2)
    assert all(all(0 <= t < len(r.prior) for t in r.out) for r in reqs2)
    print(f"served {len(reqs2)} mixed-method requests in {eng2.steps} steps")

    # --- 9. Hardened serving: validated admission, quarantine, and
    #        snapshot/restore. Malformed weight rows are rejected at the
    #        boundary with a structured taxonomy (every class a ValueError);
    #        a quarantine-policy pool admits the tenant on a uniform
    #        placeholder and flags it instead of failing the wave; and the
    #        whole serving state (arena payloads, free lists, version
    #        counters, device stream counters) round-trips through
    #        save_serving/load_serving for bit-identical resumed drains.
    try:
        pool.insert(np.asarray([2.0, -1.0, 2.0]))   # positive sum, still bad
    except NegativeWeightError as e:
        print(f"rejected at admission with code {e.code!r}")

    qpool = ForestPool(policy="quarantine", device=dev)
    ok = qpool.insert(rng.random(6) + 1e-3)
    sus = qpool.insert(np.asarray([1.0, np.nan, 1.0]))  # admitted, flagged
    assert qpool.is_quarantined(sus) and not qpool.is_quarantined(ok)
    try:
        qpool.weights(sus)
    except QuarantinedError:
        pass  # the row serves a uniform placeholder, not the bad submission
    qpool.update_weights(sus, np.arange(1.0, 4.0))      # clean update clears
    assert not qpool.is_quarantined(sus)
    print(f"quarantine: flagged on admit, cleared by a clean update "
          f"({qpool.stats()['quarantined']} still flagged)")

    with tempfile.TemporaryDirectory() as ck:
        streams2 = DeviceQmcStreams(8, seed=7, device=dev)
        qpool.sample_streams([ok, sus] * 4, np.arange(8), streams2)
        save_serving(ck, step=1, pool=qpool, streams=streams2)
        states, step = load_serving(ck)
        rpool = ForestPool.restore(states["pool"], device=dev)
        rstreams = restore_streams(states["streams"], device=dev)
        assert verify_pool(rpool) == []
        a = qpool.sample_streams([ok, sus] * 4, np.arange(8), streams2)
        b = rpool.sample_streams([ok, sus] * 4, np.arange(8), rstreams)
        assert np.array_equal(a, b)
    print("snapshot/restore: resumed drains bit-identical "
          "(verify_pool clean after restore)")


if __name__ == "__main__":
    main()
