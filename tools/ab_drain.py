"""Time the pool drain's kernels B5/B6 (``forest_sample_batched`` and its
stream form) and B8 (``alias_sample_batched``) of two checkouts of this
repository on one card, in turns.

    python3 tools/ab_drain.py OLD_DIR NEW_DIR

Each checkout's own ``repro_torch`` (its kernel library built at first use
under that checkout's ``build/``) runs in a process of its own, in the order
old, new, new, old. Each process admits the pool of ``chip_smoke.py``
(4096 tenants, sizes 17..65536, even ones forest, odd alias) through the
user entry points and measures, through this checkout's
``chip_smoke.drain_device`` (torch.profiler, CUDA activity): one 2^20-draw
stream drain's device ms, kernel launches and copies, and B6's and B8's
device ms and launches in it; the same for one host-uniform drain (B5 and
B8). Then B5's, B6's and B8's device ms over ``chip_smoke.pool_path``
(the smoke's whole pool path: admission, ten drains checked against the
plain versions, churn; its printing muted). Then each kernel alone at
2^22 lanes on the largest class through the single-stack entry points,
``coalesce`` off and on: one call between CUDA events (median of 20; the
wrapper's host time before the launch falls inside the events), and per
call with 20 calls queued behind a card spin (``cuda_ms_per_call``: the
kernels back to back). Prints the card's name and power limit, then one
line a measurement: old and new, each the mean of its two processes (each
process's value in brackets), and old / new; the runner is
``tools/ab_runner.py``.
"""
from __future__ import annotations

import contextlib
import io
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DRAWS = 1 << 20
SLOTS = 1 << 16
LANES = 1 << 22


def child(tree: Path) -> dict:
    """The measurements of ``tree``'s drain kernels in this process."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import numpy as np
    import torch

    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (
        POOL_KMAX,
        POOL_KMIN,
        POOL_TENANTS,
        cuda_ms,
        cuda_ms_per_call,
        drain_device,
        kernel_device_ms,
        pool_path,
        pool_tenants,
    )
    from repro_torch.kernels.alias_sample import alias_sample_batched
    from repro_torch.kernels.forest_sample import forest_sample_batched_streams
    from repro_torch.serve.sampler import PooledForestSampler

    dev = torch.device("cuda")
    weights, methods, _tied, _dyadic = pool_tenants(POOL_TENANTS, POOL_KMIN, POOL_KMAX)
    sampler = PooledForestSampler(n_slots=SLOTS, seed=0, device=dev)
    handles = sampler.add_many(weights, method=methods)
    rng = np.random.default_rng(3)
    hs = [handles[i] for i in rng.integers(0, len(handles), DRAWS)]
    slots = rng.integers(0, SLOTS, DRAWS)
    xi = rng.random(DRAWS).astype(np.float32)
    out = {}
    for label, fn in (("stream drain", lambda: sampler.sample(hs, slots)),
                      ("host-uniform drain", lambda: sampler.pool.sample(hs, xi))):
        fn()  # warm
        r = drain_device(fn)
        out[f"{label}: device ms"] = r["device_ms"]
        out[f"{label}: kernel launches"] = r["launches"]
        out[f"{label}: copies"] = r["copies"]
        for k, short in (("forest_sample_batched", "B5"), ("forest_sample_batched_streams", "B6"),
                         ("alias_sample_batched", "B8")):
            if r[f"{k}_launches"]:
                out[f"{label}: {short} device ms"] = r[f"{k}_ms"]
                out[f"{label}: {short} launches"] = r[f"{k}_launches"]

    gen = torch.Generator(device=dev).manual_seed(0)
    pool = sampler.pool
    with contextlib.redirect_stdout(io.StringIO()), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        pool_path(dev)
        torch.cuda.synchronize()
    path_ms = kernel_device_ms(prof)
    for k, short in (("forest_sample_batched", "B5"), ("forest_sample_batched_streams", "B6"),
                     ("alias_sample_batched", "B8")):
        out[f"pool path: {short} device ms"] = path_ms[k]
    f = pool.classes[max(pool.classes)].forest
    live = torch.as_tensor(sorted(pool.classes[max(pool.classes)].raw), device=dev)
    did = live[torch.randint(0, len(live), (LANES,), generator=gen, device=dev)].to(torch.int32)
    ctr = torch.randint(-2**31, 2**31, (LANES,), generator=gen, device=dev, dtype=torch.int32)
    off = torch.randint(0, 2**24, (LANES,), generator=gen, device=dev, dtype=torch.int32)
    ar = pool.alias_classes[max(pool.alias_classes)]
    alive = torch.as_tensor(sorted(ar.raw), device=dev)
    did_a = alive[torch.randint(0, len(alive), (LANES,), generator=gen,
                                device=dev)].to(torch.int32)
    xa = torch.rand(LANES, generator=gen, device=dev)
    for co in (False, True):
        b6 = lambda: forest_sample_batched_streams(*f, did, ctr, off, coalesce=co)  # noqa: E731
        b8 = lambda: alias_sample_batched(ar.table.q, ar.table.alias, did_a, xa,  # noqa: E731
                                          coalesce=co)
        for name, fn in (("B6", b6), ("B8", b8)):
            out[f"{name} 2^22 lanes, coalesce={co}: ms one call"] = cuda_ms(fn, 20)
            out[f"{name} 2^22 lanes, coalesce={co}: ms per call"] = cuda_ms_per_call(fn, 20)
    return out


if __name__ == "__main__":
    from ab_runner import main  # beside this file, first on sys.path

    sys.exit(main(__file__, child, "B5/B6/B8, the pool drain's kernels (drains: torch.profiler "
                  "device ms and counts; 2^22 lanes: CUDA events)", __doc__))
