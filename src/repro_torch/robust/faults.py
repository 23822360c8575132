"""Fault-injection chaos harness for the serving pool: the port of the JAX
package's ``robust/faults.py``.

A :class:`FaultPlan` schedules adversarial events against a churning
multi-tenant :class:`~repro_torch.pool.ForestPool`; :func:`run_chaos`
executes the plan against a twin-pool oracle: a chaos pool that sees every
fault and a clean pool that never does, both serving the same co-tenant
schedule on ``device``. After every step the harness holds the robustness
contract:

- every fault is contained: caught as a structured
  :mod:`repro_torch.robust.errors` class (or absorbed by the clamp /
  quarantine policy), never an unhandled crash;
- co-tenants are never corrupted: their drains stay bit-identical to the
  clean pool's;
- :func:`repro_torch.robust.verify.verify_pool` passes after every step.

Fault kinds: ``bad_insert`` / ``bad_update`` (NaN / Inf / negative /
all-zero / denormal weight rows), ``stale_drain`` (drain through an
evicted handle), ``double_evict``, and ``kill`` (invokes ``kill_hook``;
in-process runs just record it). The schedule and every random draw come
from the same numpy generators as the JAX package's, so one plan and seed
give both packages the same faults, codes and quarantines.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .errors import ServingError
from .verify import verify_pool

__all__ = ["Fault", "FaultPlan", "run_chaos"]

_BAD_ROWS = {
    "nan": lambda n: np.where(np.arange(n) == 1, np.nan, 1.0),
    "inf": lambda n: np.where(np.arange(n) == 0, np.inf, 1.0),
    "neg": lambda n: np.where(np.arange(n) == 2 % n, -1.0, 2.0),
    "zero": lambda n: np.zeros(n),
    "denormal": lambda n: np.full(n, 5e-324),
}


@dataclasses.dataclass(frozen=True)
class Fault:
    step: int
    kind: str        # bad_insert | bad_update | stale_drain | double_evict | kill
    flavor: str = "nan"  # which _BAD_ROWS generator (weight faults only)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    faults: tuple

    @classmethod
    def default(cls, steps: int = 24, seed: int = 0) -> "FaultPlan":
        """A dense pseudo-random schedule touching every fault kind and
        every adversarial weight flavor within ``steps`` churn steps."""
        rng = np.random.default_rng(seed)
        kinds = ["bad_insert", "bad_update", "stale_drain", "double_evict"]
        flavors = list(_BAD_ROWS)
        faults = []
        for step in range(steps):
            if rng.random() < 0.5:
                faults.append(Fault(
                    step=step,
                    kind=kinds[int(rng.integers(len(kinds)))],
                    flavor=flavors[int(rng.integers(len(flavors)))],
                ))
        return cls(faults=tuple(faults))

    def at(self, step: int):
        return [f for f in self.faults if f.step == step]


def run_chaos(plan: FaultPlan, *, steps: int = 24, policy: str = "quarantine",
              seed: int = 0, n_tenants: int = 6, kill_hook=None,
              device="cuda") -> dict:
    """Execute ``plan`` against the twin-pool oracle on ``device``; returns
    a report: ``drains_equal`` (co-tenant drains stayed bit-identical to
    the clean pool on every step), ``verify_errors`` (accumulated
    :func:`verify_pool` violations; empty = healthy), ``caught`` (the
    ``(step, kind, code)`` of every structured error a fault produced),
    ``injected`` (fault count), ``kills`` and ``quarantined`` (final
    quarantine count)."""
    from repro_torch.pool import ForestPool  # lazy: robust.errors has no pool dep

    rng = np.random.default_rng(seed)
    chaos = ForestPool(policy=policy, device=device)
    clean = ForestPool(policy="reject", device=device)
    sizes = [int(rng.integers(3, 20)) for _ in range(n_tenants)]
    weights = [rng.random(n) + 1e-3 for n in sizes]
    methods = ["forest" if i % 2 == 0 else "alias" for i in range(n_tenants)]
    ch = chaos.insert_many(weights, method=methods)
    cl = clean.insert_many(weights, method=methods)

    report = dict(drains_equal=True, verify_errors=[], caught=[], injected=0, kills=0)
    for step in range(steps):
        # co-tenant churn: the same clean update against both pools
        t = int(rng.integers(n_tenants))
        upd = rng.random(sizes[t]) + 1e-3
        chaos.update_weights(ch[t], upd)
        clean.update_weights(cl[t], upd)

        for f in plan.at(step):
            report["injected"] += 1
            try:
                if f.kind == "bad_insert":
                    n = int(rng.integers(3, 12))
                    chaos.insert(_BAD_ROWS[f.flavor](n))
                elif f.kind == "bad_update":
                    v = int(rng.integers(n_tenants))
                    chaos.update_weights(ch[v], _BAD_ROWS[f.flavor](sizes[v]))
                    # keep the twins in sync: restore the tenant's good
                    # weights in both pools (clean never sees the bad row)
                    good = rng.random(sizes[v]) + 1e-3
                    chaos.update_weights(ch[v], good)
                    clean.update_weights(cl[v], good)
                elif f.kind == "stale_drain":
                    tmp = chaos.insert(rng.random(5) + 1e-3)
                    chaos.evict(tmp)
                    chaos.sample([tmp], np.asarray([0.5], np.float32))
                elif f.kind == "double_evict":
                    tmp = chaos.insert(rng.random(5) + 1e-3)
                    chaos.evict(tmp)
                    chaos.evict(tmp)
                elif f.kind == "kill":
                    report["kills"] += 1
                    if kill_hook is not None:
                        kill_hook(step)
                else:
                    raise ValueError(f"unknown fault kind {f.kind!r}")
            except ServingError as e:
                report["caught"].append((step, f.kind, e.code))
            except ValueError as e:
                report["caught"].append((step, f.kind, str(e)))

        # co-tenant conformance drain: same uniforms, both pools
        xi = rng.random(2 * n_tenants).astype(np.float32)
        got = chaos.sample([ch[i % n_tenants] for i in range(len(xi))], xi)
        want = clean.sample([cl[i % n_tenants] for i in range(len(xi))], xi)
        if not np.array_equal(got, want):
            report["drains_equal"] = False
        report["verify_errors"].extend(verify_pool(chaos))

    report["quarantined"] = len(chaos.quarantined)
    return report
