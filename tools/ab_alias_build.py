"""Time B7 (``alias_build_batched``) of two checkouts of this repository on
one card, in turns.

    python3 tools/ab_alias_build.py OLD_DIR NEW_DIR

Each checkout's own ``repro_torch`` (its wrapper, and its kernel library
built at first use under that checkout's ``build/``) runs in a process of
its own, in the order old, new, new, old. Each process builds the same
seeded rows and times, with this checkout's ``chip_smoke.cuda_ms_per_call``,
one row at every pool class 32..65536 and a full 65536 class (164 rows,
each zero from a random length on); then the update latency of an alias
tenant at every class: ``ForestPool.update_weights`` with new weights,
host clock around a synchronized call. Every table is checked valid. Prints
the card's name and power limit, then one line a measurement: old and new,
each the mean of its two processes, and old / new.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CLASSES = tuple(1 << k for k in range(5, 17))
FULL_ROWS = 164
UPDATES = 9


def child(tree: Path) -> dict:
    """The measurements of ``tree``'s B7 in this process."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import numpy as np
    import torch

    from chip_smoke import check, cuda_ms_per_call
    from repro_torch.kernels.alias_build import alias_build_batched
    from repro_torch.pool import ForestPool

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    rows = {str(n): rng.random((1, n)) ** 6 + 1e-9 for n in CLASSES}
    full = rng.random((FULL_ROWS, CLASSES[-1])) ** 6 + 1e-9
    for r, real in enumerate(rng.integers(CLASSES[-1] // 2 + 1, CLASSES[-1] + 1, FULL_ROWS)):
        full[r, real:] = 0.0
    rows[f"{CLASSES[-1]} x{FULL_ROWS}"] = full
    out = {}
    for label, w in rows.items():
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        q, a = alias_build_batched(w)
        check(bool(((q >= 0) & (q <= 1)).all()) and bool(((a >= 0) & (a < w.shape[1])).all()),
              f"valid tables at {label} in {tree}")
        out[f"one build {label}"] = cuda_ms_per_call(lambda: alias_build_batched(w),
                                                     50 if w.shape[0] == 1 else 5)
    pool = ForestPool(device=dev)
    handles = pool.insert_many([rng.random(n) ** 6 + 1e-9 for n in CLASSES], method="alias")
    every = []
    for n, h in zip(CLASSES, handles):
        times = []
        for _ in range(UPDATES + 1):
            new = rng.random(n) ** 6 + 1e-9
            torch.cuda.synchronize()
            t = time.perf_counter()
            pool.update_weights(h, new)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        every += times[1:]
        out[f"update median {n}"] = statistics.median(times[1:])
    out["update median, all classes"] = statistics.median(every)
    out["update max, all classes"] = max(every)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (Path(a).resolve() for a in sys.argv[1:])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    runs = {"old": [], "new": []}
    for which, tree in (("old", old), ("new", new), ("new", new), ("old", old)):
        done = subprocess.run([sys.executable, __file__, "--child", str(tree)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout, done.stderr, file=sys.stderr)
            return 1
        runs[which].append(json.loads(done.stdout.strip().splitlines()[-1]))
    print(f"B7 old ({old}) against new ({new}), ms, mean of two processes each "
          "(builds: cuda_ms_per_call; updates: host clock)", flush=True)
    for key in runs["old"][0]:
        o = statistics.fmean(r[key] for r in runs["old"])
        n = statistics.fmean(r[key] for r in runs["new"])
        print(f"{key}: old {o:.6f} new {n:.6f} old/new {o / n:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
