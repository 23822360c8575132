"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
the ignored ``build/`` directory), then:

1. prints the card's name and power limit and the kernel build time;
2. holds every kernel of the main path against its plain PyTorch version on
   the card, at the main path's shapes, and times kernel, plain version and
   the nearest single PyTorch call with CUDA events;
3. drives the main path at full width: the ``env_map_2d(1024, 1024)``
   weights (n = 2^20 intervals, m = 2^20 guide cells) through
   ``build_forest`` and 2^24 draws through ``sample_forest``, checks the
   card's forest against the plain CPU build from the same CDF bits, every
   draw's bracket, and a chi-square test;
4. serves 8 ``ForestSampler.sample`` calls with duplicate slots and checks
   them against ``sample_binary`` at the same QMC points;
5. prints the kernels line (launch counts from steps 3-4), then the result
   line as the last line of standard output.

Any failed check raises and exits non-zero. Without a CUDA device, or
without the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
SIDE = 1024                 # env_map_2d(SIDE, SIDE): n = m = 2^20 intervals
N_DRAWS = 1 << 24           # uniforms through sample_forest


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Median time of ``fn`` over ``reps`` runs, with CUDA events, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def descent_bytes(f, xi: torch.Tensor) -> int:
    """Bytes ``forest_sample`` must move on this data: each uniform read and
    each index written once, plus each table entry that some lane reads
    (the guide entry of every touched cell; ``fallback`` only in cells
    holding a tree; ``cell_first`` and the bisected ``cdf`` entries only in
    flagged cells; ``cdf`` and one child per level along each descent)."""
    from repro_torch.core.sample import _guide_cell

    seen = {k: torch.zeros(t.numel(), dtype=torch.bool, device=xi.device)
            for k, t in f._asdict().items()}
    g = _guide_cell(xi, f.table.numel())
    seen["table"][g] = True
    j = f.table[g].long()
    tree = j >= 0
    seen["fallback"][g[tree]] = True
    flag = tree & f.fallback[g]
    gf, x = g[flag], xi[flag]
    seen["cell_first"][gf] = True
    seen["cell_first"][gf + 1] = True
    lo, hi = f.cell_first[gf].long(), f.cell_first[gf + 1].long()
    for _ in range(32):
        mid = (lo + hi + 1) >> 1
        seen["cdf"][mid] = True
        up = x >= f.cdf[mid]
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid - 1)
    j[flag] = ~lo
    x = xi
    while True:
        live = j >= 0
        if not bool(live.any()):
            break
        j, x = j[live], x[live]
        seen["cdf"][j] = True
        go_left = x < f.cdf[j]
        seen["left"][j[go_left]] = True
        seen["right"][j[~go_left]] = True
        j = torch.where(go_left, f.left[j], f.right[j]).long()
    table_bytes = sum(int(seen[k].sum()) * f[i].element_size()
                      for i, k in enumerate(f._fields))
    return table_bytes + xi.numel() * 8


def kernel_phase(device, weights: np.ndarray, m: int, n_draws: int, gen):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core import cdf as C
    from repro_torch.core.forest import build_forest, forest_from_cdf
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.cdf_scan import SCAN_ATOL, cdf_scan
    from repro_torch.kernels.forest_delta import forest_delta
    from repro_torch.kernels.forest_sample import forest_sample

    rows_raw = {}
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    rows = C.scan_chunk_rows(w)  # (64, 16384): the main path's row scan

    # cdf_scan: three modes on the main path's rows and on a logits block.
    logits = torch.randn((4, 50257), generator=gen, device=device) * 3.0
    pos = (torch.rand((4, 50257), generator=gen, device=device) + 1e-3) / 50257
    scan_err = 0.0
    for name, x in (("rows", rows), ("logits", logits), ("positive", pos)):
        for softmax, normalize in ((True, True), (False, True), (False, False)):
            if not softmax and name == "logits":
                continue
            got = cdf_scan(x, softmax=softmax, normalize=normalize)
            want = ref.ref_cdf_scan(x, softmax=softmax, normalize=normalize)
            total = want[:, -1:].abs()
            err = (got - want).abs()
            scan_err = max(scan_err, float(err.max()))
            check(bool((err <= SCAN_ATOL * total).all()),
                  f"cdf_scan {name} softmax={softmax} normalize={normalize}")
            print(f"cdf_scan {name}{tuple(x.shape)} softmax={softmax} "
                  f"normalize={normalize}: max |err| / row total = "
                  f"{float((err / total).max()):.3e}", flush=True)
    torch.cuda.synchronize()
    scan_ms = cuda_ms(lambda: cdf_scan(rows, softmax=False, normalize=False), 20)
    scan_plain = cuda_ms(lambda: ref.ref_cdf_scan(rows, False, False), 20)
    scan_lib = cuda_ms(lambda: torch.cumsum(rows, dim=1), 20)
    for name, x, sm in (("logits", logits, True), ("positive", pos, False)):
        t = cuda_ms(lambda: cdf_scan(x, softmax=sm), 20)
        print(f"cdf_scan {name}{tuple(x.shape)} softmax={sm}: {t:.4f} ms", flush=True)
    rows_raw["cdf_scan"] = dict(
        max_abs_err=scan_err, ms=scan_ms, plain_ms=scan_plain,
        library_ms=scan_lib, bound=bound_ms(2 * nbytes(rows), rows.numel()))

    # forest_delta: bit-exact on the main path's lower bounds.
    cdf = C.build_cdf(w, device=device)
    data = C.lower_bounds(cdf).contiguous()
    got, want = forest_delta(data, m), ref.ref_forest_delta(data, m)
    check(torch.equal(got, want), "forest_delta bit-exact")
    # The kernel alone, without the wrapper's int64 widening.
    out32 = torch.empty(data.numel() - 1, dtype=torch.int32, device=device)
    lib, stream = _build.library(), _build.stream_of(data)
    alone = cuda_ms(lambda: lib.rt_forest_delta(
        data.data_ptr(), out32.data_ptr(), data.numel(), m, stream), 20)
    print(f"forest_delta kernel alone (uint32 out): {alone:.4f} ms", flush=True)
    rows_raw["forest_delta"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(lambda: forest_delta(data, m), 20),
        plain_ms=cuda_ms(lambda: ref.ref_forest_delta(data, m), 20),
        library_ms=None,
        bound=bound_ms(nbytes(data) + got.numel() * 8))
    print(f"forest_delta n={data.numel()}: bit-exact", flush=True)

    # forest_sample: elementwise on the full-width forest and three
    # degenerate forests (tied spines, deep dyadic chain).
    f = forest_from_cdf(cdf, m, device=device)
    xi = torch.rand(n_draws, generator=gen, device=device)
    args = (f.cdf, f.table, f.left, f.right, f.cell_first, f.fallback)
    got = forest_sample(*args, xi)
    want = ref.ref_forest_sample(*args, xi)
    check(torch.equal(got, want), "forest_sample full width")
    err = float((got.long() - want.long()).abs().max())
    tied0 = np.zeros(300, np.float32)
    tied0[150] = 1.2
    tied1 = np.zeros(300, np.float32)
    tied1[0], tied1[299] = 1.2, 0.8
    chain = np.asarray([2.0 ** -(i + 1) for i in range(24)] + [2.0 ** -24], np.float32)
    for name, wd, md in (("spike_at_zero", tied0, 16), ("interior_ties", tied1, 16),
                         ("dyadic_chain", chain, 1)):
        fd = build_forest(wd, md, device=device)
        u = torch.rand(4096, generator=gen, device=device)
        for fb in (True, False):
            a = forest_sample(*fd[:4], fd.cell_first, fd.fallback, u, use_fallback=fb)
            b = ref.ref_forest_sample(*fd[:4], fd.cell_first, fd.fallback, u, use_fallback=fb)
            check(torch.equal(a, b), f"forest_sample {name} use_fallback={fb}")
            err = max(err, float((a.long() - b.long()).abs().max()))
        print(f"forest_sample {name}: elementwise equal "
              f"({int(fd.fallback.sum())} flagged cells)", flush=True)
    print(f"forest_sample {n_draws} draws, n=m={m}: elementwise equal", flush=True)
    cdf1 = f.cdf[1:].contiguous()
    rows_raw["forest_sample"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: forest_sample(*args, xi), 20),
        plain_ms=cuda_ms(lambda: ref.ref_forest_sample(*args, xi), 5),
        library_ms=cuda_ms(lambda: torch.searchsorted(cdf1, xi, right=True), 20),
        bound=bound_ms(descent_bytes(f, xi)))
    return rows_raw


def stage_times(device, weights: np.ndarray, m: int) -> dict:
    """Time of each construction stage (median of 5, after a warm-up)."""
    from repro_torch.core import cdf as C
    from repro_torch.core import forest as F

    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    cdf = C.build_cdf(w, device=device)
    data = C.lower_bounds(cdf).contiguous()
    cells = F._cells(data, m)
    d = F._separator_distances(data, m)
    return {
        "scan": cuda_ms(lambda: C.build_cdf(w, device=device), 5),
        "distances": cuda_ms(lambda: F._separator_distances(data, m), 5),
        "cell_trees": cuda_ms(lambda: F._build_cell_trees(data, d, cells, m=m), 5),
        "total": cuda_ms(lambda: F.build_forest(w, m, device=device), 5),
    }


def device_profile(device, weights: np.ndarray, m: int, n_draws: int, gen) -> None:
    """Device busy share and the heaviest kernels of one build_forest and
    one sample_forest call, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.forest import build_forest
    from repro_torch.core.sample import sample_forest

    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    forest = build_forest(w, m, device=device)
    xi = torch.rand(n_draws, generator=gen, device=device)
    calls = (("build_forest", lambda: build_forest(w, m, device=device)),
             ("sample_forest", lambda: sample_forest(forest, xi, device=device)))
    for name, fn in calls:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        kernels = [e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        def dev_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)
        busy_ms = sum(dev_us(e) for e in kernels) / 1e3
        if busy_ms <= 0:
            print(f"profile {name}: device time not measured by the profiler", flush=True)
            continue
        top = sorted(kernels, key=dev_us, reverse=True)[:6]
        print(f"profile {name}: wall {wall_ms:.3f} ms (profiled), device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
              f"{sum(e.count for e in kernels)} kernel launches; top: "
              + "; ".join(f"{e.key[:48]} x{e.count} {dev_us(e) / 1e3:.3f} ms"
                          for e in top), flush=True)


def main_path(device, weights: np.ndarray, m: int, n_draws: int, gen) -> None:
    """build_forest + sample_forest at full width, then the serving calls."""
    from repro_torch.core import forest_from_cdf, forest_to_numpy
    from repro_torch.core.forest import build_forest
    from repro_torch.core.metrics import chi2_statistic, histogram
    from repro_torch.core.sample import sample_binary, sample_forest
    from repro_torch.serve.sampler import ForestSampler, QmcStreams

    n = weights.shape[0]
    t = time.perf_counter()
    forest = build_forest(weights, m, device=device)
    torch.cuda.synchronize()
    print(f"build_forest n={n} m={m}: {(time.perf_counter() - t) * 1e3:.3f} ms "
          f"(host clock, first call)", flush=True)

    xi = torch.rand(n_draws, generator=gen, device=device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    idx = sample_forest(forest, xi, device=device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    print(f"sample_forest {n_draws} draws: {dt * 1e3:.3f} ms, "
          f"{n_draws / dt:.6e} draws/s (host clock, first call)", flush=True)

    # Serving: 8 calls with duplicate slots, against sample_binary.
    n_slots = 1 << 16
    sampler = ForestSampler(weights, m=m, n_slots=n_slots, seed=0, device=device)
    twin = QmcStreams(n_slots, seed=0)
    rng = np.random.default_rng(7)
    expect_counters = np.zeros(n_slots, np.int64)
    served = []
    for call in range(8):
        slots = rng.integers(0, n_slots, size=n_slots // 2 + 1000 * call)
        slots[: 64] = slots[64:128]  # force duplicate slots in every call
        got = sampler.sample(slots)
        served.append((slots, got, twin.next(slots)))
        np.add.at(expect_counters, slots, 1)
        check(np.array_equal(sampler.streams.counters.astype(np.int64),
                             expect_counters), f"serving counters, call {call}")
    torch.cuda.synchronize()

    # Checks (after the counted run): forest vs plain CPU build from the
    # same CDF bits, draw brackets, chi-square, serving vs sample_binary.
    cdf_host = forest.cdf.cpu()
    plain = forest_to_numpy(forest_from_cdf(cdf_host, m, device="cpu"))
    card = forest_to_numpy(forest)
    for key in card:
        check(card[key].dtype == plain[key].dtype and np.array_equal(card[key], plain[key]),
              f"card forest == plain CPU forest: {key}")
    print("forest: card == plain CPU build from the same CDF bits, all six arrays",
          flush=True)
    i = idx.long()
    check(bool(((forest.cdf[i] <= xi) & (xi < forest.cdf[i + 1])).all()),
          "every draw satisfies cdf[i] <= xi < cdf[i+1]")
    p = weights.astype(np.float64) / weights.astype(np.float64).sum()
    cdf64 = np.concatenate([[0.0], np.cumsum(p)])
    bins = np.minimum((cdf64[:-1] + cdf64[1:]) * 0.5 * 1024, 1023).astype(np.int64)
    counts = np.bincount(bins, weights=histogram(idx.cpu().numpy(), n), minlength=1024)
    mass = np.bincount(bins, weights=p, minlength=1024)
    used = mass > 0
    chi2 = chi2_statistic(counts[used], mass[used] / mass[used].sum())
    dof = int(used.sum()) - 1
    limit = dof + 6.0 * np.sqrt(2.0 * dof)
    print(f"chi-square over {int(used.sum())} equal-mass bins: {chi2:.3f} "
          f"(dof {dof}, limit {limit:.3f})", flush=True)
    check(chi2 < limit, "chi-square goodness of fit")
    scdf = sampler.forest.cdf
    for call, (slots, got, pts) in enumerate(served):
        want = sample_binary(scdf, pts, device=device).long()
        got_t = torch.as_tensor(got, dtype=torch.int64, device=device)
        check(torch.equal(scdf[got_t], scdf[want]), f"serving call {call} vs sample_binary")
    print(f"serving: 8 calls, {sum(len(s) for s, _g, _p in served)} draws == "
          f"sample_binary at the same QMC points; counters exact", flush=True)


def run() -> dict:
    """The whole smoke run on the card; returns the kernels record."""
    from repro_torch.configs.paper_workloads import env_map_2d
    from repro_torch.kernels.cdf_scan import cdf_scan
    from repro_torch.kernels.forest_delta import forest_delta
    from repro_torch.kernels.forest_sample import forest_sample

    device = torch.device("cuda")
    weights = env_map_2d(SIDE, SIDE, seed=0).reshape(-1).astype(np.float32)
    m = weights.shape[0]
    n_draws = N_DRAWS
    gen = torch.Generator(device=device).manual_seed(0)

    raw = kernel_phase(device, weights, m, n_draws, gen)
    stages = stage_times(device, weights, m)
    print("construction stages (ms, median of 5): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()), flush=True)
    device_profile(device, weights, m, n_draws, gen)

    wrappers = {"cdf_scan": cdf_scan, "forest_delta": forest_delta,
                "forest_sample": forest_sample}
    for fn in wrappers.values():
        fn.launches = 0
    main_path(device, weights, m, n_draws, gen)
    launches = {k: fn.launches for k, fn in wrappers.items()}

    replaces = {
        "cdf_scan": "src/repro/kernels/cdf_scan.py:78",
        "forest_delta": "src/repro/kernels/forest_delta.py:37",
        "forest_sample": "src/repro/kernels/forest_sample.py:320",
    }
    kernels = []
    for name in ("cdf_scan", "forest_delta", "forest_sample"):
        r = raw[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        })
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} launched on the main path")
    return {"kernels": kernels}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    from repro_torch.kernels import _build

    t = time.perf_counter()
    _build.library()
    print(f"kernel library built and loaded in {time.perf_counter() - t:.3f} s", flush=True)

    record = run()
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
