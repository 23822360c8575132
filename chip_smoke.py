"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
the ignored ``build/`` directory), then:

1. prints the card's name and power limit and the kernel build time;
2. holds every kernel of the single-distribution path against its plain
   PyTorch version on the card, at that path's shapes, and times kernel,
   plain version and the nearest single PyTorch call with CUDA events, per
   call (``cuda_ms_per_call``) and, for B1 and B2, also one call; B1
   (``forest_sample``) with both ``use_fallback`` values on the pack the
   samplers make once per forest (``forest_pack``, held bit for bit to its
   plain version and timed, and its time in the construction stage line),
   with sector-traffic estimates for the six arrays and for that layout;
3. drives that path at full width: the ``env_map_2d(1024, 1024)`` weights
   (n = 2^20 intervals, m = 2^20 guide cells) through ``build_forest`` and
   2^24 draws through ``sample_forest``, checks the card's forest against
   the plain CPU build from the same CDF bits, every draw's bracket, and a
   chi-square test; serves 8 ``ForestSampler.sample`` calls with duplicate
   slots and checks them against ``sample_binary`` at the same QMC points;
   3a. the examples path (``examples_path``): the seven walkthroughs
   ``examples/torch_*.py`` on the card, one after another, each in its own
   process (``EXAMPLE_RUNNER``: JAX and the JAX package unimportable, the
   run under torch.profiler), at their default sizes but
   ``torch_train_lm.py``'s 40 of 300 steps; a line each with its exit code,
   wall seconds and last lines; every example must exit 0 (each asserts
   what its JAX twin asserts), and the kernels they launch, counted and
   timed in their processes, are the path's;
4. runs the paper's workloads on the card (``benchmarks/torch_table1.py``
   and ``benchmarks/torch_convergence.py``: Table 1's load counts, the 1-D
   convergence up to 2^18 points, the 2-D one on ``env_map_2d(128, 256)``
   up to 2^20, the discrepancy of Fig. 1) and prints their lines; checks
   the card's forests against the plain CPU builds from the same CDF bits
   and the counts and histograms against the plain CPU path on them;
5. drives the map2d path: a ``SpatialSampler`` over ``env_map_2d(2048,
   4096)`` (a 4K equirectangular HDR map, 8.4M texels, one size class)
   with 2^16 device QMC slots, 8 drains of 2^20 slot occurrences, the fused
   drain once under ``torch.cuda.set_sync_debug_mode("error")``, an
   update of 64 rows in each form (new weights, deltas), one more drain, a
   snapshot and restore; a seeded ragged map of 2048 rows over every class
   8..4096 (the multi-class drain, one grouped launch); a prior-only
   ``ServeEngine`` serving 16 ``prior2d`` requests on the 4K map. Every
   drain is checked against the plain versions at the same points on CPU
   copies of the card's arrays, the points and counters against a host
   ``Qmc2Streams``, the builds against plain CPU builds from the same CDF
   bits, the updated map against a fresh build, and a chi-square over 64 x
   64 texel blocks; prints build times, draws/s, update latency and the
   device idle share of one drain;
6. drives the pool path: a ``PooledForestSampler`` over a ``ForestPool`` of
   4096 tenants (sizes 17 to 65536 in 12 power-of-two classes, ~45M padded
   cells, even tenants forest, odd alias, 16 tied and 64 dyadic ones):
   one admission wave, 8 QMC stream drains of 2^20 draws over 2^16 slots,
   one drain of 2^20 host uniforms, 512 weight updates, 256 evictions and
   256 re-inserts, one more stream drain. Every drain is checked against
   the plain versions at the same points and the stream counters against a
   host ``QmcStreams`` twin; after the run, forest rows against the plain
   CPU build from the same CDF bits, the alias build (bit-exact on dyadic
   tenants, valid and mass-conserving on all), a per-tenant chi-square;
7. holds each pool kernel against its plain version at 2^22 lanes on the
   largest class's stacks and times it (B5, B6 and B8 with two
   sector-traffic estimates beside the byte bound); holds B6 and B8 at the
   drain's shape (the last stream drain's lanes of each method over all its
   classes, one grouped launch) against their plain versions and the
   drain's draws and times them; times ``alias_build_batched`` on one
   row at every pool class 32..65536 and on a full 65536 class; prints
   admission times by class, the device idle share of one drain, the
   device ms, kernel launches and copies of one stream and one
   host-uniform drain, and the host profile of one drain;
8. drives the serve path: a ``ServeEngine`` (16 slots, 256-token KV budget)
   over Qwen1.5-0.5B at full width in bfloat16 with seeded random weights,
   serving 32 model-backed requests (prompts of 8 to 64 tokens, 32 new
   tokens each, ``inverse_qmc``) and 4 prior-backed ones; every sampler
   call's tokens are checked against the plain inverse on the same card CDF
   rows, and those rows against the plain scan; then decode-after-prefill
   in float32 at full width, a chi-square of 2^20 draws from one decode row,
   a few steps in ``inverse_rng`` and ``alias`` mode, the launcher
   (``python -m repro_torch.launch.serve``) once, and the device idle share
   of one decode step; the launch floor (the kernel library's empty kernel,
   per call); ``sample_rows`` alone at (16, 151936) and (256, 151936), timed
   beside its plain version and ``torch.searchsorted``, against its byte
   bound and the floor;
   ``cdf_scan`` (B3) at the decode shape (16, 151936) in bf16 and float32,
   timed beside its plain version, softmax plus cumsum (two library calls)
   and cumsum alone; a row's scan bits checked alone, in a stack of 7 and
   in the whole stack, and from run to run, in every regime of its plan;
9. the train phase: the SASS check that every B10 instance runs on the
   tensor cores (``HGMMA`` in the bf16 and the float32 ones),
   with the library's build time; ``flash_attention`` (B10) against its
   plain version at the eval shape (2, 2048, 16 heads, hd 64, bf16,
   causal), Qwen3-4B's GQA (1, 1024, 32/8 heads, hd 128), a ragged
   non-causal float32 case (1, 1000, 4/2 heads, hd 64) and the eval shape in
   float32, timed beside the plain version and
   ``scaled_dot_product_attention``, with the achieved TFLOP/s and the share
   of the bound's rate (float32: both bounds, the work on the CUDA cores and
   the three TF32 products on the tensor cores);
   the eval path, ``loss_fn`` without gradients over Qwen1.5-0.5B at full
   width in bf16 on a 2 x 2048 ``make_batch`` batch, flash against einsum
   (B10 launched once per layer), and the device profile of one forward;
   the train path, the ``Trainer`` at the same widths (float32 masters,
   bf16 compute, global batch 8 x 256) for 4 steps, then a run killed at
   step 2 and resumed, bitwise equal under deterministic algorithms; the
   mixture's forest kernels counted; step time, the profile of one step,
   and the training launcher once in a subprocess;
   9b. the families phase (``families_path``): the six LM families beyond
   the dense one, one model at a time in bf16 with seeded weights, each
   freed before the next and its cut printed (``FAMILIES``: xLSTM-1.3B
   uncut, Kimi K2 and Llama 4 Maverick one layer each, Jamba 1.5 Large one
   period at d_model 4096, Whisper-small uncut with 1500 frames, InternVL2
   16 layers): a 16-slot ``ServeEngine`` (for Whisper and InternVL,
   ``prefill`` and ``decode_step`` over 16 rows), every sampler call
   checked against the plain versions; decode after prefill against
   prefill of the longer prompt, drop-free (Whisper also in float32);
   flash against einsum eval nll with B10 once per attention layer;
   prefill ms, decode tokens/s, a decode step's launches and idle share,
   peak memory, and each model's B3/B9/B10 launches (their device ms from
   the path's second run, each model under torch.profiler);
   9c. the families' training path (``families_train_path``): the same six
   families with float32 masters and bf16 compute, one at a time, each cut
   printed beside the published config's train state (``FAMILY_TRAIN``:
   xLSTM-1.3B 24 of 48 layers, Whisper-small uncut, InternVL2 2 layers,
   Kimi K2 one layer with 16 experts, Llama 4 one layer with 8, Jamba one
   period at the serve cut with 2 experts; 8 x 256, Jamba 4 x 256): the
   first step repeated bitwise under deterministic algorithms (Whisper: its
   Trainer killed at step 2 and resumed instead, after the path), bf16 against
   float32 compute at one layer, a warm step and 3 timed
   ``make_train_step`` steps on a ``MixtureSampler``'s batches (B3, B2,
   B1), losses finite and falling, one step profiled; ms a step,
   tokens/s, the model-FLOPs share of the card's bf16 rate
   (``launch.analytic``), peak memory under 72 GiB, launches and idle
   share a step (its device ms from a replay of each family's mixture
   and batches under torch.profiler, the only launches of the port's
   kernels on this path);
   9d. the dist_lm path (``dist_lm_path``) on a (1, 1) ``DeviceMesh`` over
   the dist phase's single-rank nccl group: Qwen1.5-0.5B at full width,
   each run against the unsharded model on the same inputs, bit for bit
   (at world size 1 every spec sanitizes to ``Replicate``): 2 train steps
   (8 x 256, float32 masters, bf16 compute, deterministic algorithms) of
   a model distributed by ``Policy.recommended(cfg, mesh, "train")`` on a
   ``MixtureSampler``'s batches (built twice, so a late profiler window
   keeps the second build's records), then 3 timed and one profiled step
   each; the compressed pod all-reduce of one step's gradients; the flash
   eval forward (2 x 2048, B10 through ``dist.local``) under
   ``Policy.for_mesh`` with gather and sequence hints; 4
   ``make_serve_step`` steps (B3, B9) over 16 rows on a
   ``cache_spec_tree``-placed cache under the decode preset; ms a step,
   launches and idle share sharded beside unsharded, the peak; then,
   outside the path's counts (``dist_lm_checks``), a Trainer checkpoint
   saved unsharded at step 2 restored into a sharded Trainer
   (``restore(shardings=)``) and its next step, bit for bit, and B10 on a
   rank's local query heads at a head offset against its plain version;
   9e. the dist_families path (``dist_families_path``) on the same mesh:
   each family of ``FAMILIES`` at its cut in bf16 (the MoE, Mamba and
   xLSTM local forms, the encoder, the embedding frontend): prefill of 16
   rows, 4 timed and one profiled ``make_serve_step`` steps (B3, B9) and
   the flash eval forward (B10), unsharded, then the same weights
   distributed in place (one copy resident) under
   ``Policy.recommended(cfg, mesh, "decode")`` and under JAX's 2-D
   ``shard_seq`` preset on a ``cache_spec_tree``-placed cache, logits,
   tokens, caches and nll bit for bit; then one train step of Kimi's and
   Jamba's ``FAMILY_TRAIN`` cuts under ``recommended(train)`` on the
   mixture's batches (B1-B3), unsharded and then sharded from the same
   seed, loss, gradient norm and every parameter bit for bit, a second
   step of each profiled; decode and train ms sharded beside unsharded,
   launches and idle share, peak under 72 GiB; the kernel-launching calls
   run in profiler windows, whose device ms and records are the path's;
   9f. the dryrun path (``dryrun_path``): ``python -m
   repro_torch.launch.dryrun --auto-policy`` in subprocesses with no card
   visible (``meta`` tensors, a fake world of 256 ranks) for Qwen1.5-0.5B
   ``train_4k`` and Kimi K2 ``decode_32k`` (2-D TP across the InfiniBand
   dims): ``status: ok``, build and trace seconds, argument and temp bytes
   a rank, the three roofline terms and the dominant one; and the dry
   run's prediction of the dist_lm train cell (Qwen1.5-0.5B, 8 x 256,
   remat none, ``Policy.recommended(train)``, a fake world of one rank)
   against the real step on the (1, 1) nccl mesh: the predicted argument
   bytes a rank equal the real state's (parameters, AdamW moments and
   step, the int32 batch) exactly, the measured step ms (median of 3 after
   one) is at least ``max(t_compute, t_mem)``; printed beside them, the
   predicted peak (arguments plus temp) and the measured one (the state
   plus the step's ``max_memory_allocated`` growth), and
   ``roofline_fraction``;
   3b. the dist phase (``dist_path``) on a single-rank nccl group: the
   same weights through ``build_cdf_sharded`` and ``build_forest_sharded``,
   the 2^24 uniforms through ``sample_sharded`` routed and with the
   all-reduce oracle, the drain plan, a 64-leaf ``update_forest_sharded``;
   ``dist_checks``: ``gather_forest`` against ``build_forest`` bit for bit,
   both drains against ``sample_forest``, the update against a
   from-scratch sharded build; B2, B3 and B4 must launch there;
   7b. the robust phase (``robust_path``) on the pool phase's own pool:
   ``save_serving`` of the ``PooledForestSampler`` under ``build/``, load and
   restore (bytes on disk, save/load/restore seconds), 2 drains of 2^20 and
   the counters equal to the original's, ``verify_pool(deep=True)`` clean
   and timed, then a NaN written into one arena row named by it;
   ``run_chaos(FaultPlan.default(24, seed=0))`` under quarantine, clamp and
   reject; a 4K ``SpatialSampler`` and a model-backed ``ServeEngine``
   (Qwen1.5-0.5B, 16 slots, KV cache) saved mid-flight through disk, their
   next drains and tokens equal to the originals';
10. prints the kernels line (launch counts from the runs of steps 3, 3a, 3b,
   4, 5, 6, 7b, 8, 9's eval and train paths, 9b, 9c, 9d and 9e, each with
   every count set to 0 just before it (3a's in each example's own
   process); each kernel's launches and summed device time on each of the
   fourteen paths, main, examples, dist, paper, map2d, pool, robust, serve,
   eval, train, families, families_train, dist_lm and dist_families: the
   time from torch.profiler, CUDA activity only, by the kernels' symbols,
   around a second counted run of each path (of examples, the one run in
   each example's process; of train
   and families_train, a replay of their mixtures and batches; of dist_lm,
   the path without its train steps: those steps launch none of the port's
   kernels; of dist_families, its own profiler windows in its one run) at
   the end, printed with the device records
   beside the launches, so the first runs' times carry no tracing cost; ``cdf_scan``
   also carries its decode-shape times as ``at_decode``, B6 and B8 their
   drain-shape times as ``at_drain``, B9 its shapes and the launch floor as
   ``at_shapes`` and ``launch_floor_ms``, B10 its float32 rows as
   ``at_f32`` and its hd-112 row as ``at_hd112``), then the result line as
   the last line of standard output.

Any failed check raises and exits non-zero. Without a CUDA device, or
without the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
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


def cuda_ms_per_call(fn, n: int, reps: int = 5) -> float:
    """Time per call of ``fn`` on the card, for microsecond kernels whose
    single call under CUDA events times the host's launch: the card first
    spins (``torch.cuda._sleep``) while the host enqueues ``n`` calls, then
    runs them back to back between one pair of events; the time is divided
    by ``n`` (median of ``reps``, after one warm-up call). The spin doubles
    until the host finishes enqueueing before the card reaches the first
    event, so no host gap lies between the events."""
    fn()
    torch.cuda.synchronize()
    cycles, times = 1 << 24, []
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        covered = not a.query()
        b.record()
        b.synchronize()
        if covered:
            times.append(a.elapsed_time(b) / n)
        else:
            check(cycles < 1 << 32, "card spin covers the host's enqueue")
            cycles *= 2
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float = 0.0,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def degenerate_forests(device) -> dict:
    """The three degenerate forests B1 is held on: a spike at zero and
    interior ties (tied spines, flagged cells) and a deep dyadic chain."""
    from repro_torch.core.forest import build_forest

    tied0 = np.zeros(300, np.float32)
    tied0[150] = 1.2
    tied1 = np.zeros(300, np.float32)
    tied1[0], tied1[299] = 1.2, 0.8
    chain = np.asarray([2.0 ** -(i + 1) for i in range(24)] + [2.0 ** -24], np.float32)
    return {name: build_forest(wd, md, device=device)
            for name, wd, md in (("spike_at_zero", tied0, 16), ("interior_ties", tied1, 16),
                                 ("dyadic_chain", chain, 1))}


def packed_descent_reads(f, xi: torch.Tensor) -> int:
    """32-byte sector reads of B1's descent over its packed layout on this
    data, no sector shared between lanes: one a lane for the guide entry
    (the flag folded in), 34 more a flagged lane (``cell_first`` twice, 32
    bisection steps), one a level for the node record."""
    from repro_torch.core.sample import _bisect, _guide_cell

    g = _guide_cell(xi, f.m)
    j = f.table[g].long()
    flag = (j >= 0) & f.fallback[g]
    reads = xi.numel() + 34 * int(flag.sum())
    j = torch.where(flag, ~_bisect(f.cdf, xi, f.cell_first[g], f.cell_first[g + 1], 32), j)
    left, right = f.left.long(), f.right.long()
    while bool((j >= 0).any()):
        live = j >= 0
        reads += int(live.sum())
        jj = torch.clamp(j, 0, f.n - 1)
        j = torch.where(live, torch.where(xi < f.cdf[jj], left[jj], right[jj]), j)
    return reads


def kernel_phase(device, weights: np.ndarray, m: int, n_draws: int, gen):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core import cdf as C
    from repro_torch.core.forest import RadixForest, forest_from_cdf
    from repro_torch.kernels import ref
    from repro_torch.kernels.cdf_scan import SCAN_ATOL, cdf_scan
    from repro_torch.kernels.forest_delta import forest_delta
    from repro_torch.kernels.forest_sample import forest_pack, forest_sample

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
    # Microsecond scans: per call, queued behind a card spin (cuda_ms_per_call).
    scan_ms = cuda_ms_per_call(lambda: cdf_scan(rows, softmax=False, normalize=False), 100)
    scan_plain = cuda_ms_per_call(lambda: ref.ref_cdf_scan(rows, False, False), 20)
    scan_lib = cuda_ms_per_call(lambda: torch.cumsum(rows, dim=1), 100)
    for name, x, sm in (("logits", logits, True), ("positive", pos, False)):
        t = cuda_ms_per_call(lambda: cdf_scan(x, softmax=sm), 100)
        print(f"cdf_scan {name}{tuple(x.shape)} softmax={sm}: {t:.6f} ms per call", flush=True)
    rows_raw["cdf_scan"] = dict(
        max_abs_err=scan_err, ms=scan_ms, plain_ms=scan_plain,
        library_ms=scan_lib, bound=bound_ms(2 * nbytes(rows), rows.numel()))

    # forest_delta: bit-exact on the main path's lower bounds.
    cdf = C.build_cdf(w, device=device)
    data = C.lower_bounds(cdf).contiguous()
    got, want = forest_delta(data, m), ref.ref_forest_delta(data, m)
    check(torch.equal(got, want), "forest_delta bit-exact")
    # The bound counts the uint32 distances the function needs (4 B each);
    # the kernel writes their int64 form (8 B), which the build compares.
    rows_raw["forest_delta"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms_per_call(lambda: forest_delta(data, m), 100),
        one_call_ms=cuda_ms(lambda: forest_delta(data, m), 20),
        plain_ms=cuda_ms_per_call(lambda: ref.ref_forest_delta(data, m), 20),
        library_ms=None,
        bound=bound_ms(nbytes(data) + got.numel() * 4))
    print(f"forest_delta n={data.numel()}: bit-exact; {rows_raw['forest_delta']['ms']:.6f} ms "
          f"per call, {rows_raw['forest_delta']['one_call_ms']:.6f} one call", flush=True)

    # forest_sample: elementwise on the full-width forest and three
    # degenerate forests (tied spines, deep dyadic chain), the pack made once
    # as the samplers make it; forest_pack bit-exact.
    f = forest_from_cdf(cdf, m, device=device)
    pk = forest_pack(f.cdf, f.table, f.left, f.right, f.fallback)
    pk_want = ref.ref_forest_pack(f.cdf, f.table, f.left, f.right, f.fallback)
    check(all(torch.equal(a, b) for a, b in zip(pk, pk_want)), "forest_pack bit-exact")
    xi = torch.rand(n_draws, generator=gen, device=device)
    args = (f.cdf, f.table, f.left, f.right, f.cell_first, f.fallback)
    err = 0.0
    for fb in (True, False):
        got = forest_sample(*args, xi, use_fallback=fb, packed=pk)
        want = ref.ref_forest_sample(*args, xi, use_fallback=fb)
        check(torch.equal(got, want), f"forest_sample full width use_fallback={fb}")
        err = max(err, float((got.long() - want.long()).abs().max()))
    for name, fd in degenerate_forests(device).items():
        u = torch.rand(4096, generator=gen, device=device)
        for fb in (True, False):
            a = forest_sample(*fd[:4], fd.cell_first, fd.fallback, u, use_fallback=fb)
            b = ref.ref_forest_sample(*fd[:4], fd.cell_first, fd.fallback, u, use_fallback=fb)
            check(torch.equal(a, b), f"forest_sample {name} use_fallback={fb}")
            err = max(err, float((a.long() - b.long()).abs().max()))
        print(f"forest_sample {name}: elementwise equal "
              f"({int(fd.fallback.sum())} flagged cells)", flush=True)
    print(f"forest_sample {n_draws} draws, n=m={m}: elementwise equal, both use_fallback; "
          f"forest_pack bit-exact", flush=True)
    cdf1 = f.cdf[1:].contiguous()
    traffic = descent_bytes(RadixForest(*(t[None] for t in f)),
                            torch.zeros_like(xi, dtype=torch.int32), xi, 8)
    packed = 8 * xi.numel() + 32 * packed_descent_reads(f, xi)
    rows_raw["forest_sample"] = dict(
        max_abs_err=err,
        ms=cuda_ms_per_call(lambda: forest_sample(*args, xi, packed=pk), 20),
        one_call_ms=cuda_ms(lambda: forest_sample(*args, xi, packed=pk), 20),
        plain_ms=cuda_ms(lambda: ref.ref_forest_sample(*args, xi), 5),
        library_ms=cuda_ms_per_call(lambda: torch.searchsorted(cdf1, xi, right=True), 20),
        bound=bound_ms(traffic[0]), sector_ms=sector_ms(traffic),
        packed_sector_ms=packed / HBM_BYTES_PER_S * 1e3)
    r = rows_raw["forest_sample"]
    print(f"forest_sample {n_draws} draws: {r['ms']:.6f} ms per call, {r['one_call_ms']:.6f} "
          f"one call; bound {r['bound'][0]:.6f}; sectors {r['sector_ms'][0]:.6f} / "
          f"{r['sector_ms'][1]:.6f}, packed layout {r['packed_sector_ms']:.6f}", flush=True)
    # forest_pack: 4 B of cdf, left and right a node, 4 B of table and 1 B of
    # fallback a cell in; 16 B a node record and 4 B a guide entry out.
    n = f.n
    rows_raw["forest_pack"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms_per_call(lambda: forest_pack(f.cdf, f.table, f.left, f.right, f.fallback), 50),
        one_call_ms=cuda_ms(lambda: forest_pack(f.cdf, f.table, f.left, f.right, f.fallback), 20),
        plain_ms=cuda_ms_per_call(
            lambda: ref.ref_forest_pack(f.cdf, f.table, f.left, f.right, f.fallback), 10),
        library_ms=None,
        bound=bound_ms(4 * (n + 1) + 8 * n + 5 * m + 16 * n + 4 * m))
    return rows_raw


def stage_times(device, weights: np.ndarray, m: int) -> dict:
    """Time of each construction stage (median of 5, after a warm-up); the
    total is ``build_forest``'s, and the pack (``forest_pack``, made once
    per forest by the samplers) follows it."""
    from repro_torch.core import cdf as C
    from repro_torch.core import forest as F
    from repro_torch.core.sample import pack_forest

    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    cdf = C.build_cdf(w, device=device)
    data = C.lower_bounds(cdf).contiguous()
    cells = F._cells(data, m)
    d = F._separator_distances(data, m)
    forest = F.build_forest(w, m, device=device)
    return {
        "scan": cuda_ms(lambda: C.build_cdf(w, device=device), 5),
        "distances": cuda_ms(lambda: F._separator_distances(data, m), 5),
        "cell_trees": cuda_ms(lambda: F._build_cell_trees(data, d, cells, m=m), 5),
        "total": cuda_ms(lambda: F.build_forest(w, m, device=device), 5),
        "pack": cuda_ms(lambda: pack_forest(forest), 5),
    }


class DeviceRecords:
    """The device records of one (demangled) name in a profile: the fields
    of a ``key_averages()`` entry this script reads."""

    __slots__ = ("key", "count", "self_device_time_total")

    def __init__(self, key: str):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0


def device_events(prof) -> list:
    """A profile's device records grouped by name, read from the profiler's
    raw kineto events: ``key_averages()`` first builds a Python event (and
    its tree) for every record, CPU and device, which took most of the
    ~140 s of the families path's traced run. The same counts and sums as
    its device entries: names demangled and hidden events skipped as its
    parser does."""
    from torch.autograd import DeviceType

    out, names = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_hidden_event():
            continue
        raw = e.name()
        key = names.get(raw)
        if key is None:
            key = names[raw] = torch._C._demangle(raw)
        r = out.get(key)
        if r is None:
            r = out[key] = DeviceRecords(key)
        r.count += 1
        r.self_device_time_total += e.duration_ns() / 1e3
    return list(out.values())


def dev_us(e) -> float:
    return e.self_device_time_total


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` from torch.profiler: the summed device
    time of everything it runs on the card over ``reps`` calls (after one
    warm-up call), without the host's time between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(dev_us(e) for e in device_events(prof)) / 1e3 / reps


def profile_calls(calls) -> None:
    """Device busy share and the heaviest kernels of each ``(name, fn)``
    call, from torch.profiler (``profile_one``)."""
    for name, fn in calls:
        profile_one(name, fn)


def traced(fn, cpu: bool = False) -> tuple:
    """``fn()`` inside torch.profiler (CUDA activity, and CPU where
    ``cpu``): (its result, the window's record: wall, device busy time,
    idle share and kernel launches, each port kernel's device ms and
    records (``kernel_ms``, ``records``) and the heaviest device events
    (``top``); empty where the profiler measured no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = device_events(prof)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if busy_ms <= 0:
        return result, {}
    return result, dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=1 - busy_ms / wall_ms,
                        launches=sum(e.count for e in kernels),
                        kernel_ms=kernel_device_ms(kernels), records=kernel_records(kernels),
                        top=sorted(kernels, key=dev_us, reverse=True)[:6])


def profile_one(name: str, fn, trace: bool = False, cpu: bool = True) -> dict:
    """``traced``'s record of one call (CPU and CUDA activity; CUDA alone
    where ``cpu`` is false), printed with the heaviest kernels; empty where
    the profiler measured no device time. Where an outer trace is running
    (``trace``), the call runs untraced and nothing is read."""
    if trace:
        fn()
        return {}
    _, out = traced(fn, cpu)
    if not out:
        print(f"profile {name}: device time not measured by the profiler", flush=True)
        return {}
    print(f"profile {name}: wall {out['wall_ms']:.3f} ms (profiled), device busy "
          f"{out['busy_ms']:.3f} ms, idle share {out['idle']:.3f}, "
          f"{out['launches']} kernel launches; top: "
          + "; ".join(f"{e.key[:48]} x{e.count} {dev_us(e) / 1e3:.3f} ms"
                      for e in out["top"]), flush=True)
    return out


# The kernels each wrapper launches, by symbol: the profiler's keys are these
# names demangled, with template arguments and parameter lists. A template's
# first boolean argument picks the body (B5's and B6's STREAM); later ones
# (the in-tile sort of B5, B6 and B8) do not.
KERNEL_SYMBOLS = {
    "cdf_scan": ("cdf_scan_warp", "cdf_scan_cluster", "cdf_scan_block"),
    "forest_delta": ("forest_delta_kernel",),
    "forest_sample": ("forest_sample_kernel", "forest_sample_wide_kernel"),
    "forest_pack": ("forest_pack_kernel",),
    "forest_delta_update": ("forest_delta_update_kernel",),
    "forest_sample_batched": ("forest_sample_batched_kernel<false>",),
    "forest_sample_batched_streams": ("forest_sample_batched_kernel<true>",),
    "alias_build_batched": ("alias_build_row", "alias_build_partials", "alias_build_records",
                            "alias_build_tapes", "alias_build_search"),
    "alias_sample_batched": ("alias_sample_batched_kernel",),
    "sample_rows": ("sample_rows_kernel",),
    "flash_attention": ("flash_attention_f32_tf32x3", "flash_attention_bf16_wgmma"),
}
PATHS = ("main", "examples", "dist", "paper", "map2d", "pool", "robust", "serve", "eval",
         "train", "families", "families_train", "dist_lm", "dist_families")


def kernel_of(key: str):
    """The wrapper whose kernel a profiler key names, or None: by the name
    with its first template argument where that is a boolean, else by the
    bare name. Booleans may be demangled as ``true`` or ``(bool)1``."""
    rest = key.strip()
    if rest.startswith("void "):
        rest = rest[5:]
    name = rest.split("<")[0].split("(")[0].strip()
    names = [name]
    if rest[len(name):].startswith("<"):
        first = rest[len(name) + 1:].split(">")[0].split(",")[0].strip()
        flag = {"true": "true", "(bool)1": "true", "false": "false", "(bool)0": "false"}
        if first in flag:
            names.insert(0, f"{name}<{flag[first]}>")
    for wrapper, syms in KERNEL_SYMBOLS.items():
        if any(n in syms for n in names):
            return wrapper
    return None


def kernel_device_ms(events) -> dict:
    """Summed device time (ms) of each wrapper's kernels in a profile's
    ``device_events``."""
    out = dict.fromkeys(KERNEL_SYMBOLS, 0.0)
    for e in events:
        k = kernel_of(e.key)
        if k is not None:
            out[k] += dev_us(e) / 1e3
    return out


def kernel_records(events) -> dict:
    """The number of device records of each wrapper's kernels in a
    profile's ``device_events``."""
    out = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for e in events:
        k = kernel_of(e.key)
        if k is not None:
            out[k] += e.count
    return out


def device_profile(device, weights: np.ndarray, m: int, n_draws: int, gen) -> None:
    """Device busy share and the heaviest kernels of one build_forest and
    one sample_forest call."""
    from repro_torch.core.forest import build_forest
    from repro_torch.core.sample import sample_forest

    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    forest = build_forest(w, m, device=device)
    xi = torch.rand(n_draws, generator=gen, device=device)
    profile_calls((("build_forest", lambda: build_forest(w, m, device=device)),
                   ("sample_forest", lambda: sample_forest(forest, xi, device=device))))


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


# ---------------------------------------------------------------------------
# The paper's workloads and the 2-D map path.
# ---------------------------------------------------------------------------


def paper_path(device) -> None:
    """The paper's own experiments on the card: Table 1's load counts and
    the convergence runs of Figs. 1, 7-9 (1-D up to 2^18 points, 2-D at
    h = 128, w = 256 up to 2^20), each forest built and descended there."""
    import benchmarks.torch_convergence as CV
    import benchmarks.torch_table1 as T1

    t = time.perf_counter()
    lines = T1.main(device=device) + CV.main(device=device)
    torch.cuda.synchronize()
    for line in lines:
        print(line, flush=True)
    print(f"paper workloads on the card: {len(lines)} lines in "
          f"{time.perf_counter() - t:.3f} s (host clock)", flush=True)


def paper_checks(device) -> None:
    """The card's Table 1 and convergence forests against the plain CPU
    builds from the same CDF bits, and their counts and histograms against
    the plain CPU path on those CDFs."""
    import benchmarks.torch_convergence as CV
    import benchmarks.torch_table1 as T1
    from repro_torch.core import build_cdf, build_forest_rows, forest_from_cdf
    from repro_torch.core.cdf import normalize_weights, np_build_cdf

    def card_cdf(p):
        return build_cdf(p, device=device).cpu().numpy()

    for name, f in T1.forests(device=device).items():
        plain = forest_from_cdf(f.cdf.cpu(), f.m, device="cpu")
        check(all(torch.equal(a.cpu(), b) for a, b in zip(f, plain)),
              f"table1 {name}: card forest == plain CPU build")
    rows = T1.run(device=device)
    check(rows == T1.run(device="cpu", cdf_of=lambda _n, w: card_cdf(w)),
          "table1: card counts == plain CPU path on the card's CDFs")
    differ = {name: int((card_cdf(make(256)) != build_cdf(make(256), device="cpu").numpy()).sum())
              for name, make in T1.TABLE1.items()}
    print("table1 on the card's own CDFs, full precision: "
          + "; ".join(f"{n} {meth} avg {r['average']!r} avg32 {r['average_32']!r}"
                      for n, meth, r in rows)
          + f"; CDF words where the card's build_cdf differs from the plain CPU scan "
            f"(of 257): {differ}", flush=True)
    for label, run in (("1-D", CV.run_1d), ("2-D", CV.run_2d)):
        a, b = [], []
        ra = run(device=device, counts=a)
        rb = run(device="cpu", cdf_of=card_cdf, counts=b)
        check(ra == rb and len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"convergence {label}: card histograms == plain CPU path")
    img = CV.env_map_2d(128, 256)
    cdfs = np.stack([np_build_cdf(normalize_weights(img[r] + 1e-18)) for r in range(128)])
    fd, fc = (build_forest_rows(cdfs, 256, device=d) for d in (device, "cpu"))
    check(all(torch.equal(getattr(fd, k).cpu(), getattr(fc, k))
              for k in ("data", "table", "left", "right", "cell_first", "fallback")),
          "convergence 2-D: card row forest == plain CPU build")
    print("paper workloads: card forests == plain CPU builds from the same CDF bits; "
          "Table 1 counts and convergence histograms == the plain CPU path", flush=True)


MAP_H, MAP_W = 2048, 4096   # env_map_2d: a 4K equirectangular HDR map, 8.4M texels
MAP_SLOTS = 1 << 16         # device QMC 2-D stream slots
MAP_DRAWS = 1 << 20         # slot occurrences a drain
MAP_DRAINS = 8
MAP_DIRTY = 64              # rows an update touches
MAP_REQUESTS = 16           # prior2d requests through the engine
RAGGED_ROWS = 2048          # the multi-class map: widths 8..4096


def ragged_map(rows: int, seed: int) -> list[np.ndarray]:
    """Seeded rows of widths 8..4096 (log-uniform: every power-of-two class
    from 8 to 4096), weights ``rng.random(w)**4 + 1e-6``, every 97th row
    all-zero."""
    rng = np.random.default_rng(seed)
    widths = np.round(2.0 ** rng.uniform(3, 12, rows)).astype(np.int64)
    out = [rng.random(int(w)) ** 4 + 1e-6 for w in widths]
    for r in range(0, rows, 97):
        out[r] = np.zeros(len(out[r]))
    return out


def map_state(m) -> dict:
    """CPU copies of a ``Map2DSampler``'s forests and per-row lane tables."""
    from repro_torch.core import RadixForest
    from repro_torch.pool import BatchedForest

    def host(ts):
        return [t.to("cpu", copy=True) for t in ts]

    return dict(marg=RadixForest(*host(m.forest)),
                forests=[BatchedForest(*host(c.forest)) for c in m.classes.values()],
                lanes=host((m._group_t, m._slot_t, m._hi_t)))


def plain_map_drain(state: dict, u: np.ndarray, v: np.ndarray):
    """A map drain by the plain versions on CPU copies of the card's arrays."""
    from repro_torch.core import sample_forest
    from repro_torch.kernels import ops

    row = sample_forest(state["marg"], u, device="cpu")
    r = row.long()
    g, s, hi = (t[r] for t in state["lanes"])
    col = torch.empty_like(row)
    ops.forest_sample_grouped(state["forests"], (None if len(state["forests"]) == 1 else g,
                                                 s, hi), col, xi=torch.as_tensor(v))
    return row.numpy(), col.numpy()


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def map2d_path(device, H=MAP_H, W=MAP_W, n_slots=MAP_SLOTS, n_draws=MAP_DRAWS,
               n_drains=MAP_DRAINS, n_dirty=MAP_DIRTY, n_requests=MAP_REQUESTS,
               ragged_rows=RAGGED_ROWS) -> dict:
    """The 2-D map path at full width: a ``SpatialSampler`` over
    ``env_map_2d(H, W)`` (one size class: the fused drain) with ``n_slots``
    device QMC slots, ``n_drains`` drains of ``n_draws`` slot occurrences,
    the fused drain once under ``set_sync_debug_mode("error")``, an
    ``update`` of ``n_dirty`` rows in each form, one more drain, a snapshot
    and restore; a ragged map over every class 8..4096 (the multi-class
    drain), two drains; a prior-only ``ServeEngine`` serving ``n_requests``
    ``prior2d`` requests on the 4K map. Returns what the checks read."""
    from repro_torch.configs.paper_workloads import env_map_2d
    from repro_torch.serve import Qmc2Streams, Request, ServeEngine, SpatialSampler

    rng = np.random.default_rng(21)
    img = env_map_2d(H, W, seed=0)
    rec = dict(img=img, drains=[], n_dirty=n_dirty)

    def slots_of(n):
        s = rng.integers(0, n_slots, n)
        s[:64] = s[64:128]  # duplicate slots in every drain
        return s

    sampler, dt = timed(lambda: SpatialSampler(img, n_slots=n_slots, seed=0, device=device))
    m = sampler.map
    print(f"map2d: SpatialSampler over env_map_2d({H}, {W}) ({H * W} texels, classes "
          f"{list(m.classes)}) built in {dt * 1e3:.3f} ms (host clock, synchronized)",
          flush=True)
    rec["state0"] = map_state(m)
    twin = Qmc2Streams(n_slots, seed=0)
    times = []
    for _ in range(n_drains):
        s = slots_of(n_draws)
        (r, c), dt = timed(lambda: sampler.sample(s))
        times.append(dt)
        rec["drains"].append(("state0", *twin.next(s), r, c))
    check(np.array_equal(sampler.streams.counters.cpu().numpy().view(np.uint32), twin.counters),
          "map2d: device 2-D stream counters == host Qmc2Streams")
    med = statistics.median(times)
    print(f"map2d drain: {n_draws} draws in {med * 1e3:.3f} ms, {n_draws / med:.6e} draws/s "
          f"(median of {n_drains}; host clock, slots in, texels out; last_drain "
          f"{m.last_drain})", flush=True)

    s = slots_of(n_draws)
    u, v = sampler.streams.draw(s)
    pts = twin.next(s)
    check(np.array_equal(u.cpu().numpy(), pts[0]) and np.array_equal(v.cpu().numpy(), pts[1]),
          "map2d: device 2-D stream points == host Qmc2Streams")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        row, col, _, _ = m.sample_map((u, v))
        try:  # the control: a host read in the same mode is refused
            row[0].item()
            caught = False
        except RuntimeError:
            caught = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(caught or not row.is_cuda, "set_sync_debug_mode('error') refuses a host read")
    rec["drains"].append(("state0", *pts, row.cpu().numpy(), col.cpu().numpy()))
    print("map2d: the fused drain (B1, the slot gather, B5 with the width clip) ran under "
          "torch.cuda.set_sync_debug_mode('error'): no host synchronization", flush=True)

    lat = {}
    for form in ("weights", "delta"):
        rows = rng.choice(H, n_dirty, replace=False)
        if form == "weights":
            upd = {int(r): img[r] * rng.uniform(0.5, 2.0, W) for r in rows}
        else:
            upd = {int(r): rng.random(W) * img[r].mean() for r in rows}
        st, dt = timed(lambda: sampler.update(upd, delta=form == "delta"))
        lat[form] = (dt, st)
        print(f"map2d update ({form}, {n_dirty} rows): {dt * 1e3:.3f} ms (host clock, "
              f"synchronized); {st}", flush=True)
    rec["update"] = lat
    rec["state1"] = map_state(m)
    s = slots_of(n_draws)
    r, c = sampler.sample(s)
    rec["drains"].append(("state1", *twin.next(s), r, c))
    rec["rows_now"] = [w.copy() for w in m.rows_raw]

    restored = SpatialSampler.restore(sampler.snapshot(), device=device)
    s = slots_of(n_draws)
    rec["restore"] = (sampler.sample_flat(s), restored.sample_flat(s))
    twin.next(s)
    rec["sampler"] = sampler
    del restored

    rows = ragged_map(ragged_rows, seed=22)
    rs, dt = timed(lambda: SpatialSampler(rows, n_slots=n_slots, seed=1, device=device))
    print(f"map2d: SpatialSampler over a ragged map of {ragged_rows} rows "
          f"({sum(len(w) for w in rows)} texels, classes {list(rs.map.classes)}) built in "
          f"{dt * 1e3:.3f} ms (host clock, synchronized)", flush=True)
    rec["ragged"] = dict(state=map_state(rs.map), rows=rows, n_classes=len(rs.map.classes))
    rtwin = Qmc2Streams(n_slots, seed=1)
    for _ in range(2):
        s = slots_of(n_draws)
        (r, c), dt = timed(lambda: rs.sample(s))
        rec["drains"].append(("ragged", *rtwin.next(s), r, c))
    rec["ragged"]["last_drain"] = dict(rs.map.last_drain)
    print(f"map2d ragged drain: {n_draws} draws in {dt * 1e3:.3f} ms, {n_draws / dt:.6e} draws/s "
          f"(host clock); last_drain {rs.map.last_drain}", flush=True)
    del rs

    eng = ServeEngine(None, None, n_slots=n_requests, device=device)
    reqs = [Request(rid=i, prompt=np.zeros(0, np.int64), max_new=8, prior2d=img)
            for i in range(n_requests)]
    for q in reqs:
        eng.submit(q)
    _, dt = timed(lambda: eng.run(max_steps=100))
    rec["engine"] = reqs
    print(f"map2d engine: {n_requests} prior2d requests x 8 texels in {eng.steps} steps, "
          f"{dt * 1e3:.3f} ms (host clock, map build included)", flush=True)
    return rec


def map2d_checks(rec: dict, device) -> None:
    """Every drain against the plain versions at the same points on CPU copies
    of the card's arrays; the card's builds against the plain CPU builds
    from the same CDF bits; the updated map bit-equal to a fresh build; the
    snapshot's next drain; a chi-square over 64 x 64 texel blocks; the
    engine's tokens."""
    from repro_torch.core import forest_from_cdf
    from repro_torch.core.metrics import chi2_statistic
    from repro_torch.spatial import Map2DSampler

    img = rec["img"]
    H, W = img.shape
    states = {"state0": rec["state0"], "state1": rec["state1"], "ragged": rec["ragged"]["state"]}
    for i, (key, u, v, r, c) in enumerate(rec["drains"]):
        pr, pc = plain_map_drain(states[key], u, v)
        check(np.array_equal(pr, r) and np.array_equal(pc, c),
              f"map2d drain {i} ({key}) == the plain versions at the same points")
    for key in ("state0", "state1"):
        st = states[key]
        plain = forest_from_cdf(st["marg"].cdf, st["marg"].m, device="cpu")
        check(all(torch.equal(a, b) for a, b in zip(st["marg"], plain)),
              f"map2d {key}: marginal == plain CPU build")
        f = st["forests"][0]
        sel = torch.as_tensor(np.random.default_rng(5).choice(H, 64, replace=False))
        plain = forest_from_cdf(f.cdf[sel], f.m, device="cpu")
        check(all(torch.equal(a[sel], b) for a, b in zip(f, plain)),
              f"map2d {key}: 64 class rows == plain CPU build")
    m = rec["sampler"].map
    fresh = Map2DSampler(rec["rows_now"], device=device)
    check(all(torch.equal(a, b) for a, b in zip(m.forest, fresh.forest))
          and all(torch.equal(a, b) for wc in m.classes
                  for a, b in zip(m.classes[wc].forest, fresh.classes[wc].forest)),
          "map2d: updated map == a fresh build over the new rows")
    del fresh
    st = rec["update"]
    check(st["weights"][1]["rebuilt_rows"] + st["weights"][1]["skipped_rows"] == rec["n_dirty"]
          and st["weights"][1]["marginal_rebuilt"], "map2d update stats")
    a, b = rec["restore"]
    check(np.array_equal(a, b), "map2d: restored sampler drains equal")

    flat = np.concatenate([r.astype(np.int64) * W + c for key, _u, _v, r, c in rec["drains"]
                           if key == "state0"])
    by, bx = H // 64, W // 64
    blocks = (flat // W // by) * 64 + (flat % W) // bx
    counts = np.bincount(blocks, minlength=64 * 64)
    mass = img.reshape(64, by, 64, bx).sum(axis=(1, 3)).ravel()
    chi2 = chi2_statistic(counts, mass / mass.sum())
    dof = 64 * 64 - 1
    limit = dof + 6.0 * np.sqrt(2.0 * dof)
    print(f"map2d chi-square over 64 x 64 texel blocks, {len(flat)} draws: {chi2:.3f} "
          f"(dof {dof}, limit {limit:.3f})", flush=True)
    check(chi2 < limit, "map2d chi-square")

    rr = rec["ragged"]
    check(rr["n_classes"] >= 8 and rr["last_drain"]["launches"] == 1
          and not rr["last_drain"]["fused"], "ragged map: >= 8 classes, one grouped launch")
    zero = {i for i, w in enumerate(rr["rows"]) if w.sum() == 0}
    for key, _u, _v, r, c in rec["drains"]:
        if key == "ragged":
            check(not np.isin(r, list(zero)).any(), "ragged map: zero-mass rows never drawn")
            check(bool((c < np.asarray([len(rr["rows"][i]) for i in r])).all()),
                  "ragged map: columns within their rows")
    for q in rec["engine"]:
        out = np.asarray(q.out)
        check(q.done and q.error is None and len(out) == 8 and bool(((out >= 0)
              & (out < H * W)).all()), f"engine prior2d request {q.rid}")
    print(f"map2d: {len(rec['drains'])} drains == the plain versions at the same points; "
          "card builds == plain CPU builds; update == fresh build; restore drains equal; "
          f"{len(rec['engine'])} engine requests served", flush=True)


def map2d_profile(rec: dict) -> None:
    """Device idle share and heaviest kernels of one drain of the 4K map."""
    sampler = rec["sampler"]
    s = np.random.default_rng(3).integers(0, MAP_SLOTS, MAP_DRAWS)
    profile_calls((("map2d drain", lambda: sampler.sample(s)),))


# ---------------------------------------------------------------------------
# The pool phase: a multi-tenant ForestPool behind a PooledForestSampler.
# ---------------------------------------------------------------------------

POOL_TENANTS = 4096         # tenants, sizes 2^(k-1)+1 .. 2^k, k uniform in 5..16
POOL_KMIN, POOL_KMAX = 5, 16
POOL_TIED = 16              # tied-weight forest tenants (fallback cells)
POOL_DYADIC = 64            # dyadic alias tenants (bit-exact alias build)
POOL_SLOTS = 1 << 16        # QMC stream slots
POOL_DRAWS = 1 << 20        # draws per drain
POOL_STREAM_DRAINS = 8      # stream drains before the churn
POOL_UPDATES = 512
POOL_EVICTIONS = 256
POOL_KERNEL_LANES = 1 << 22  # lanes (leaves) of each new kernel timed alone

POOL_KERNELS = {
    "forest_delta_update": ("forest_delta.cu", "src/repro/kernels/forest_delta.py:67"),
    "forest_sample_batched": ("forest_sample_batched.cu",
                              "src/repro/kernels/forest_sample.py:177"),
    "forest_sample_batched_streams": ("forest_sample_batched.cu",
                                      "src/repro/kernels/forest_sample.py:250"),
    "alias_build_batched": ("alias_build.cu", "src/repro/kernels/alias_build.py:150"),
    "alias_sample_batched": ("alias_sample.cu", "src/repro/kernels/alias_sample.py:51"),
}


def dyadic_weights(n: int, rng) -> np.ndarray:
    """Integer weights in [1, 8) with a power-of-two total: every partial
    sum of the alias tapes is exact in float32, in any order."""
    c = rng.integers(1, 8, n)
    extra = (1 << int(np.ceil(np.log2(c.sum())))) - c.sum()
    np.add.at(c, rng.integers(0, n, extra), 1)
    return c.astype(np.float64)


def pool_tenants(T: int, kmin: int, kmax: int):
    """The pool's tenants from ``default_rng(0)``: sizes, weights (the
    ``rng.random(n)**6 + 1e-9`` family of benchmarks/pool.py, 16 tied and
    64 dyadic ones), methods (even forest, odd alias)."""
    rng = np.random.default_rng(0)
    k = rng.integers(kmin, kmax + 1, T)
    half = (1 << (k - 1)).astype(np.int64)
    n = half + 1 + rng.integers(0, half)
    weights = [rng.random(int(s)) ** 6 + 1e-9 for s in n]
    tied = list(range(0, T, 2 * max(T // (2 * POOL_TIED), 1)))[:POOL_TIED]  # even
    for j, t in enumerate(tied):
        w = np.zeros(int(n[t]))
        if j % 2 == 0:
            w[len(w) // 2] = 1.2        # spike, zero-width runs both sides
        else:
            w[0], w[-1] = 1.2, 0.8      # one long interior tie
        weights[t] = w
    dyadic = list(range(1, T, 2 * max(T // (2 * POOL_DYADIC), 1)))[:POOL_DYADIC]  # odd
    for t in dyadic:
        weights[t] = dyadic_weights(int(n[t]), rng)
    methods = ["forest" if t % 2 == 0 else "alias" for t in range(T)]
    return weights, methods, tied, dyadic


def plain_drain(pool, handles, xi: torch.Tensor) -> np.ndarray:
    """The drain recomputed by the plain versions on the pool's stacks:
    one group per (method, size class), results clipped to ``n - 1``."""
    from repro_torch.kernels import ref

    dev = xi.device
    rows = np.fromiter((h.row for h in handles), np.int64, len(handles))
    hi = np.fromiter((h.n - 1 for h in handles), np.int64, len(handles))
    key = np.fromiter(((h.size_class << 1) | (h.method == "alias") for h in handles),
                      np.int64, len(handles))
    out = np.empty(len(handles), np.int32)
    for k in np.unique(key):
        qs = np.flatnonzero(key == k)
        size, alias = int(k >> 1), bool(k & 1)
        did = torch.as_tensor(rows[qs], device=dev)
        x = xi[torch.as_tensor(qs, device=dev)]
        if alias:
            t = pool.alias_classes[size].table
            idx = ref.ref_alias_sample_batched(t.q, t.alias, did, x)
        else:
            idx = ref.ref_forest_sample_batched(*pool.classes[size].forest, did, x)
        out[qs] = np.minimum(idx.cpu().numpy(), hi[qs])
    return out


def _sectors(mask: torch.Tensor, size: int) -> int:
    """32-byte sectors of an array of ``size``-byte entries holding a marked
    entry."""
    per = 32 // size
    pad = torch.zeros((-mask.numel()) % per, dtype=torch.bool, device=mask.device)
    return int(torch.cat([mask, pad]).view(-1, per).any(1).sum())


def descent_bytes(f, did: torch.Tensor, xi: torch.Tensor,
                  lane_bytes: int) -> tuple[int, int, int]:
    """Bytes a descent over B stacked forests must move on this data:
    ``lane_bytes`` a lane (its inputs read and outputs written once) plus
    each table entry some valid lane reads, at flat row offsets: the guide
    entry of every touched cell; ``fallback`` only in cells holding a tree;
    ``cell_first`` and the bisected ``cdf`` entries only in flagged cells;
    ``cdf`` and one child per level along each descent. One forest is the
    stack of one row. Returns that count (the bound's), and two sector
    estimates with the same lane bytes: 32 B for every table read of every
    lane (no sector shared between lanes), and 32 B for every distinct
    sector holding an entry read (every sector shared)."""
    B, m = f.table.shape
    n = f.left.shape[1]
    seen = {k: torch.zeros(t.numel(), dtype=torch.bool, device=xi.device)
            for k, t in f._asdict().items()}
    flat = {k: t.reshape(-1) for k, t in f._asdict().items()}
    ok = did >= 0
    d, x = did[ok].long(), xi[ok]
    g = torch.clamp(torch.floor(x * float(m)).to(torch.int32), 0, m - 1).long()
    seen["table"][d * m + g] = True
    j = flat["table"][d * m + g].long()
    tree = j >= 0
    seen["fallback"][(d * m + g)[tree]] = True
    flag = tree & flat["fallback"][d * m + g]
    df, gf, xf = d[flag], g[flag], x[flag]
    reads = d.numel() + int(tree.sum()) + 34 * df.numel()
    seen["cell_first"][df * (m + 1) + gf] = True
    seen["cell_first"][df * (m + 1) + gf + 1] = True
    lo = flat["cell_first"][df * (m + 1) + gf].long()
    hi = flat["cell_first"][df * (m + 1) + gf + 1].long()
    for _ in range(32):
        mid = (lo + hi + 1) >> 1
        seen["cdf"][df * (n + 1) + mid] = True
        up = xf >= flat["cdf"][df * (n + 1) + mid]
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid - 1)
    j[flag] = ~lo
    while True:
        live = j >= 0
        if not bool(live.any()):
            break
        j, x, d = j[live], x[live], d[live]
        reads += 2 * j.numel()
        seen["cdf"][d * (n + 1) + j] = True
        go_left = x < flat["cdf"][d * (n + 1) + j]
        seen["left"][(d * n + j)[go_left]] = True
        seen["right"][(d * n + j)[~go_left]] = True
        j = torch.where(go_left, flat["left"][d * n + j], flat["right"][d * n + j]).long()
    lanes = did.numel() * lane_bytes
    table_bytes = sum(int(seen[k].sum()) * f[i].element_size()
                      for i, k in enumerate(f._fields))
    sectors = sum(_sectors(seen[k], f[i].element_size()) for i, k in enumerate(f._fields))
    return lanes + table_bytes, lanes + 32 * reads, lanes + 32 * sectors


def alias_bytes(B: int, n: int, did: torch.Tensor, xi: torch.Tensor,
                lane_bytes: int) -> tuple[int, int, int]:
    """As :func:`descent_bytes` for an alias drain over one (B, n) stack:
    ``lane_bytes`` a lane plus 8 B (``q`` and ``alias``) a touched cell;
    the sector estimates count two 32 B reads a valid lane, or the distinct
    sectors of the touched cells in each array."""
    ok = did >= 0
    cells = torch.clamp((xi[ok] * float(n)).to(torch.int32), 0, n - 1).long()
    flat = torch.clamp(did[ok].long(), 0, B - 1) * n + cells
    touched = torch.zeros(B * n, dtype=torch.bool, device=xi.device)
    touched[flat] = True
    lanes = did.numel() * lane_bytes
    return (lanes + int(touched.sum()) * 8, lanes + 64 * int(ok.sum()),
            lanes + 64 * _sectors(touched, 4))


def sector_ms(traffic: tuple[int, int, int]) -> list[float]:
    """The two sector estimates of a traffic count, as ms at 3.35 TB/s."""
    return [b / HBM_BYTES_PER_S * 1e3 for b in traffic[1:]]


def chi_square_tenant(p: np.ndarray, draws: np.ndarray, bins: int = 16):
    """Pearson chi-square of one tenant's draws over equal-mass bins."""
    from repro_torch.core.metrics import chi2_statistic, histogram

    p = p / p.sum()
    cdf64 = np.concatenate([[0.0], np.cumsum(p)])
    b = np.minimum((cdf64[:-1] + cdf64[1:]) * 0.5 * bins, bins - 1).astype(np.int64)
    counts = np.bincount(b, weights=histogram(draws, len(p)), minlength=bins)
    mass = np.bincount(b, weights=p, minlength=bins)
    used = mass > 0
    chi2 = chi2_statistic(counts[used], mass[used] / mass[used].sum())
    dof = int(used.sum()) - 1
    return chi2, dof, dof + 6.0 * np.sqrt(2.0 * max(dof, 1))


def pool_path(device, T=POOL_TENANTS, kmin=POOL_KMIN, kmax=POOL_KMAX,
              n_slots=POOL_SLOTS, n_draws=POOL_DRAWS, n_updates=POOL_UPDATES,
              n_evict=POOL_EVICTIONS) -> dict:
    """The pool's main path through the user entry points: one admission
    wave, QMC stream drains, one host-uniform drain, churn, one more stream
    drain. Returns what the checks after it need."""
    from repro_torch.core.cdf import normalize_weights
    from repro_torch.robust.errors import StaleHandleError
    from repro_torch.serve.sampler import PooledForestSampler, QmcStreams

    weights, methods, tied, dyadic = pool_tenants(T, kmin, kmax)
    rng = np.random.default_rng(1)
    sampler = PooledForestSampler(n_slots=n_slots, seed=0, device=device)
    pool = sampler.pool
    twin = QmcStreams(n_slots, seed=0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    handles = sampler.add_many(weights, method=methods)
    torch.cuda.synchronize()
    admit_ms = (time.perf_counter() - t) * 1e3
    st = pool.stats()
    cells = sum(c["occupied"] * s for s, c in st["classes"].items()) + sum(
        c["occupied"] * s for s, c in st["alias_classes"].items())
    print(f"pool admission: {T} tenants, {cells} padded cells, one insert_many "
          f"wave {admit_ms:.3f} ms (host clock, first call), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)

    def stream_drain(label):
        lanes = rng.integers(0, len(handles), n_draws)
        slots = rng.integers(0, n_slots, n_draws)
        slots[:64] = slots[64:128]  # duplicate slots in every drain
        hs = [handles[i] for i in lanes]
        before = sampler.streams.snapshot()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = sampler.sample(hs, slots)
        dt = time.perf_counter() - t
        pts = twin.next(slots)
        check(np.array_equal(sampler.streams.counters.cpu().numpy().view(np.uint32),
                             twin.counters), f"stream counters, {label}")
        want = plain_drain(pool, hs, torch.as_tensor(pts, device=device))
        check(np.array_equal(out, want), f"stream drain == plain versions, {label}")
        return dict(lanes=lanes, slots=slots, out=out, xi=pts, before=before, s=dt)

    drains = [stream_drain(f"drain {i}") for i in range(POOL_STREAM_DRAINS)]
    rate = [n_draws / d["s"] for d in drains]
    print(f"pool stream drains: {len(drains)} x {n_draws} draws, "
          f"{statistics.median(rate):.6e} draws/s median (host clock, "
          f"{min(rate):.6e} .. {max(rate):.6e}); counters exact; every draw == "
          f"plain versions at the twin's QMC points", flush=True)

    lanes = rng.integers(0, len(handles), n_draws)
    host_xi = rng.random(n_draws).astype(np.float32)
    torch.cuda.synchronize()
    t = time.perf_counter()
    hs = [handles[i] for i in lanes]
    host_out = pool.sample(hs, host_xi)
    dt = time.perf_counter() - t
    want = plain_drain(pool, hs, torch.as_tensor(host_xi, device=device))
    check(np.array_equal(host_out, want), "host-uniform drain == plain versions")
    print(f"pool host-uniform drain: {n_draws} draws, {n_draws / dt:.6e} draws/s "
          f"(host clock); == plain versions", flush=True)

    orig = list(weights)
    # Churn: a quarter bit-identical updates (skips), a quarter deltas, half
    # full rewrites; then evictions and single-tenant re-inserts.
    churnable = np.setdiff1d(np.arange(len(handles)), tied + dyadic)
    upd = rng.choice(churnable, n_updates, replace=False)
    kinds = ["same"] * (n_updates // 4) + ["delta"] * (n_updates // 4) + [
        "full"] * (n_updates - n_updates // 2)
    skips0 = sum(c["delta_skips"] for c in pool.stats()["classes"].values()) + sum(
        c["skips"] for c in pool.stats()["alias_classes"].values())
    times = {"skip": [], "forest": [], "alias": []}
    for i, kind in zip(upd, kinds):
        h = handles[i]
        n = h.n
        torch.cuda.synchronize()
        t = time.perf_counter()
        if kind == "same":
            sampler.update(h, weights[i])
        elif kind == "delta":
            d = np.zeros(n)
            d[rng.integers(0, n, 4)] = rng.random(4)
            sampler.update(h, delta=d)
            weights[i] = weights[i] + d
        else:
            weights[i] = rng.random(n) ** 6 + 1e-9
            sampler.update(h, weights[i])
        torch.cuda.synchronize()
        times["skip" if kind == "same" else h.method].append((time.perf_counter() - t) * 1e3)
    skips = sum(c["delta_skips"] for c in pool.stats()["classes"].values()) + sum(
        c["skips"] for c in pool.stats()["alias_classes"].values()) - skips0
    check(skips == n_updates // 4, f"bit-identical updates skip ({skips})")
    print("pool updates (host clock, ms per call, median [max]): " + ", ".join(
        f"{k} {statistics.median(v):.3f} [{max(v):.3f}] x{len(v)}"
        for k, v in times.items() if v),
        flush=True)

    gone = rng.choice(np.setdiff1d(churnable, upd), n_evict, replace=False)
    evicted = []
    for i in gone:
        sampler.remove(handles[i])
        evicted.append(handles[i])
    for h in evicted[:16]:
        try:
            pool.sample([h], [0.5])
        except StaleHandleError:
            continue
        raise RuntimeError(f"chip_smoke: evicted handle {h} did not raise")
    add_ms = {"forest": [], "alias": []}
    for i in gone:
        weights[i] = rng.random(len(weights[i])) ** 6 + 1e-9
        torch.cuda.synchronize()
        t = time.perf_counter()
        handles[i] = sampler.add(weights[i], method=methods[i])
        torch.cuda.synchronize()
        add_ms[methods[i]].append((time.perf_counter() - t) * 1e3)
    print(f"pool churn: {len(gone)} evictions (stale handles raise), "
          f"{len(gone)} single-tenant inserts (host clock, ms median [max]): " + ", ".join(
              f"{k} {statistics.median(v):.3f} [{max(v):.3f}] x{len(v)}"
              for k, v in add_ms.items() if v), flush=True)
    drains.append(stream_drain("after churn"))
    print(f"pool drain after churn: {n_draws / drains[-1]['s']:.6e} draws/s "
          f"(host clock); peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    return dict(sampler=sampler, pool=pool, handles=handles, weights=weights,
                orig=orig, methods=methods, tied=tied, dyadic=dyadic,
                drains=drains, updated=upd, norm=normalize_weights)


def pool_checks(rec: dict, device) -> None:
    """Checks of the pool run, after it: forest rows against the plain CPU
    build from the same CDF bits, every drain against the plain versions at
    the same points, the alias build on dyadic tenants and on all rows, and
    a per-tenant chi-square."""
    from repro_torch.core.alias import build_alias_parallel
    from repro_torch.core.forest import forest_from_cdf, forest_to_numpy
    from repro_torch.kernels import ref

    pool, handles, weights = rec["pool"], rec["handles"], rec["weights"]
    rng = np.random.default_rng(2)
    forest_t = [i for i, h in enumerate(handles) if h.method == "forest"]
    by_class = {}
    for i in forest_t:
        by_class.setdefault(handles[i].size_class, []).append(i)
    pick = set(rec["tied"]) | set(int(i) for i in rec["updated"] if handles[i].method == "forest")
    pick = sorted(pick)[:16]
    for ts in by_class.values():  # the rest spread over every class
        pick += [int(i) for i in rng.choice(ts, min(4, len(ts)), replace=False)]
    pick = sorted(set(pick))[:max(64, len(by_class))]
    for i in pick:
        f = pool.forest_row(handles[i])
        card = forest_to_numpy(f)
        plain = forest_to_numpy(forest_from_cdf(f.cdf.cpu(), f.m, device="cpu"))
        for k in card:
            check(np.array_equal(card[k], plain[k]), f"forest row {handles[i]} {k}")
    flagged = sum(int(pool.forest_row(handles[i]).fallback.sum()) for i in rec["tied"])
    print(f"pool forest rows: {len(pick)} tenants over {len(by_class)} classes == "
          f"plain CPU build from the same CDF bits, all six arrays "
          f"({flagged} flagged cells in the tied tenants)", flush=True)

    alias_t = [i for i, h in enumerate(handles) if h.method == "alias"]
    for i in rec["dyadic"]:
        h = handles[i]
        t = pool.alias_row(h)
        w = np.pad(rec["norm"](weights[i]), (0, h.size_class - h.n)).astype(np.float32)
        host = build_alias_parallel(w.astype(np.float64), device="cpu")
        plain = ref.ref_alias_build_batched(torch.as_tensor(w[None], device=device))
        check(torch.equal(t.q.cpu(), host.q) and torch.equal(t.alias.cpu(), host.alias),
              f"alias build dyadic tenant {h} == build_alias_parallel")
        check(torch.equal(t.q, plain[0][0]) and torch.equal(t.alias, plain[1][0]),
              f"alias build dyadic tenant {h} == plain version")
    worst = 0.0
    for size, ar in pool.alias_classes.items():
        rows = [i for i in alias_t if handles[i].size_class == size]
        if not rows:
            continue
        r = torch.as_tensor([handles[i].row for i in rows], device=device)
        q, a = ar.table.q[r].double(), ar.table.alias[r].long()
        check(bool(((q >= 0) & (q <= 1)).all()) and bool(((a >= 0) & (a < size)).all()),
              f"alias class {size}: valid tables")
        W = np.stack([np.pad(rec["norm"](weights[i]), (0, size - handles[i].n))
                      for i in rows]).astype(np.float32)
        Wt = torch.as_tensor(W, device=device).double()
        npi = Wt / Wt.sum(1, keepdim=True) * size
        mass = q.clone().scatter_add_(1, a, 1.0 - q)
        err = (mass - npi).abs()
        worst = max(worst, float(err.max()))
        # the tests' tolerance: 2e-4 relative and absolute, plus the row's
        # normalization residue (float32 n*p sum to n within a few ulps of n)
        check(bool((err <= 2e-4 + 2e-4 * npi + size * 2.0**-22).all()),
              f"alias class {size}: mass conserved ({float(err.max())})")
    print(f"pool alias build: {len(rec['dyadic'])} dyadic tenants bit-exact "
          f"(plain version and build_alias_parallel); {len(alias_t)} tables valid, "
          f"worst |mass - n*p| {worst:.3e}", flush=True)

    lanes = np.concatenate([d["lanes"] for d in rec["drains"][:POOL_STREAM_DRAINS]])
    outs = np.concatenate([d["out"] for d in rec["drains"][:POOL_STREAM_DRAINS]])
    per = np.bincount(lanes, minlength=len(handles))
    top = [i for i in np.argsort(-per) if rec["methods"][i] == "forest"][:8]
    for i in top:
        chi2, dof, limit = chi_square_tenant(rec["orig"][i], outs[lanes == i])
        check(chi2 < limit, f"chi-square tenant {i}: {chi2} (limit {limit})")
    print(f"pool chi-square: {len(top)} forest tenants with the most draws "
          f"({int(per[top].min())}..{int(per[top].max())} each) pass", flush=True)


def pool_kernels(rec: dict, device, gen, n_lanes: int) -> dict:
    """Each new kernel alone on the pool's largest stacks at ``n_lanes``
    lanes (leaves for the update mask): against its plain version on the
    same inputs, then timed with CUDA events beside the plain version."""
    from repro_torch.core.alias import np_sample_alias_f32
    from repro_torch.core.cdf import lower_bounds
    from repro_torch.core.lds import qmc_point_np
    from repro_torch.kernels import ref
    from repro_torch.kernels.alias_build import alias_build_batched
    from repro_torch.kernels.alias_sample import alias_sample_batched
    from repro_torch.kernels.forest_delta import forest_delta_update
    from repro_torch.kernels.forest_sample import (
        forest_sample_batched,
        forest_sample_batched_streams,
    )
    from repro_torch.serve.sampler import DeviceQmcStreams

    pool, handles = rec["pool"], rec["handles"]
    rows = {}
    fsize = max(pool.classes)
    f = pool.classes[fsize].forest
    live = torch.as_tensor(sorted(pool.classes[fsize].raw), device=device)
    pick = torch.randint(0, len(live), (n_lanes,), generator=gen, device=device)
    did = live[pick].to(torch.int32)
    xi = torch.rand(n_lanes, generator=gen, device=device)

    want = ref.ref_forest_sample_batched(*f, did, xi)
    for co in (True, False):
        check(torch.equal(forest_sample_batched(*f, did, xi, coalesce=co), want),
              f"forest_sample_batched == plain, coalesce={co}")
    co_ms = cuda_ms_per_call(lambda: forest_sample_batched(*f, did, xi, coalesce=True), 10)
    rows["forest_sample_batched"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms_per_call(lambda: forest_sample_batched(*f, did, xi, coalesce=False), 20),
        one_call_ms=cuda_ms(lambda: forest_sample_batched(*f, did, xi, coalesce=False), 20),
        plain_ms=cuda_ms(lambda: ref.ref_forest_sample_batched(*f, did, xi), 3),
        library_ms=None)
    traffic = descent_bytes(f, did, xi, 12)
    rows["forest_sample_batched"].update(bound=bound_ms(traffic[0]), sector_ms=sector_ms(traffic))

    # uint32 counters and offsets as int32 bit views, the streams' own form
    ctr = torch.randint(-2**31, 2**31, (n_lanes,), generator=gen, device=device,
                        dtype=torch.int32)
    off = torch.randint(0, 2**24, (n_lanes,), generator=gen, device=device,
                        dtype=torch.int32)
    wi, wx = ref.ref_forest_sample_batched_streams(*f, did, ctr, off)
    pts = qmc_point_np(ctr.cpu().numpy().view(np.uint32),
                       off.cpu().numpy().view(np.uint32))
    for co in (True, False):
        gi, gx = forest_sample_batched_streams(*f, did, ctr, off, coalesce=co)
        check(torch.equal(gi, wi), f"forest_sample_batched_streams == plain, coalesce={co}")
        check(np.array_equal(gx.cpu().numpy().view(np.uint32), pts.view(np.uint32)),
              f"stream points == qmc_point_np, coalesce={co}")
    # The last drain's lanes of this class, at its own pre-pass state: the
    # kernel's points equal the host twin's, its indices the drain's.
    d = rec["drains"][-1]
    c, o, _x = DeviceQmcStreams.restore(d["before"], device=device).draw(d["slots"])
    sel = np.flatnonzero([handles[i].method == "forest" and handles[i].size_class == fsize
                          for i in d["lanes"]])
    st = torch.as_tensor(sel, device=device)
    r = torch.as_tensor([handles[i].row for i in d["lanes"][sel]], device=device,
                        dtype=torch.int32)
    gi, gx = forest_sample_batched_streams(*f, r, c[st], o[st])
    check(np.array_equal(gx.cpu().numpy().view(np.uint32), d["xi"][sel].view(np.uint32)),
          "stream kernel points == host QmcStreams twin")
    hi = np.asarray([handles[i].n - 1 for i in d["lanes"][sel]])
    check(np.array_equal(np.minimum(gi.cpu().numpy(), hi), d["out"][sel]),
          "stream kernel == the drain's draws")
    print(f"forest_sample_batched on class {fsize} ({len(live)} rows, {n_lanes} lanes): "
          f"coalesced {co_ms:.4f} ms; stream points bit-equal to the twin on "
          f"{len(sel)} drain lanes", flush=True)
    sco_ms = cuda_ms_per_call(
        lambda: forest_sample_batched_streams(*f, did, ctr, off, coalesce=True), 10)
    rows["forest_sample_batched_streams"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms_per_call(
            lambda: forest_sample_batched_streams(*f, did, ctr, off, coalesce=False), 20),
        one_call_ms=cuda_ms(
            lambda: forest_sample_batched_streams(*f, did, ctr, off, coalesce=False), 20),
        plain_ms=cuda_ms(lambda: ref.ref_forest_sample_batched_streams(*f, did, ctr, off), 3),
        library_ms=None)
    traffic = descent_bytes(f, did, wx, 20)
    rows["forest_sample_batched_streams"].update(bound=bound_ms(traffic[0]),
                                                 sector_ms=sector_ms(traffic))
    print(f"forest_sample_batched_streams: coalesced "
          f"{sco_ms:.4f} ms, without coalescing "
          f"{rows['forest_sample_batched_streams']['ms']:.4f} ms", flush=True)

    asize = max(pool.alias_classes)
    ar = pool.alias_classes[asize]
    ts = [i for i, h in enumerate(handles) if h.method == "alias" and h.size_class == asize]
    W = torch.as_tensor(np.stack([np.pad(rec["norm"](rec["weights"][i]),
                                         (0, asize - handles[i].n)) for i in ts]),
                        device=device)
    q, a = alias_build_batched(W)
    pq, pa = ref.ref_alias_build_batched(W)
    check(bool(((q >= 0) & (q <= 1)).all()) and bool(((a >= 0) & (a < asize)).all()),
          "alias_build_batched valid")
    rows["alias_build_batched"] = dict(
        max_abs_err=float((q - pq).abs().max()),
        ms=cuda_ms(lambda: alias_build_batched(W), 10),
        plain_ms=cuda_ms(lambda: ref.ref_alias_build_batched(W), 3),
        library_ms=None, bound=bound_ms(W.numel() * 12))
    print(f"alias_build_batched on class {asize} ({len(ts)} rows): max |q - plain q| "
          f"{rows['alias_build_batched']['max_abs_err']:.3e}, alias entries differing "
          f"{int((a != pa).sum())} of {a.numel()} (summation order; both valid)", flush=True)

    alive = torch.as_tensor(sorted(ar.raw), device=device)
    did_a = alive[torch.randint(0, len(alive), (n_lanes,), generator=gen,
                                device=device)].to(torch.int32)
    did_a[:64] = -1
    xa = torch.rand(n_lanes, generator=gen, device=device)
    xa[64:67] = torch.tensor([0.0, 1.0, float(np.nextafter(np.float32(1), np.float32(0)))],
                             device=device)
    qh, ah = ar.table.q.cpu().numpy(), ar.table.alias.cpu().numpy()
    dh, xh = did_a.cpu().numpy(), xa.cpu().numpy()
    want = np.zeros(n_lanes, np.int32)
    order = np.argsort(dh, kind="stable")
    bounds = np.searchsorted(dh[order], np.unique(dh))
    for rr, lo, hi_ in zip(np.unique(dh), bounds, list(bounds[1:]) + [len(dh)]):
        if rr >= 0:
            sl = order[lo:hi_]
            want[sl] = np_sample_alias_f32(qh[rr], ah[rr], xh[sl])
    for co in (True, False):
        got = alias_sample_batched(ar.table.q, ar.table.alias, did_a, xa, coalesce=co)
        check(np.array_equal(got.cpu().numpy(), want),
              f"alias_sample_batched == np_sample_alias_f32, coalesce={co}")
    traffic = alias_bytes(ar.table.q.shape[0], asize, did_a, xa, 12)
    rows["alias_sample_batched"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms_per_call(lambda: alias_sample_batched(ar.table.q, ar.table.alias, did_a,
                                                         xa, coalesce=False), 20),
        one_call_ms=cuda_ms(lambda: alias_sample_batched(ar.table.q, ar.table.alias, did_a,
                                                         xa, coalesce=False), 20),
        plain_ms=cuda_ms(lambda: ref.ref_alias_sample_batched(ar.table.q, ar.table.alias,
                                                              did_a, xa), 5),
        library_ms=None, bound=bound_ms(traffic[0]), sector_ms=sector_ms(traffic))

    R = max(1, min(len(live), n_lanes // fsize))
    old = lower_bounds(f.cdf[live[:R]]).reshape(-1).contiguous()
    new = old.clone()
    new[::5] = torch.nextafter(new[::5], torch.ones_like(new[::5]))
    d_k, ch_k = forest_delta_update(old, new, fsize)
    d_p, ch_p = ref.ref_forest_delta_update(old, new, fsize)
    check(torch.equal(d_k, d_p) and torch.equal(ch_k, ch_p), "forest_delta_update bit-exact")
    oi, ni = old.view(torch.int32), new.view(torch.int32)
    rows["forest_delta_update"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms_per_call(lambda: forest_delta_update(old, new, fsize), 50),
        one_call_ms=cuda_ms(lambda: forest_delta_update(old, new, fsize), 20),
        plain_ms=cuda_ms_per_call(lambda: ref.ref_forest_delta_update(old, new, fsize), 20),
        library_ms=cuda_ms_per_call(lambda: torch.ne(oi, ni), 50),
        # 8 B in, 1 B of mask and 4 B of uint32 distance out a leaf; the
        # kernel writes the distances' int64 form (8 B)
        bound=bound_ms(old.numel() * (8 + 1 + 4)))
    r = rows["forest_delta_update"]
    print(f"forest_delta_update on {old.numel()} leaves: {r['ms']:.6f} ms per call, "
          f"{r['one_call_ms']:.6f} one call", flush=True)
    print(f"forest_delta_update on {old.numel()} leaves: bit-exact; "
          f"alias_sample_batched on class {asize} ({len(alive)} rows): elementwise "
          f"== np_sample_alias_f32; forest_sample_batched(_streams) elementwise == "
          f"plain, coalesce on and off", flush=True)
    return rows


def drain_kernels(rec: dict, device) -> dict:
    """B6 and B8 at the drain's shape: the lanes of the pool run's last
    stream drain at that drain's pre-pass state, each method's lanes over
    all its size classes in one grouped launch, as the drain runs them.
    Held against the grouped plain versions on the same inputs and the
    drain's own draws, coalesced and not; timed (``cuda_ms_per_call``)
    beside the plain versions (``cuda_ms``), with the byte bound (lane
    arrays read and written once, table entries as ``descent_bytes`` and
    ``alias_bytes`` count them) and its sector estimates. Returns each
    wrapper's ``at_drain`` record."""
    import inspect

    from repro_torch.kernels import ref
    from repro_torch.kernels.alias_sample import alias_sample_grouped
    from repro_torch.kernels.forest_sample import forest_sample_grouped
    from repro_torch.pool import ForestPool
    from repro_torch.serve.sampler import DeviceQmcStreams

    pool, handles = rec["pool"], rec["handles"]
    d = rec["drains"][-1]
    hs = [handles[i] for i in d["lanes"]]
    ctr, off, xi = DeviceQmcStreams.restore(d["before"], device=device).draw(d["slots"])
    forest, alias, (gid, row, hi) = pool._drain_plan(hs)
    fst = [tuple(pool.classes[c].forest) for c in forest]
    ats = [(pool.alias_classes[c].table.q, pool.alias_classes[c].table.alias) for c in alias]
    Q, Gf = len(hs), len(forest)

    def run_f(o, co, plain=False):
        fn = ref.ref_forest_sample_grouped if plain else forest_sample_grouped
        fn(fst, gid, row, hi, o, counter=ctr, offset_bits=off,
           **({} if plain else {"coalesce": co}))

    def run_a(o, co, plain=False):
        if plain:
            ref.ref_alias_sample_grouped(ats, gid, row, hi, o, Gf, xi)
        else:
            alias_sample_grouped(ats, gid, row, hi, o, xi, g0=Gf, coalesce=co)

    want = torch.full((Q,), -7, dtype=torch.int32, device=device)
    run_f(want, None, plain=True)
    run_a(want, None, plain=True)
    check(np.array_equal(want.cpu().numpy(), d["out"]), "grouped plain versions == the drain")
    for co in (True, False):
        got = torch.full((Q,), -7, dtype=torch.int32, device=device)
        run_f(got, co)
        run_a(got, co)
        check(torch.equal(got, want), f"grouped B6 and B8 == plain at the drain, coalesce={co}")
    default = inspect.signature(ForestPool.sample_streams).parameters["coalesce"].default
    o = torch.empty(Q, dtype=torch.int32, device=device)
    out = {}
    for name, run, tabs, traffic in (
            ("forest_sample_batched_streams", run_f, fst,
             lambda t, sel: descent_bytes(type(pool.classes[forest[0]].forest)(*t),
                                          row[sel], xi[sel], 20)),
            ("alias_sample_batched", run_a, ats,
             lambda t, sel: alias_bytes(t[0].shape[0], t[0].shape[1], row[sel], xi[sel], 16))):
        g0 = 0 if name.startswith("forest") else Gf
        parts = [traffic(t, gid == g0 + g) for g, t in enumerate(tabs)]
        total = [Q * 4 + sum(p[i] for p in parts) for i in range(3)]  # gid of every lane
        ms = {co: cuda_ms_per_call(lambda: run(o, co), 20) for co in (True, False)}
        out[name] = dict(
            lanes=int(sum((gid == g0 + g).sum() for g in range(len(tabs)))), groups=len(tabs),
            coalesce=default, ms=ms[default], coalesced_ms=ms[True], uncoalesced_ms=ms[False],
            plain_ms=cuda_ms(lambda: run(o, None, plain=True), 3),
            bound_ms=bound_ms(total[0])[0], sector_ms=sector_ms(total), max_abs_err=0.0)
        r = out[name]
        print(f"{name} at the drain ({r['lanes']} of {Q} lanes, {r['groups']} classes, one "
              f"launch): {r['ms']:.6f} ms (coalesced {r['coalesced_ms']:.6f}, not "
              f"{r['uncoalesced_ms']:.6f}; cuda_ms_per_call), plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms (bytes), sector estimates "
              f"{r['sector_ms'][0]:.6f} / {r['sector_ms'][1]:.6f} ms; == plain versions and "
              f"the drain's draws", flush=True)
    return out


def drain_device(fn) -> dict:
    """Device time and operations of one call of ``fn`` (a drain), from
    torch.profiler: all device ms, kernel launches, copies, and the device
    ms and launches of B5, B6 and B8 by their symbols."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = device_events(prof)
    copies = [e for e in ev if e.key.startswith(("Memcpy", "Memset"))]
    out = dict(device_ms=sum(dev_us(e) for e in ev) / 1e3,
               launches=sum(e.count for e in ev) - sum(e.count for e in copies),
               copies=sum(e.count for e in copies))
    for name in ("forest_sample_batched", "forest_sample_batched_streams",
                 "alias_sample_batched"):
        mine = [e for e in ev if kernel_of(e.key) == name]
        out[f"{name}_ms"] = sum(dev_us(e) for e in mine) / 1e3
        out[f"{name}_launches"] = sum(e.count for e in mine)
    return out


ALIAS_CLASSES = tuple(1 << k for k in range(POOL_KMIN, POOL_KMAX + 1))
ALIAS_FULL_ROWS = 164        # rows of the pool run's 65536 alias class


def alias_build_times(device) -> None:
    """B7 on one row at every pool class (an update or a single insert),
    and on a full 65536 class (an admission wave), by cuda_ms_per_call,
    with the blocks each launch step runs. Every table is checked valid,
    and on a dyadic row of each class equal to the plain version."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.alias_build import alias_build_batched

    rng = np.random.default_rng(5)
    cases = [(f"{n}", torch.as_tensor(rng.random((1, n)) ** 6 + 1e-9, dtype=torch.float32,
                                      device=device)) for n in ALIAS_CLASSES]
    n = ALIAS_CLASSES[-1]
    full = rng.random((ALIAS_FULL_ROWS, n)) ** 6 + 1e-9
    for r, real in enumerate(rng.integers(n // 2 + 1, n + 1, ALIAS_FULL_ROWS)):
        full[r, real:] = 0.0
    cases.append((f"{n} x{ALIAS_FULL_ROWS}", torch.as_tensor(full, dtype=torch.float32,
                                                             device=device)))
    parts = []
    for label, w in cases:
        B, n = w.shape
        dy = torch.as_tensor(dyadic_weights(n, rng)[None], dtype=torch.float32, device=device)
        q, a = alias_build_batched(dy)
        pq, pa = ref.ref_alias_build_batched(dy)
        check(torch.equal(q, pq) and torch.equal(a, pa), f"alias_build dyadic row n={n}")
        q, a = alias_build_batched(w)
        check(bool(((q >= 0) & (q <= 1)).all()) and bool(((a >= 0) & (a < n)).all()),
              f"alias_build valid at {label}")
        ms = cuda_ms_per_call(lambda: alias_build_batched(w), 50 if B == 1 else 5)
        parts.append(f"{label} {ms:.6f} [{B * _build.library().rt_alias_tiles(n)} blocks]")
    print("alias_build_batched by class, ms per call (cuda_ms_per_call) [blocks a launch "
          "step]: " + "; ".join(parts), flush=True)


def pool_admission_by_class(rec: dict, device) -> None:
    """Admission time of each (method, size class) group: its tenants (as
    they stand after the run) through ``insert_many`` into a fresh pool,
    host clock around a synchronized call, best of 2."""
    from repro_torch.pool import ForestPool

    handles, weights = rec["handles"], rec["weights"]
    groups = {}
    for i, h in enumerate(handles):
        groups.setdefault((h.method, h.size_class), []).append(weights[i])
    parts = []
    for (meth, size), ws in sorted(groups.items(), key=lambda g: (g[0][0], g[0][1])):
        best = math.inf
        for _ in range(2):
            pool = ForestPool(device=device)
            torch.cuda.synchronize()
            t = time.perf_counter()
            pool.insert_many(ws, method=meth)
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t) * 1e3)
        parts.append(f"{meth} {size} x{len(ws)} {best:.3f}")
    print("pool admission by class (ms, host clock, best of 2): " + "; ".join(parts),
          flush=True)


def pool_profile(rec: dict, device, n_draws: int) -> dict:
    """Device busy share of one stream drain and of one forest update; the
    device ms and operations of one stream drain and of one host-uniform
    drain (returned by label); the host-side split of one stream drain
    (cProfile)."""
    import cProfile
    import pstats

    rng = np.random.default_rng(3)
    sampler, handles = rec["sampler"], rec["handles"]
    lanes = rng.integers(0, len(handles), n_draws)
    hs = [handles[i] for i in lanes]
    slots = rng.integers(0, sampler.streams.n_slots, n_draws)
    i = next(i for i, h in enumerate(handles) if h.method == "forest")
    w = rng.random(handles[i].n) ** 6 + 1e-9
    profile_calls((("pool stream drain", lambda: sampler.sample(hs, slots)),
                   ("pool forest update", lambda: sampler.update(handles[i], w))))
    xi = rng.random(n_draws).astype(np.float32)
    drains = {}
    for label, fn in (("stream", lambda: sampler.sample(hs, slots)),
                      ("host-uniform", lambda: sampler.pool.sample(hs, xi))):
        r = drains[label] = drain_device(fn)
        print(f"pool {label} drain, one call (profiler): device {r['device_ms']:.4f} ms, "
              f"{r['launches']} kernel launches and {r['copies']} copies; "
              + ", ".join(f"{k} {r[k + '_ms']:.4f} ms x{r[k + '_launches']}"
                          for k in ("forest_sample_batched", "forest_sample_batched_streams",
                                    "alias_sample_batched") if r[k + "_launches"]),
              flush=True)
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t = time.perf_counter()
    prof.runcall(sampler.sample, hs, slots)
    wall = time.perf_counter() - t
    stats = pstats.Stats(prof).stats
    parts = []
    for name in ("_drain_plan", "draw", "forest_sample_grouped",
                 "alias_sample_grouped", "_guard_group"):
        cum = sum(v[3] for k, v in stats.items() if k[2] == name
                  and k[0].endswith(("ops.py", "arena.py", "sampler.py")))
        if cum:
            parts.append(f"{name} {cum * 1e3:.1f} ms ({cum / wall:.3f})")
    print(f"host profile of one {n_draws}-draw stream drain: wall {wall * 1e3:.1f} ms "
          f"(under cProfile); cumulative: " + ", ".join(parts), flush=True)
    return drains


# ---------------------------------------------------------------------------
# The serve phase: ServeEngine over the dense LM at Qwen1.5-0.5B's widths.
# ---------------------------------------------------------------------------

ROBUST_DRAINS = 2            # stream drains of POOL_DRAWS after the restore
ROBUST_CHAOS_STEPS = 24      # FaultPlan.default(24, seed=0) under each policy
ROBUST_REQUESTS = 24         # model requests of the engine saved mid-flight
ROBUST_STEPS = 6             # engine steps before the save


def disk_bytes(d: Path) -> int:
    return sum(f.stat().st_size for f in d.rglob("*") if f.is_file())


def through_disk(d: Path, **components):
    """save_serving the components, load the bundle back: ``(states, bytes
    on disk, save s, load s)`` on the host clock."""
    from repro_torch.robust import load_serving, save_serving

    torch.cuda.synchronize()
    t = time.perf_counter()
    path = save_serving(d, 1, **components)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    states, step = load_serving(d)
    load_s = time.perf_counter() - t
    check(step == 1, "load_serving finds the committed step")
    return states, disk_bytes(path), save_s, load_s


def robust_path(rec: dict, device, root: Path, cfg=None, map_hw=(MAP_H, MAP_W),
                n_draws=POOL_DRAWS, map_draws=MAP_DRAWS, n_requests=ROBUST_REQUESTS,
                max_seq=None) -> None:
    """The serving state and robustness layer on the card, on the pool
    phase's own pool: ``save_serving`` of the ``PooledForestSampler`` (pool
    and device QMC streams) under ``build/``, load, restore, the next
    drains and the counters of both equal; ``verify_pool(deep=True)`` of
    the restored pool clean, then a NaN written into one arena row behind
    its back and named; ``run_chaos`` under each policy; a 4K
    ``SpatialSampler`` and a model-backed ``ServeEngine`` saved mid-flight
    through disk, their next drain and tokens equal."""
    import shutil

    import repro_torch.configs as C
    from repro_torch.configs.paper_workloads import env_map_2d
    from repro_torch.models import init_params
    from repro_torch.robust import verify_pool
    from repro_torch.robust.faults import FaultPlan, run_chaos
    from repro_torch.serve import PooledForestSampler, ServeEngine, SpatialSampler, TokenSampler

    d = root / "build" / "chip_smoke_serving"
    shutil.rmtree(d, ignore_errors=True)
    sampler, handles = rec["sampler"], rec["handles"]
    states, nbytes_, save_s, load_s = through_disk(d / "pool", sampler=sampler)
    t = time.perf_counter()
    twin = PooledForestSampler.restore(states["sampler"], device=device)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    del states
    cells = sum(sc.rows * s for s, sc in twin.pool.classes.items()) + sum(
        ar.rows * s for s, ar in twin.pool.alias_classes.items())
    print(f"robust: save_serving of the pool sampler ({len(handles)} tenants, {cells} padded "
          f"arena cells, device QMC streams): {nbytes_} bytes on disk, save {save_s:.3f} s, "
          f"load {load_s:.3f} s, restore onto the card {restore_s:.3f} s (host clock)",
          flush=True)
    rng = np.random.default_rng(5)
    n_slots = int(sampler.streams.counters.shape[0])
    for i in range(ROBUST_DRAINS):
        hs = [handles[j] for j in rng.integers(0, len(handles), n_draws)]
        slots = rng.integers(0, n_slots, n_draws)
        check(np.array_equal(sampler.sample(hs, slots), twin.sample(hs, slots)),
              f"restored sampler's stream drain {i} == the original's")
    check(torch.equal(sampler.streams.counters, twin.streams.counters),
          "restored stream counters == the original's")
    torch.cuda.synchronize()
    t = time.perf_counter()
    errs = verify_pool(twin.pool, deep=True)
    torch.cuda.synchronize()
    verify_s = time.perf_counter() - t
    check(errs == [], f"verify_pool of the restored pool: {errs[:3]}")
    size = max(twin.pool.classes)
    row = min(twin.pool.classes[size].raw)
    twin.pool.classes[size].forest.cdf[row, 1] = float("nan")
    errs = verify_pool(twin.pool, deep=True)
    check(errs == [f"forest[{size}] row {row}: cdf has non-finite entries"],
          f"verify_pool names the corrupted row: {errs[:3]}")
    del twin
    print(f"robust: {ROBUST_DRAINS} stream drains of {n_draws} after the restore == the "
          f"original's, counters equal; verify_pool(deep=True) of the restored pool clean in "
          f"{verify_s:.3f} s (host clock, one batched build_cdf a size class); a NaN written "
          f"into forest[{size}] row {row} on the card is named", flush=True)

    plan = FaultPlan.default(ROBUST_CHAOS_STEPS, seed=0)
    for policy in ("quarantine", "clamp", "reject"):
        t = time.perf_counter()
        rep = run_chaos(plan, steps=ROBUST_CHAOS_STEPS, policy=policy, seed=0, device=device)
        check(rep["drains_equal"] and rep["verify_errors"] == []
              and rep["injected"] == len(plan.faults), f"chaos contract under {policy}")
        print(f"robust: run_chaos {policy}: {rep['injected']} faults, caught "
              f"{[(s, k, c) for s, k, c in rep['caught']]}, quarantined {rep['quarantined']}, "
              f"co-tenant drains equal, verify clean, {time.perf_counter() - t:.3f} s",
              flush=True)

    img = env_map_2d(*map_hw, seed=0)
    sp = SpatialSampler(img, n_slots=MAP_SLOTS, seed=0, device=device)
    slots = rng.integers(0, MAP_SLOTS, map_draws)
    sp.sample_flat(slots)
    states, nbytes_, save_s, load_s = through_disk(d / "spatial", spatial=sp)
    sp2 = SpatialSampler.restore(states["spatial"], device=device)
    for _ in range(2):
        check(np.array_equal(sp.sample_flat(slots), sp2.sample_flat(slots)),
              "restored SpatialSampler's drain == the original's")
    del sp, sp2, states
    print(f"robust: SpatialSampler over env_map_2d{tuple(map_hw)} through disk: "
          f"{nbytes_} bytes, save {save_s:.3f} s, load {load_s:.3f} s; the next 2 drains of "
          f"{map_draws} == the original's", flush=True)

    cfg = cfg or C.get(SERVE_ARCH)
    max_seq = max_seq or SERVE_MAX_SEQ
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    eng = ServeEngine(model, cfg, n_slots=SERVE_SLOTS, max_seq=max_seq,
                      sampler=TokenSampler(mode="inverse_qmc", n_slots=SERVE_SLOTS,
                                           device=device), device=device)
    for r in serve_requests(cfg, n_requests, 2, 16, 8, min(64, max_seq // 2), seed=3):
        eng.submit(r)
    for _ in range(ROBUST_STEPS):
        eng.step()
    states, nbytes_, save_s, load_s = through_disk(d / "engine", engine=eng)
    twin = ServeEngine.restore(states["engine"], params=model, cfg=cfg, device=device)
    del states
    live = {r.rid: r for r in [s for s in eng.slots if s is not None] + list(eng.queue)}
    copy = {r.rid: r for r in [s for s in twin.slots if s is not None] + list(twin.queue)}
    check(set(live) == set(copy) and len(live) > SERVE_SLOTS, "restored engine's requests")
    before = {rid: len(r.out) for rid, r in live.items()}
    eng.run(max_steps=1000)
    twin.run(max_steps=1000)
    check(all(r.done and copy[rid].done and r.out[before[rid]:] == copy[rid].out[before[rid]:]
              for rid, r in live.items()), "restored engine's tokens == the original's")
    print(f"robust: ServeEngine ({cfg.name} {cfg.dtype}, {SERVE_SLOTS} slots, KV cache of "
          f"{max_seq}) saved after {ROBUST_STEPS} steps with {len(live)} live or queued "
          f"requests: {nbytes_} bytes, save {save_s:.3f} s, load {load_s:.3f} s; the "
          f"{sum(len(r.out) - before[rid] for rid, r in live.items())} tokens after the "
          f"restore == the original's", flush=True)
    shutil.rmtree(d, ignore_errors=True)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


DIST_UPDATE_LEAVES = 64


def dist_path(device, weights: np.ndarray, m: int, n_draws: int, gen) -> dict:
    """The sharded forest over a single-rank nccl group at the main path's
    size: ``build_cdf_sharded``, ``build_forest_sharded`` (n = m = 2^20),
    ``n_draws`` uniforms through ``sample_sharded`` routed and not, the
    drain plan, a sparse ``update_forest_sharded`` of 64 leaves; host-clock
    times around synchronized calls. The comparisons are in
    ``dist_checks``."""
    from repro_torch.dist import forest as DF

    w = torch.as_tensor(weights, dtype=torch.float32, device=device)

    def timed_call(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    cdf, cdf_s = timed_call(lambda: DF.build_cdf_sharded(w, device=device))
    sf, build_s = timed_call(lambda: DF.build_forest_sharded(w, m, device=device))
    xi = torch.rand(n_draws, generator=gen, device=device)
    routed, routed_s = timed_call(lambda: DF.sample_sharded(sf, xi, device=device))
    oracle, oracle_s = timed_call(lambda: DF.sample_sharded(sf, xi, routed=False, device=device))
    plan = DF.drain_plan(sf, xi, device=device)
    rng = np.random.default_rng(9)
    upd_s = []
    for _ in range(2):  # two updates of the same forest, other leaves
        w1 = weights.copy()
        w1[rng.choice(len(w1), DIST_UPDATE_LEAVES, replace=False)] *= np.float32(1.5)
        (upd, st), dt = timed_call(lambda: DF.update_forest_sharded(sf, w1, with_stats=True,
                                                                   device=device))
        upd_s.append(dt)
    print(f"dist: single-rank nccl group, n = m = {m}: build_cdf_sharded {cdf_s * 1e3:.3f} ms, "
          f"build_forest_sharded {build_s * 1e3:.3f} ms (capacity {sf.capacity}); "
          f"sample_sharded of {n_draws}: routed {routed_s * 1e3:.3f} ms "
          f"({n_draws / routed_s:.6e} draws/s), all-reduce oracle {oracle_s * 1e3:.3f} ms; "
          f"update_forest_sharded of {DIST_UPDATE_LEAVES} leaves "
          f"{' / '.join(f'{x * 1e3:.3f}' for x in upd_s)} ms "
          f"(host clock, synchronized, first calls); drain plan "
          f"{ {k: v for k, v in plan.items() if k != 'send_counts'} }, "
          f"send counts {plan['send_counts'].tolist()}; update stats {st}", flush=True)
    return dict(cdf=cdf, sf=sf, xi=xi, routed=routed, oracle=oracle, w1=w1, upd=upd)


def dist_checks(rec: dict, device, weights: np.ndarray, m: int) -> None:
    """The sharded results against the unsharded ones on the card:
    ``gather_forest`` against ``build_forest``'s six arrays bit for bit,
    both drains against ``sample_forest`` elementwise, the update against
    a from-scratch sharded build over the same partition and capacity and,
    gathered, against ``build_forest`` of the new weights."""
    from repro_torch.core.forest import build_forest
    from repro_torch.core.sample import sample_forest
    from repro_torch.dist import forest as DF

    f = build_forest(torch.as_tensor(weights, device=device), m, device=device)
    check(torch.equal(rec["cdf"].view(torch.int32), f.cdf.view(torch.int32)),
          "build_cdf_sharded == build_cdf, bit for bit")
    for k, a, b in zip(f._fields, DF.gather_forest(rec["sf"]), f):
        check(torch.equal(a, b), f"gather_forest {k} == build_forest's, bit for bit")
    want = sample_forest(f, rec["xi"], device=device)
    check(torch.equal(rec["routed"], want), "routed sample_sharded == sample_forest")
    check(torch.equal(rec["oracle"], want), "all-reduce sample_sharded == sample_forest")
    ref = DF.build_forest_sharded(rec["w1"], m, partition=rec["sf"].cell_bounds.cpu().numpy(),
                                  capacity=rec["upd"].capacity, device=device)
    for k, a, b in zip(ref._fields, rec["upd"], ref):
        check(torch.equal(a, b), f"update_forest_sharded {k} == a from-scratch sharded build")
    f1 = build_forest(torch.as_tensor(rec["w1"], device=device), m, device=device)
    for k, a, b in zip(f1._fields, DF.gather_forest(rec["upd"]), f1):
        check(torch.equal(a, b), f"gather_forest of the update {k} == build_forest's")
    print("dist checks: gather_forest == build_forest (six arrays, bit for bit); routed and "
          "all-reduce drains == sample_forest elementwise; the sparse update == a "
          "from-scratch sharded build over the same partition and capacity, and its "
          "gather_forest == build_forest of the new weights (six arrays, bit for bit)",
          flush=True)


SERVE_ARCH = "qwen1_5_0_5b"  # 24 layers, d_model 1024, 16 heads, vocab 151936
SERVE_SLOTS = 16
SERVE_MAX_SEQ = 256
SERVE_REQUESTS = 32          # model-backed, prompts of 8..64 tokens
SERVE_PRIORS = 4             # prior-backed requests beside them
SERVE_MAX_NEW = 32
SERVE_CHI2_DRAWS = 1 << 20
SERVE_ROWS_SHAPES = ((16, 151936, 1), (256, 151936, 1))  # B9 timed alone
# B9's per-call times before its warp-per-draw design (a block of 256 threads
# a draw), measured by tools/ab_sample_rows.py on an NVIDIA H100 80GB HBM3 at
# 700 W; printed beside this run's times, never measured here.
SAMPLE_ROWS_BLOCK_MS = {(16, 151936, 1): 0.003146, (256, 151936, 1): 0.003648}
DECODE_ATOL = 1e-3           # decode vs prefill logits, float32, full width


class SamplerCalls:
    """Records every TokenSampler call on the decode path: the scan's input
    and CDF rows (``ops.fused_cdf``), then the uniforms and tokens of the
    inverse (``ops.sample_rows``), by wrapping the two ``ops`` entry points
    for the life of a ``with`` block. The wrapped calls still launch the
    kernels and count."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.calls = ops, []
        self.fused, self.rows = ops.fused_cdf, ops.sample_rows

        def fused_cdf(x, softmax=True):
            out = self.fused(x, softmax=softmax)
            self.calls.append({"x": x, "cdf": out})
            return out

        def sample_rows(cdf, xi):
            out = self.rows(cdf, xi)
            check(self.calls and self.calls[-1]["cdf"] is cdf, "sample_rows after fused_cdf")
            self.calls[-1].update(xi=xi, out=out)
            return out

        ops.fused_cdf, ops.sample_rows = fused_cdf, sample_rows
        return self

    def __exit__(self, *exc):
        self.ops.fused_cdf, self.ops.sample_rows = self.fused, self.rows


def serve_requests(cfg, n_requests: int, n_priors: int, max_new: int, prompt_lo: int,
                   prompt_hi: int, seed: int):
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(prompt_lo,
                                                                             prompt_hi + 1))),
                    max_new=max_new) for i in range(n_requests)]
    reqs += [Request(rid=1000 + i, prompt=np.zeros(1, np.int64), max_new=max_new,
                     prior=rng.random(int(rng.integers(100, 5000))) ** 3 + 1e-6)
             for i in range(n_priors)]
    return reqs


def serve_path(device, cfg, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
               n_requests=SERVE_REQUESTS, n_priors=SERVE_PRIORS, max_new=SERVE_MAX_NEW,
               prompt_lo=8, prompt_hi=64) -> dict:
    """The serving path through the user entry points: a ServeEngine over
    a seeded random model, model and prior traffic, run to completion, every
    step synchronized and timed. Returns what the checks need."""
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine, TokenSampler

    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    print(f"serve: {cfg.name} {cfg.dtype}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}, {sum(p.numel() for p in model.parameters())} parameters, "
          f"seeded init {time.perf_counter() - t:.3f} s", flush=True)
    eng = ServeEngine(model, cfg, n_slots=n_slots, max_seq=max_seq,
                      sampler=TokenSampler(mode="inverse_qmc", n_slots=n_slots, device=device),
                      device=device)
    reqs = serve_requests(cfg, n_requests, n_priors, max_new, prompt_lo, prompt_hi, 0)
    for r in reqs:
        eng.submit(r)
    decode_s, decode_tokens, wall = 0.0, 0, 0.0
    with SamplerCalls() as rec:
        while eng.queue or any(eng.slots):
            queued = len(eng.queue)
            before = sum(len(r.out) for r in reqs[:n_requests])
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            wall += dt
            if len(eng.queue) == queued:  # no admission: a pure decode step
                decode_s += dt
                decode_tokens += sum(len(r.out) for r in reqs[:n_requests]) - before
            check(eng.steps < 10 * max_new * (len(reqs) // n_slots + 2), "engine terminates")
    check(all(r.done and r.error is None and len(r.out) == max_new for r in reqs),
          "every request served in full")
    check(all(0 <= t_ < cfg.vocab for r in reqs[:n_requests] for t_ in r.out), "token range")
    check(all(0 <= t_ < len(r.prior) for r in reqs[n_requests:] for t_ in r.out),
          "prior token range")
    check(eng.prior_sampler.pool.stats()["tenants"] == 0, "prior tenants evicted")
    toks = sum(len(r.out) for r in reqs)
    print(f"serve: {len(reqs)} requests ({n_requests} model, {n_priors} prior), {toks} tokens "
          f"in {eng.steps} steps, {wall:.3f} s (host clock, synchronized steps; "
          f"{toks / wall:.1f} tokens/s); decode-only steps: {decode_tokens} model tokens "
          f"in {decode_s:.3f} s, {decode_tokens / max(decode_s, 1e-9):.1f} tokens/s",
          flush=True)
    return dict(model=model, engine=eng, reqs=reqs, calls=rec.calls,
                decode_tokens_per_s=decode_tokens / max(decode_s, 1e-9))


def check_sampler_call(c: dict) -> tuple[float, int]:
    """One recorded sampler call: its CDF rows within SCAN_ATOL of the plain
    scan of the same input (run on the CPU copy, whose sequential cumsum
    errs least: the card's drifts by up to ~2e-6 at 151936), its tokens
    equal to the plain inverse on those same rows. Returns (scan error,
    index error)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cdf_scan import SCAN_ATOL

    check("out" in c, "every fused_cdf call followed by sample_rows")
    e = float((c["cdf"].cpu() - ref.ref_cdf_scan(c["x"].cpu())).abs().max())
    check(e <= SCAN_ATOL, f"sampler CDF rows within SCAN_ATOL ({e})")
    plain = ref.ref_sample_rows(c["cdf"], c["xi"])
    check(torch.equal(c["out"], plain), "sampler tokens == plain inverse on the same rows")
    return e, int((c["out"] - plain).abs().max())


def serve_checks(rec: dict, device) -> float:
    """Every sampler call of the serve run through check_sampler_call.
    Returns the largest index error."""
    from repro_torch.kernels.cdf_scan import SCAN_ATOL

    scan_err, idx_err, rows = 0.0, 0, 0
    for c in rec["calls"]:
        e, i = check_sampler_call(c)
        scan_err, idx_err = max(scan_err, e), max(idx_err, i)
        rows += c["cdf"].shape[0]
    print(f"serve checks: {len(rec['calls'])} sampler calls, {rows} rows of "
          f"{rec['calls'][0]['cdf'].shape[1]}: tokens == plain ref_sample_rows on the same "
          f"card CDF rows; rows vs plain ref_cdf_scan (CPU copy) max |err| {scan_err:.3e} "
          f"(SCAN_ATOL {SCAN_ATOL})", flush=True)
    return float(idx_err)


def serve_model_check(device, cfg) -> None:
    """Decode after prefill equals prefill of the longer prompt, float32 at
    full width (matmuls in full float32: TF32 off)."""
    import dataclasses

    from repro_torch.models import decode_step, init_params, prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = init_params(cfg32, torch.Generator(device=device).manual_seed(1), device)
    toks = torch.randint(0, cfg.vocab, (2, 33), generator=torch.Generator().manual_seed(2))
    want, _, _ = prefill(model, cfg32, {"tokens": toks}, 64)
    _, cache, _ = prefill(model, cfg32, {"tokens": toks[:, :32]}, 64)
    got, _ = decode_step(model, cfg32, cache, toks[:, 32], torch.tensor([32, 32]))
    err = float((got - want).abs().max())
    print(f"serve model check: float32 {cfg.name}, decode after prefill(32) vs prefill(33): "
          f"max |logit err| {err:.3e} (atol {DECODE_ATOL}; logits max "
          f"{float(want.abs().max()):.3f})", flush=True)
    check(err <= DECODE_ATOL, "decode matches prefill at full width")


def serve_chi_square(rec: dict, device, gen, n_draws: int) -> None:
    """2^20 kernel draws from one fixed decode row (the first call's) against
    its float64 softmax, over 1024 equal-mass bins."""
    from repro_torch.core.metrics import chi2_statistic, histogram
    from repro_torch.kernels.cdf_scan import cdf_scan
    from repro_torch.kernels.sample_tiled import sample_rows

    x = rec["calls"][0]["x"][:1]
    cdf = cdf_scan(x)
    idx = sample_rows(cdf, torch.rand(1, n_draws, generator=gen, device=device))
    p = torch.softmax(x.double(), dim=-1)[0].cpu().numpy()
    cdf64 = np.concatenate([[0.0], np.cumsum(p)])
    bins = np.minimum((cdf64[:-1] + cdf64[1:]) * 0.5 * 1024, 1023).astype(np.int64)
    counts = np.bincount(bins, weights=histogram(idx[0].cpu().numpy(), len(p)), minlength=1024)
    mass = np.bincount(bins, weights=p, minlength=1024)
    used = mass > 0
    chi2 = chi2_statistic(counts[used], mass[used] / mass[used].sum())
    dof = int(used.sum()) - 1
    limit = dof + 6.0 * np.sqrt(2.0 * dof)
    print(f"serve chi-square: {n_draws} draws from one decode row of {len(p)}, "
          f"{int(used.sum())} equal-mass bins: {chi2:.3f} (dof {dof}, limit {limit:.3f})",
          flush=True)
    check(chi2 < limit, "decode row chi-square")


def serve_other_modes(rec: dict, device, cfg) -> None:
    """A few steps in inverse_rng and alias mode on the same model, and the
    launcher once on the card."""
    from repro_torch.serve import ServeEngine, TokenSampler

    for mode, n_req, max_new in (("inverse_rng", 4, 4), ("alias", 2, 3)):
        eng = ServeEngine(rec["model"], cfg, n_slots=2, max_seq=64,
                          sampler=TokenSampler(mode=mode, n_slots=2, device=device),
                          device=device)
        reqs = serve_requests(cfg, n_req, 0, max_new, 8, 16, 5)
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=100)
        check(all(r.done and len(r.out) == max_new and all(0 <= t < cfg.vocab for t in r.out)
                  for r in reqs), f"{mode} engine")
        print(f"serve {mode}: {n_req} requests x {max_new} tokens in {eng.steps} steps",
              flush=True)
    root = Path(__file__).resolve().parent
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen1.5-0.5b",
         "--requests", "4", "--slots", "2", "--max-new", "4", "--device", device.type],
        capture_output=True, text=True, timeout=600, cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    check(out.returncode == 0 and "served 4/4" in out.stdout,
          f"launcher on the card: {out.stdout[-400:]} {out.stderr[-2000:]}")
    print(f"launcher: {out.stdout.strip()}", flush=True)


def serve_kernels(device, gen, shapes=SERVE_ROWS_SHAPES) -> dict:
    """sample_rows alone at decode shapes: elementwise against its plain
    version, timed beside the plain version and torch.searchsorted, each
    by cuda_ms_per_call (calls queued behind a spin, run back to back
    between one pair of CUDA events: a single call under events times the
    host's launch, not these microsecond kernels).
    The bound counts the bytes the two-level search must read: nt cutpoints
    at one 32 B sector each plus one 2 KB tile per draw, plus the uniform in
    and the index out. Beside it the launch floor: the library's empty kernel
    (one warp) timed the same way, which no launch of the library beats; and
    the time of B9's earlier design (``SAMPLE_ROWS_BLOCK_MS``, recorded)."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.cdf_scan import cdf_scan
    from repro_torch.kernels.sample_tiled import TILE, sample_rows

    floor = cuda_ms_per_call(lambda: _build.empty_launch(device), 100)
    print(f"launch floor: the kernel library's empty kernel (one warp) {floor:.6f} ms per "
          f"call (queued behind a spin, back to back between CUDA events)", flush=True)
    rows = {}
    for B, V, k in shapes:
        cdf = cdf_scan(torch.randn((B, V), generator=gen, device=device) * 3.0)
        xi = torch.rand((B, k), generator=gen, device=device)
        got, want = sample_rows(cdf, xi), ref.ref_sample_rows(cdf, xi)
        check(torch.equal(got, want), f"sample_rows == plain at {(B, V, k)}")
        nt = -(-V // TILE)
        r = dict(max_abs_err=float((got - want).abs().max()),
                 ms=cuda_ms_per_call(lambda: sample_rows(cdf, xi), 100),
                 plain_ms=cuda_ms_per_call(lambda: ref.ref_sample_rows(cdf, xi), 20),
                 library_ms=cuda_ms_per_call(
                     lambda: torch.searchsorted(cdf, xi, right=True), 100),
                 bound=bound_ms(B * k * (nt * 32 + TILE * 4 + 4 + 4)), launch_floor_ms=floor)
        block = SAMPLE_ROWS_BLOCK_MS.get((B, V, k))
        earlier = "not recorded" if block is None else f"{block:.6f} ms (recorded, not this run)"
        print(f"sample_rows {(B, V, k)}: elementwise == plain; kernel {r['ms']:.6f} ms, "
              f"plain {r['plain_ms']:.6f} ms, torch.searchsorted {r['library_ms']:.6f} ms "
              f"(per call, queued behind a spin, back to back between CUDA events); byte "
              f"bound {r['bound'][0]:.6f} ms, launch floor {floor:.6f} ms, kernel "
              f"{r['ms'] - floor:.6f} ms above the floor; the earlier block-a-draw design "
              f"{earlier}; one call under events: kernel "
              f"{cuda_ms(lambda: sample_rows(cdf, xi), 50):.4f} ms; "
              f"device time per call (profiler, 50 calls): "
              f"kernel {device_ms(lambda: sample_rows(cdf, xi), 50):.4f} ms, plain "
              f"{device_ms(lambda: ref.ref_sample_rows(cdf, xi), 50):.4f} ms, "
              f"torch.searchsorted "
              f"{device_ms(lambda: torch.searchsorted(cdf, xi, right=True), 50):.4f} ms",
              flush=True)
        rows.setdefault("sample_rows", r)  # the first shape: the decode path's
        rows["sample_rows"].setdefault("at_shapes", []).append(
            {"shape": [B, V, k], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "library_ms": r["library_ms"], "bound_ms": r["bound"][0],
             "launch_floor_ms": floor})
    return rows


SCAN_DECODE_SHAPE = (16, 151936)  # the decode path's softmax rows (B3)
# (B, V, mode) rows whose bits must not depend on the rows beside them: each
# regime of scan_plan (warp rows, 1-, 4- and 8-block clusters, one block)
SCAN_STACK_CASES = ((64, 1024, "raw"), (16, 2049, "weights"), (64, 16384, "raw"),
                    (16, 151936, "softmax"), (16, 300000, "softmax"))


def scan_decode_times(device, gen) -> dict:
    """B3 at the decode shape, bf16 (the engine's logits) and float32: held
    to the plain version on the CPU copy within SCAN_ATOL, and timed per
    call (cuda_ms_per_call) beside the plain version on the card,
    ``torch.cumsum(torch.softmax(x.float(), -1), -1)`` (two library calls:
    no single one computes the function) and ``torch.cumsum`` alone. The
    bound reads each logit once (2 or 4 B) and writes each float32 once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cdf_scan import SCAN_ATOL, cdf_scan

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(SCAN_DECODE_SHAPE, generator=gen, device=device) * 3.0).to(dtype)
        got = cdf_scan(x)
        err = float((got.cpu() - ref.ref_cdf_scan(x.cpu())).abs().max())
        check(err <= SCAN_ATOL, f"cdf_scan at the decode shape {dtype} ({err})")
        p = torch.softmax(x.float(), -1)
        r = dict(max_abs_err=err,
                 ms=cuda_ms_per_call(lambda: cdf_scan(x), 100),
                 plain_ms=cuda_ms_per_call(lambda: ref.ref_cdf_scan(x), 20),
                 library_ms=cuda_ms_per_call(
                     lambda: torch.cumsum(torch.softmax(x.float(), -1), -1), 100),
                 cumsum_ms=cuda_ms_per_call(lambda: torch.cumsum(p, -1), 100),
                 bound=bound_ms(nbytes(x) + x.numel() * 4))
        name = str(dtype).split(".")[-1]
        print(f"cdf_scan decode {SCAN_DECODE_SHAPE} {name} softmax: max |err| vs plain "
              f"{err:.3e}; kernel {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
              f"softmax+cumsum (two calls) {r['library_ms']:.6f} ms, cumsum alone "
              f"{r['cumsum_ms']:.6f} ms (per call, queued behind a spin); bound "
              f"{r['bound'][0]:.6f} ms ({r['bound'][1]})", flush=True)
        out[name] = r
    return out


def scan_stack_check(device, gen) -> None:
    """A row's scan bits depend only on the row: the same row alone, in a
    stack of 7 and in the whole stack, and a second run, are bit-equal."""
    from repro_torch.kernels.cdf_scan import cdf_scan, scan_plan

    for B, V, mode in SCAN_STACK_CASES:
        softmax, normalize = mode == "softmax", mode != "raw"
        x = torch.randn((B, V), generator=gen, device=device) * 3.0
        x = x.to(torch.bfloat16) if softmax else x.abs()
        full = cdf_scan(x, softmax=softmax, normalize=normalize).view(torch.int32)
        again = cdf_scan(x, softmax=softmax, normalize=normalize).view(torch.int32)
        seven = cdf_scan(x[3:10], softmax=softmax, normalize=normalize).view(torch.int32)
        alone = cdf_scan(x[5:6], softmax=softmax, normalize=normalize).view(torch.int32)
        check(torch.equal(full, again), f"cdf_scan repeatable at {(B, V, mode)}")
        check(torch.equal(seven, full[3:10]) and torch.equal(alone, full[5:6]),
              f"cdf_scan row bits independent of the stack at {(B, V, mode)}")
        print(f"cdf_scan {(B, V)} {mode} (plan {tuple(scan_plan(V))}): a row alone, in 7 "
              f"and in {B}, and a second run, bit-equal", flush=True)


def serve_profile(rec: dict, device, cfg) -> None:
    """Device busy share of one decode step with every slot busy."""
    from repro_torch.serve import ServeEngine, TokenSampler

    eng = ServeEngine(rec["model"], cfg, n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
                      sampler=TokenSampler(n_slots=SERVE_SLOTS, device=device), device=device)
    for r in serve_requests(cfg, SERVE_SLOTS, 0, 64, 32, 32, 9):
        eng.submit(r)
    eng.step()  # admission and prefills
    eng.step()
    profile_calls((("engine decode step (16 busy slots)", eng.step),))


# ---------------------------------------------------------------------------
# The train phase: kernel B10, the eval forward and the Trainer at
# Qwen1.5-0.5B's widths.
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen1_5_0_5b"
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM dense TF32 tensor cores
# (B, S, H, KV, hd, dtype, causal): the eval shape, Qwen3-4B's GQA, ragged
# float32, the eval shape in float32, Kimi K2's heads (hd 112: the hd-128
# tile over zero-filled columns)
FLASH_SHAPES = ((2, 2048, 16, 16, 64, torch.bfloat16, True),
                (1, 1024, 32, 8, 128, torch.bfloat16, True),
                (1, 1000, 4, 2, 64, torch.float32, False),
                (2, 2048, 16, 16, 64, torch.float32, True),
                (1, 1024, 64, 8, 112, torch.bfloat16, True))
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the JAX suite's
# B10's float32 times per call before its three-TF32 tensor-core body (the
# CUDA-core body), measured by tools/ab_flash_f32.py on an NVIDIA H100 80GB
# HBM3 at 700 W; printed beside this run's times, never measured here.
FLASH_F32_CUDA_CORE_MS = {(1, 1000, 4, 2, 64, False): 0.128634,
                          (2, 2048, 16, 16, 64, True): 0.995504}
EVAL_B, EVAL_S = 2, 2048
EVAL_NLL_ATOL = 1e-2        # flash vs einsum nll, bf16 at full width
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 256, 4
MIXTURE = (0.5, 0.25, 0.125, 0.125)


def flash_sass_check() -> str:
    """Every instance of B10 issues tensor-core instructions in the library's
    SASS, ``HGMMA`` (wgmma): the bf16 ones on bf16, the float32 ones on TF32
    (three products for each)."""
    from repro_torch.kernels import _build

    sass = {n: t for n, t in _build.sass().items() if "flash_attention" in n}
    bf16 = {n: t.count("HGMMA") for n, t in sass.items() if "bf16" in n}
    f32 = {n: t.count("HGMMA") for n, t in sass.items() if "f32" in n}
    check(len(bf16) == 4 and all(bf16.values()), f"HGMMA in every bf16 B10 instance: {bf16}")
    check(len(f32) == 4 and all(f32.values()), f"HGMMA in every float32 B10 instance: {f32}")
    return (f"HGMMA instructions per bf16 instance {sorted(bf16.values())}, "
            f"per float32 instance {sorted(f32.values())}: all on the tensor cores")


def flash_kernels(device, gen, build_s: float) -> dict:
    """B10 against its plain version at the three FLASH_SHAPES, timed
    (``cuda_ms_per_call``) beside the plain version and
    ``scaled_dot_product_attention`` on the same tensors (K/V expanded for
    GQA and all three laid out (B, heads, S, hd) before timing). The bound:
    the larger of q/k/v/o bytes over 3.35 TB/s and the unmasked
    score-and-value FLOPs (``2*2*B*H*hd`` per visible (query, key) pair)
    over the dense tensor-core peak of the inputs' type; for float32 the
    work over the CUDA-core peak (67 TFLOP/s), and beside it the three TF32
    products the float32 body issues (3x the FLOPs) over the dense TF32
    peak (495 TFLOP/s), with the earlier CUDA-core body's recorded time
    (``FLASH_F32_CUDA_CORE_MS``). The achieved rate is the FLOPs over the
    kernel's time. Also the SASS check of the tensor-core instances and the
    library's build time (``build_s``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    print(f"flash_attention SASS: {flash_sass_check()}; kernel library (all sources, "
          f"parallel nvcc and link) built in {build_s:.3f} s", flush=True)
    rows = {}
    for B, S, H, KV, hd, dt, causal in FLASH_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(dt)
                   for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
        got, want = flash_attention(q, k, v, causal), ref.ref_flash_attention(q, k, v, causal)
        tol = FLASH_TOL[dt]
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"flash_attention within {tol} of plain at {(B, S, H, KV, hd, dt, causal)}")
        qt, kt, vt = (t.repeat_interleave(H // t.shape[2], dim=2).transpose(1, 2).contiguous()
                      for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        lib_err = float((sdpa().transpose(1, 2).float() - want.float()).abs().max())
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = 2 * 2 * B * H * pairs * hd
        peak = BF16_OPS_PER_S if dt == torch.bfloat16 else F32_OPS_PER_S
        r = dict(max_abs_err=err,
                 ms=cuda_ms_per_call(lambda: flash_attention(q, k, v, causal), 10),
                 plain_ms=cuda_ms_per_call(lambda: ref.ref_flash_attention(q, k, v, causal), 3),
                 library_ms=cuda_ms_per_call(sdpa, 20),
                 bound=bound_ms(nbytes(q, k, v, got), flops, peak))
        extra = ""
        if dt == torch.float32:
            r["bound_tf32x3_ms"] = 3 * flops / TF32_OPS_PER_S * 1e3
            older = FLASH_F32_CUDA_CORE_MS.get((B, S, H, KV, hd, causal))
            extra = (f"; three TF32 products over 495 TFLOP/s {r['bound_tf32x3_ms']:.4f} ms "
                     f"({r['bound_tf32x3_ms'] / r['ms']:.1%} of that rate, "
                     f"{3 * flops / r['ms'] / 1e9:.1f} TFLOP/s of TF32); the earlier "
                     f"CUDA-core body "
                     + ("not recorded" if older is None
                        else f"{older:.4f} ms (recorded, not this run)"))
        print(f"flash_attention {(B, S, H, KV, hd)} {str(dt)[6:]} causal={causal}: max |err| "
              f"vs plain {err:.3e} (tol {tol}); SDPA vs plain {lib_err:.3e}; kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
              f"(per call, queued behind a spin); bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}; {flops / 1e9:.2f} GFLOP, {nbytes(q, k, v, got) / 1e6:.1f} MB); "
              f"{flops / r['ms'] / 1e9:.1f} TFLOP/s, {r['bound'][0] / r['ms']:.1%} of the "
              f"bound's rate{extra}", flush=True)
        rows.setdefault("flash_attention", r)  # the first shape: the eval path's
        if hd == 112:
            rows["flash_attention"]["at_hd112"] = {
                "shape": [B, S, H, KV, hd], "causal": causal, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "max_abs_err": err}
        if dt == torch.float32:
            rows["flash_attention"].setdefault("at_f32", []).append(
                {"shape": [B, S, H, KV, hd], "causal": causal, "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                 "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                 "bound_tf32x3_ms": r["bound_tf32x3_ms"], "max_abs_err": err})
    return rows


def eval_path(device, cfg, B=EVAL_B, S=EVAL_S) -> dict:
    """``loss_fn`` without gradients at full width in bf16 (seeded random
    weights) on one ``make_batch`` batch, with ``attn_impl="flash"`` (twice:
    a warm-up and a timed call) and ``"einsum"``."""
    import dataclasses

    from repro_torch.data import MixtureSampler, make_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import init_params, loss_fn

    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    batch = make_batch(cfg, 0, B, S, mixture=MixtureSampler(MIXTURE, device=device))
    flash = dataclasses.replace(cfg, attn_impl="flash")
    with torch.no_grad():
        loss_fn(model, flash, batch)
        check(flash_attention.launches == cfg.n_layers, "B10 once per layer of a forward")
        torch.cuda.synchronize()
        t = time.perf_counter()
        lf, mf = loss_fn(model, flash, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        le, me = loss_fn(model, cfg, batch)
    nf, ne = float(mf["nll"]), float(me["nll"])
    check(math.isfinite(nf) and math.isfinite(ne), "finite eval nll")
    print(f"eval: {cfg.name} bf16, loss_fn without gradients on {B} x {S} tokens: nll flash "
          f"{nf:.6f}, einsum {ne:.6f}, |diff| {abs(nf - ne):.3e} (bound {EVAL_NLL_ATOL}); "
          f"flash eval {dt * 1e3:.3f} ms, {B * S / dt:.1f} tokens/s (host clock, synchronized); "
          f"B10 launches {flash_attention.launches} ({cfg.n_layers} a forward)", flush=True)
    check(abs(nf - ne) <= EVAL_NLL_ATOL, "flash and einsum eval nll agree")
    return dict(model=model, batch=batch, cfg=flash)


def eval_profile(rec: dict) -> None:
    """Device busy share and launches of one flash eval forward."""
    from repro_torch.models import forward

    def fwd():
        with torch.no_grad():
            forward(rec["model"], rec["cfg"], rec["batch"])

    profile_calls(((f"eval forward (flash, {EVAL_B} x {EVAL_S})", fwd),))


def train_path(device, cfg, ckpt_root: Path, B=TRAIN_B, S=TRAIN_S, steps=TRAIN_STEPS) -> dict:
    """The Trainer at full width (float32 masters, compute in cfg.dtype,
    einsum attention): ``steps`` steps with a checkpoint at the end; then a
    second run killed at step 2 (after its step-2 checkpoint) and resumed
    to the end. Both runs under ``torch.use_deterministic_algorithms``:
    the resumed run's parameters and last loss must equal the first run's
    bit for bit."""
    import shutil

    from repro_torch.train import TrainConfig, Trainer

    shutil.rmtree(ckpt_root, ignore_errors=True)

    def tc(name, every):
        return TrainConfig(steps=steps, global_batch=B, seq_len=S, ckpt_dir=str(ckpt_root / name),
                           ckpt_every=every, keep=1, log_every=1)

    logs = []
    first = Trainer(cfg, tc("a", 1000), log_fn=logs.append, device=device)
    crashy = Trainer(cfg, tc("b", 2), fail_at_step=2, log_fn=logs.append, device=device)
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        a = first.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        try:
            crashy.run()
            check(False, "the injected failure fires")
        except RuntimeError as e:
            check("injected failure at step 2" in str(e), f"injected failure: {e}")
        b = Trainer(cfg, tc("b", 2), log_fn=logs.append, device=device).run()
    finally:
        torch.use_deterministic_algorithms(False)
    losses = [m["loss"] for m in a["metrics"]]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses), "finite train losses")
    check(losses[-1] < losses[0], f"train loss falls: {losses}")
    check(any("resumed from step 2" in line for line in logs), "resumed from the step-2 checkpoint")
    same = all(torch.equal(p, q) for p, q in zip(a["params"].parameters(),
                                                 b["params"].parameters()))
    check(same and b["final_loss"] == a["final_loss"],
          f"resumed run bitwise equal: loss {b['final_loss']!r} vs {a['final_loss']!r}")
    n_params = sum(p.numel() for p in a["params"].parameters())
    print(f"train: {cfg.name}, {n_params} parameters (float32 masters, {cfg.dtype} compute, "
          f"einsum attention), global batch {B} x {S}, {steps} steps: losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; run with init and one checkpoint "
          f"{wall:.3f} s; peak memory {peak / 2**30:.3f} GiB; killed at step 2 and resumed: "
          f"final loss {b['final_loss']!r} == {a['final_loss']!r} and every parameter "
          f"bitwise equal (torch.use_deterministic_algorithms(True))", flush=True)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    return dict(trainer=first, out=a)


def train_replay(device, cfg, B=TRAIN_B, S=TRAIN_S, steps=TRAIN_STEPS) -> None:
    """The train path's launches of the port's kernels again, for their
    device time: the three Trainers' MixtureSamplers (B3, B2, B1's pack)
    and their batches (B1: steps 0..steps-1 of the first run, 0 and 1 of
    the run killed at step 2, 2..steps-1 of the resumed one). The
    Trainers' steps and checkpoints launch none of the port's kernels, and
    rerunning them (two 5.6 GB checkpoints) would cost the smoke ~45 s."""
    from repro_torch.data import MixtureSampler, make_batch

    for run in (range(steps), range(2), range(2, steps)):
        mixture = MixtureSampler(MIXTURE, seed=0, device=device)
        for step in run:
            make_batch(cfg, step, B, S, mixture=mixture, seed=0)


def train_timing(rec: dict, cfg, device, B=TRAIN_B, S=TRAIN_S) -> None:
    """ms per train step (host clock around synchronized steps, median of
    3, after the run's own steps) and the device busy share of one more."""
    from repro_torch.data import make_batch

    tr, out = rec["trainer"], rec["out"]
    params, opt = out["params"], out["opt"]
    times = []
    for step in range(TRAIN_STEPS, TRAIN_STEPS + 3):
        batch = make_batch(cfg, step, B, S, mixture=tr.mixture)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = tr.step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(times)
    print(f"train step: {ms:.3f} ms (median of 3, host clock, synchronized), "
          f"{B * S / ms * 1e3:.1f} tokens/s", flush=True)
    batch = make_batch(cfg, TRAIN_STEPS + 3, B, S, mixture=tr.mixture)
    profile_calls((("train step (8 x 256, float32 masters)",
                    lambda: tr.step_fn(params, opt, batch)),))
    ckpt_timing(tr, params, opt)


def ckpt_timing(tr, params, opt) -> None:
    """The trainer's checkpoint save at full width, host clock: the
    parameters and AdamW state in JAX's layout (per-period leaves stacked
    and transposed on the host), and that map alone."""
    import shutil

    from repro_torch.ckpt import save

    d = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt_timing"
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    save(d, tr._tree(params, opt), 1)
    save_s = time.perf_counter() - t
    nbytes_ = disk_bytes(d)
    shutil.rmtree(d, ignore_errors=True)
    t = time.perf_counter()
    tr._tree(params, opt)
    map_s = time.perf_counter() - t
    print(f"checkpoint save ({sum(p.numel() for p in params.parameters())} parameters and "
          f"AdamW moments, {nbytes_} bytes, JAX layout; host clock): {save_s:.3f} s (the "
          f"host copy and map alone {map_s:.3f} s)", flush=True)


def train_launcher(ckpt_root: Path) -> None:
    """The training launcher once on the card, in a subprocess."""
    import shutil

    root = Path(__file__).resolve().parent
    shutil.rmtree(ckpt_root, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
           "--preset", "full", "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_B),
           "--seq", str(TRAIN_S), "--device", "cuda", "--ckpt", str(ckpt_root)]
    t = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")))
    shutil.rmtree(ckpt_root, ignore_errors=True)
    check(out.returncode == 0 and "done: final loss" in out.stdout,
          f"train launcher on the card: {out.stdout[-400:]} {out.stderr[-2000:]}")
    print(f"train launcher ({' '.join(cmd[2:])}): {out.stdout.strip().splitlines()[-1]} "
          f"in {time.perf_counter() - t:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# The families phase: the six LM families beyond the dense one, one model at
# a time in bf16 with seeded weights, each freed before the next.
# ---------------------------------------------------------------------------

FAMILY_SLOTS = 16           # engine slots, and rows of the model-level runs
FAMILY_MAX_NEW = 32         # tokens a request
FAMILY_MAX_SEQ = 128        # KV budget
FAMILY_PROMPTS = (8, 32)    # engine prompt lengths, uniform
FAMILY_PREFILL = 32         # prefill ms: one prompt of this many tokens
WHISPER_FRAMES = 1500       # Whisper's 30 s of audio frames
# decode after prefill(32) vs prefill(33): the logits' relative L2 error
# |got - want| / |want|. A wrong state gives logits independent of the right
# ones, ~1.4. In bf16 the two paths round at other points (the conv's running
# sum beside decode's one product; the mLSTM's chunked form, whose weights
# and outputs are bf16, beside the float32 state of the step form), and the
# error grows with depth: on the CPU in bf16, 0.035 for Jamba's 8-layer
# period at d_model 512, 0 for the attention-only families. xLSTM carries
# more: the reference's chunked mLSTM normalizes by sum_t D_jt (q.k_t)^2 where
# its step form sums D_jt (q.k_t) (ROADMAP C11), and the port follows it, so
# its decode and prefill differ wherever |q.n| > 1, in float32 too (0.112 for
# 48 layers at d_model 512 in JAX and in the port on the CPU; 0.139 at
# published widths on the card, 0.268 in bf16). Whisper, which fits the card
# in float32, is also held in float32 at published widths to
# DECODE_REL2_F32 (float32 at reduced widths agrees with JAX to 1e-6 on the
# CPU: tests/test_torch_families.py).
DECODE_REL2_BF16 = 0.5
DECODE_REL2_F32 = 1e-3
FAMILY_F32_CHECK = ("whisper_small",)
# (arch, run, overrides of the published config, the cut as printed)
FAMILIES = (
    ("xlstm_1_3b", "engine", {},
     "none: published widths, full depth (48 layers)"),
    ("kimi_k2_1t_a32b", "engine", dict(n_layers=1),
     "depth cut to 1 of 61 layers; published widths (384 experts, top-8, 1 shared, hd 112)"),
    ("llama4_maverick_400b_a17b", "engine", dict(n_layers=1),
     "depth cut to 1 of 48 layers; published widths (128 experts, top-1, 1 shared)"),
    ("jamba_1_5_large_398b", "engine", dict(n_layers=8, d_model=4096, d_ff=12288, head_dim=128),
     "one period of 8 layers (of 9) at d_model 4096 (of 8192), d_ff 12288 (of 24576), "
     "head_dim 128; heads, experts, top-k, SSM and vocab published (one period at "
     "published widths is ~90 GB)"),
    ("whisper_small", "model", {},
     "none: 12 encoder and 12 decoder layers, 1500 frames"),
    ("internvl2_76b", "model", dict(n_layers=16),
     "depth cut to 16 of 80 layers; published widths"),
)
FAMILY_EVAL = {"xlstm_1_3b": (1, 256), "whisper_small": (1, WHISPER_FRAMES)}  # else (1, 2048)


def family_cfg(arch: str, over: dict):
    import dataclasses

    import repro_torch.configs as C

    return dataclasses.replace(C.get(arch), **over)


def family_engine(device, cfg, model, trace: bool) -> dict:
    """A ServeEngine of FAMILY_SLOTS slots over the model: one request a
    slot (prompts of 8..32 tokens, 32 new tokens each, ``inverse_qmc``), run
    to completion; the third step (every slot decoding) profiled, the other
    pure decode steps timed. Every sampler call's tokens are held to the
    plain inverse on the same card CDF rows."""
    from repro_torch.models import prefill
    from repro_torch.serve import ServeEngine, TokenSampler

    toks = torch.randint(0, cfg.vocab, (1, FAMILY_PREFILL), device=device,
                         generator=torch.Generator(device=device).manual_seed(3))
    prefill_ms = (None if trace else
                  cuda_ms(lambda: prefill(model, cfg, {"tokens": toks}, FAMILY_MAX_SEQ), 3))
    eng = ServeEngine(model, cfg, n_slots=FAMILY_SLOTS, max_seq=FAMILY_MAX_SEQ,
                      sampler=TokenSampler(mode="inverse_qmc", n_slots=FAMILY_SLOTS,
                                           device=device), device=device)
    reqs = serve_requests(cfg, FAMILY_SLOTS, 0, FAMILY_MAX_NEW, *FAMILY_PROMPTS, seed=1)
    for r in reqs:
        eng.submit(r)
    decode_s, decode_tokens, step = 0.0, 0, {}
    with SamplerCalls() as rec:
        while eng.queue or any(eng.slots):
            if eng.steps == 2:
                step = profile_one(f"{cfg.name} engine decode step ({FAMILY_SLOTS} busy slots)",
                                   eng.step, trace)
                continue
            queued, before = len(eng.queue), sum(len(r.out) for r in reqs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if eng.steps > 1 and len(eng.queue) == queued:  # a pure decode step
                decode_s += time.perf_counter() - t
                decode_tokens += sum(len(r.out) for r in reqs) - before
            check(eng.steps < 4 * FAMILY_MAX_NEW, "engine terminates")
    check(all(r.done and r.error is None and len(r.out) == FAMILY_MAX_NEW for r in reqs),
          f"{cfg.name}: every request served in full")
    check(all(0 <= t_ < cfg.vocab for r in reqs for t_ in r.out), "token range")
    for c in rec.calls if not trace else ():  # the first run checks them
        check_sampler_call(c)
    return dict(prefill_ms=prefill_ms, decode_tokens_per_s=decode_tokens / decode_s,
                step=step, sampler_calls=len(rec.calls))


def family_model_level(device, cfg, model, trace: bool) -> dict:
    """The encoder-decoder and the embed frontend, which the engine does not
    prefill (as in the JAX package): FAMILY_SLOTS rows of ``make_batch``'s
    synthetic inputs (Whisper: 1500 frames and a 32-token prompt; InternVL:
    32 prompt embeddings) through ``prefill``, then 31 ``decode_step`` calls
    (InternVL fed the next synthetic embedding, having no token table),
    each row's token drawn by a TokenSampler and held to the plain inverse
    on the same card CDF rows; the third step profiled, the others timed."""
    from repro_torch.data import make_batch
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import TokenSampler

    B, P = FAMILY_SLOTS, FAMILY_PREFILL
    n = WHISPER_FRAMES if cfg.encoder_layers else P + FAMILY_MAX_NEW
    raw = make_batch(cfg, 0, B, n)
    key = "embeds" if cfg.frontend == "embed" else "tokens"
    batch = {key: torch.as_tensor(raw[key][:, :P], device=device)}
    if cfg.encoder_layers:
        batch["frames"] = torch.as_tensor(raw["frames"], device=device)
    one = {k: v[:1] for k, v in batch.items()}
    prefill_ms = None if trace else cuda_ms(lambda: prefill(model, cfg, one, FAMILY_MAX_SEQ), 3)
    sampler = TokenSampler(mode="inverse_qmc", n_slots=B, device=device)
    slots = np.arange(B)
    decode_s, step = 0.0, {}
    with SamplerCalls() as rec:
        logits, cache, enc_out = prefill(model, cfg, batch, FAMILY_MAX_SEQ)
        tok = sampler.sample(logits, slots)
        out = [tok]
        for i in range(FAMILY_MAX_NEW - 1):
            x = (torch.as_tensor(raw["embeds"][:, P + i:P + i + 1], device=device)
                 if cfg.frontend == "embed" else tok)
            pos = np.full(B, P + i)

            def one_step():
                nonlocal logits, tok
                logits, _ = decode_step(model, cfg, cache, x, pos, enc_out)
                tok = sampler.sample(logits, slots)

            if i == 2:
                step = profile_one(f"{cfg.name} decode step ({B} rows)", one_step, trace)
            else:
                torch.cuda.synchronize()
                t = time.perf_counter()
                one_step()
                torch.cuda.synchronize()
                decode_s += time.perf_counter() - t
            out.append(tok)
    toks = np.stack(out, axis=1)
    check(toks.shape == (B, FAMILY_MAX_NEW) and ((0 <= toks) & (toks < cfg.vocab)).all(),
          f"{cfg.name}: every row's tokens in range")
    for c in rec.calls if not trace else ():  # the first run checks them
        check_sampler_call(c)
    return dict(prefill_ms=prefill_ms,
                decode_tokens_per_s=B * (FAMILY_MAX_NEW - 2) / decode_s,
                step=step, sampler_calls=len(rec.calls))


def family_decode_check(device, cfg, model) -> dict:
    """decode_step after prefill(32) against prefill(33) at its last
    position, in the model's dtype (bf16: within DECODE_REL2_BF16; float32:
    DECODE_REL2_F32, matmuls in full float32); drop-free: ``capacity_factor
    = max(8, E / k)``, so every expert's capacity holds the whole group (a
    token takes an expert once)."""
    import dataclasses

    from repro_torch.data import make_batch
    from repro_torch.models import decode_step, prefill

    S = FAMILY_PREFILL
    cf = max(8.0, cfg.n_experts / cfg.top_k) if cfg.n_experts else cfg.capacity_factor
    c8 = dataclasses.replace(cfg, capacity_factor=cf)
    raw = make_batch(c8, 7, 2, WHISPER_FRAMES if cfg.encoder_layers else S + 1)
    key = "embeds" if cfg.frontend == "embed" else "tokens"
    seq = torch.as_tensor(raw[key][:, :S + 1], device=device)
    extra = {"frames": torch.as_tensor(raw["frames"], device=device)} if cfg.encoder_layers else {}
    want, _, _ = prefill(model, c8, {key: seq, **extra}, 64)
    _, cache, enc_out = prefill(model, c8, {key: seq[:, :S], **extra}, 64)
    nxt = seq[:, S:S + 1] if cfg.frontend == "embed" else seq[:, S]
    got, _ = decode_step(model, c8, cache, nxt, torch.full((2,), S), enc_out)
    diff = got.float() - want.float()
    err, scale = float(diff.abs().max()), float(want.float().abs().max())
    rel2 = float(diff.norm() / want.float().norm())
    bound = DECODE_REL2_F32 if cfg.dtype == "float32" else DECODE_REL2_BF16
    check(math.isfinite(rel2) and rel2 <= bound,
          f"{cfg.name}: {cfg.dtype} decode after prefill, relative L2 {rel2:.3e} within "
          f"{bound}")
    return dict(decode_err=err, decode_rel2=rel2, logit_max=scale, capacity_factor=cf)


def family_decode_check_f32(device, cfg) -> dict:
    """family_decode_check in float32 at published widths on a model of its
    own (seed 1), TF32 off."""
    import dataclasses
    import gc

    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    c32 = dataclasses.replace(cfg, dtype="float32")
    model = init_params(c32, torch.Generator(device=device).manual_seed(1), device)
    out = family_decode_check(device, c32, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {f"f32_{k}": v for k, v in out.items()}


def family_flash(device, cfg, model, arch: str) -> tuple[dict, dict]:
    """``loss_fn`` without gradients on one ``make_batch`` batch with
    ``attn_impl="flash"``: B10 launched once per attention layer (decoder
    and encoder). Returns (its record, the batch)."""
    import dataclasses

    from repro_torch.data import make_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import loss_fn

    B, S = FAMILY_EVAL.get(arch, (1, 2048))
    batch = make_batch(cfg, 0, B, S)
    n_attn = cfg.block_pattern.count("attn") * cfg.n_periods + cfg.encoder_layers
    before = flash_attention.launches
    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, mf = loss_fn(model, dataclasses.replace(cfg, attn_impl="flash"), batch)
        nf = float(mf["nll"])
        flash_s = time.perf_counter() - t
    check(flash_attention.launches - before == n_attn,
          f"{cfg.name}: B10 once per attention layer of the flash forward ({n_attn})")
    return dict(eval_shape=(B, S), nll_flash=nf, eval_flash_s=flash_s,
                b10_per_forward=n_attn), batch


def family_einsum_check(cfg, model, batch: dict, nf: float) -> dict:
    """The same ``loss_fn`` with ``attn_impl="einsum"``: its nll within
    EVAL_NLL_ATOL of the flash forward's ``nf``."""
    from repro_torch.models import loss_fn

    with torch.no_grad():
        ne = float(loss_fn(model, cfg, batch)[1]["nll"])
    check(math.isfinite(nf) and math.isfinite(ne) and abs(nf - ne) <= EVAL_NLL_ATOL,
          f"{cfg.name}: flash and einsum eval nll agree ({nf} vs {ne})")
    return dict(nll_einsum=ne)


def family_run(device, arch: str, run: str, over: dict, cut: str, trace: bool) -> dict:
    """One family: build, serve (engine or model level), the decode check
    and the eval check, with the model's own launch counts of B3, B9 and
    B10, its peak memory and its wall; under ``trace`` the serving run and
    the flash forward, where B3, B9 and B10 launch, inside one
    torch.profiler session (CUDA activity) for their device ms (checked: no
    launch of theirs falls outside). The model is freed before the next
    family."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.cdf_scan import cdf_scan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.sample_tiled import sample_rows
    from repro_torch.models import init_params

    cfg = family_cfg(arch, over)
    print(f"families: {cfg.name} cut: {cut}", flush=True)
    kernels = {"cdf_scan": cdf_scan, "sample_rows": sample_rows,
               "flash_attention": flash_attention}
    before = {k: fn.launches for k, fn in kernels.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    rec = dict(arch=arch, name=cfg.name, run=run, init_s=time.perf_counter() - t,
               params=sum(p.numel() for p in model.parameters()),
               weight_gib=sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30)
    # B3 and B9 launch in the serving run, B10 in the flash forward: under
    # ``trace`` both run inside one profiler session (the flash forward only
    # where it launches B10), the rest outside it
    attn = bool(cfg.block_pattern.count("attn") or cfg.encoder_layers)
    ctx = profile(activities=[ProfilerActivity.CUDA]) if trace else contextlib.nullcontext()
    with ctx as prof:
        rec.update((family_engine if run == "engine" else family_model_level)(
            device, cfg, model, trace))
        if attn:
            flash, batch = family_flash(device, cfg, model, arch)
        torch.cuda.synchronize()
    in_traced = {k: fn.launches - before[k] for k, fn in kernels.items()}
    if not attn:
        flash, batch = family_flash(device, cfg, model, arch)
    rec.update(flash)
    if not trace:  # the checks launch none of B3, B9, B10: the first run makes them
        rec.update(family_decode_check(device, cfg, model))
        if arch in FAMILY_F32_CHECK:
            rec.update(family_decode_check_f32(device, cfg))
        rec.update(family_einsum_check(cfg, model, batch, rec["nll_flash"]))
    del batch
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["launches"] = {k: fn.launches - before[k] for k, fn in kernels.items()}
    if trace:
        check(in_traced == rec["launches"], f"{cfg.name}: every B3/B9/B10 launch traced")
        rec["device_ms"] = kernel_device_ms(device_events(prof))
        del model
        gc.collect()
        torch.cuda.empty_cache()
        return rec
    step = rec["step"]
    print(f"families {cfg.name}: {rec['params']} parameters ({rec['weight_gib']:.2f} GiB, "
          f"seeded init {rec['init_s']:.3f} s; the model's run {rec['wall_s']:.1f} s, host "
          f"clock); prefill of {FAMILY_PREFILL} tokens "
          f"{rec['prefill_ms']:.3f} ms (CUDA events, median of 3); decode "
          f"{rec['decode_tokens_per_s']:.1f} tokens/s ({FAMILY_SLOTS} "
          f"{'slots' if run == 'engine' else 'rows'}, host clock, synchronized); decode step "
          + (f"{step['launches']} launches, idle share {step['idle']:.3f}, device busy "
             f"{step['busy_ms']:.3f} of {step['wall_ms']:.3f} ms" if step else "not measured")
          + f"; peak memory {rec['peak_gib']:.2f} GiB; bf16 decode vs prefill relative L2 "
          f"{rec['decode_rel2']:.3e} (bound {DECODE_REL2_BF16}; max |err| "
          f"{rec['decode_err']:.3e}, max |logit| {rec['logit_max']:.3f}; capacity_factor "
          f"{rec['capacity_factor']}"
          + (f"; float32: {rec['f32_decode_rel2']:.3e}, bound {DECODE_REL2_F32}"
             if "f32_decode_rel2" in rec else "") + "); eval "
          f"{rec['eval_shape']} nll flash {rec['nll_flash']:.6f} einsum {rec['nll_einsum']:.6f}"
          f" (bound {EVAL_NLL_ATOL}), B10 {rec['b10_per_forward']} a forward; launches "
          + ", ".join(f"{k} {v}" for k, v in rec["launches"].items()), flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def families_path(device, trace: bool = False, families=FAMILIES) -> list:
    """Every family of FAMILIES in turn (see family_run)."""
    return [family_run(device, arch, run, over, cut, trace)
            for arch, run, over, cut in families]


def families_traced(device, counts: dict) -> tuple[list, dict]:
    """The families path a second time with every count at 0, printing muted
    and each model inside torch.profiler: its counts must equal the first
    run's. Prints each model's B3/B9/B10 device ms; returns the records and
    the path's summed device ms by kernel."""
    from repro_torch.kernels.cdf_scan import cdf_scan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.sample_tiled import sample_rows

    for fn in (cdf_scan, sample_rows, flash_attention):
        fn.launches = 0
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        recs = families_path(device, trace=True)
    print(f"families path, second run (traced): {time.perf_counter() - t:.1f} s, host clock",
          flush=True)
    total = dict.fromkeys(KERNEL_SYMBOLS, 0.0)
    for r in recs:
        for k, v in r["device_ms"].items():
            total[k] += v
        check(all(r["device_ms"][k] > 0 for k, c in r["launches"].items() if c),
              f"{r['name']}: device time under its kernels' symbols")
        print(f"families {r['name']} kernel device ms (profiler, a second counted run, "
              f"{r['wall_s']:.1f} s): "
              + ", ".join(f"{k} {r['device_ms'][k]:.4f} ({r['launches'][k]} launches)"
                          for k in ("cdf_scan", "sample_rows", "flash_attention")), flush=True)
    got = {k: sum(r["launches"][k] for r in recs) for k in ("cdf_scan", "sample_rows",
                                                             "flash_attention")}
    check(all(got[k] == counts[k] for k in got),
          f"the families path launches the same kernels when run again ({got} vs {counts})")
    return recs, total


# ---------------------------------------------------------------------------
# The families' training path: make_train_step for the six families beyond
# the dense one, float32 masters and bf16 compute, one model at a time.
# ---------------------------------------------------------------------------

FAMILY_TRAIN_S = 256
FAMILY_TRAIN_STEPS = 4      # one warm step, then three timed
# (arch, overrides of the published config, batch rows, remat, the cut as
# printed). Each cut is the least that fits the card: float32 master,
# gradient and two moments take 16 B a parameter, and the peak must stay
# under FAMILY_TRAIN_PEAK_GIB, in the smoke's time. xLSTM's sLSTM steps its
# tokens one at a time, forward and backward. Uncut, at remat full (remat
# none ran out of memory in the first forward), the family took 388.6 s on
# an H100 80GB HBM3 at 700 W: 24.5 s a step, and 188.6 s to profile one
# step's 631,301 launches. That would take the smoke past 1200 s. At 24
# layers and remat none the family took 128.7 s, peak 53.68 GiB (about 2 GiB
# a layer more), which leaves the smoke a fifth of its limit for the card's
# spread.
FAMILY_TRAIN = (
    ("xlstm_1_3b", dict(n_layers=24), 8, "none",
     "depth cut to 24 of 48 layers, published widths: uncut (remat full) the family took "
     "388.6 s, more than the smoke's time allows"),
    ("whisper_small", {}, 8, "none",
     "none: 12 encoder and 12 decoder layers; frames = the sequence, as make_batch draws them"),
    ("internvl2_76b", dict(n_layers=2), 8, "none",
     "depth cut to 2 of 80 layers; published widths, embed frontend (no embed table)"),
    ("kimi_k2_1t_a32b", dict(n_layers=1, n_experts=16), 8, "none",
     "depth cut to 1 of 61 layers; experts cut to 16 of 384 (a width cut); top-8, 1 shared "
     "expert, hd 112 and capacity factor 1.25 kept"),
    ("llama4_maverick_400b_a17b", dict(n_layers=1, n_experts=8), 8, "none",
     "depth cut to 1 of 48 layers; experts cut to 8 of 128 (a width cut); top-1 and the "
     "shared expert kept"),
    ("jamba_1_5_large_398b",
     dict(n_layers=8, d_model=4096, d_ff=12288, head_dim=128, n_experts=2), 4, "none",
     "one period of 8 layers (of 9) at the serve path's cut: d_model 4096 (of 8192), d_ff "
     "12288 (of 24576), hd 128; experts cut to 2 of 16 (a width cut), top-2 kept; batch 4"),
)
FAMILY_TRAIN_PEAK_GIB = 72.0
FAMILY_TRAIN_RESUME = "whisper_small"  # its Trainer is killed and resumed (train_path)
# bf16 against float32 compute (TF32 off), the first step from the same
# float32 masters at 1 layer (1 period for xLSTM and Jamba; Whisper 1 + 1):
# |loss_bf16 - loss_f32| / loss_f32 and the same for the global gradient norm
BF16_LOSS_REL = 1e-2
BF16_GNORM_REL = 5e-2


def train_state_gib(cfg) -> float:
    """Float32 master, gradient and two moments, 16 B a parameter, counted
    on the LM built on ``meta`` (``launch.shapes.params_struct``)."""
    from repro_torch.launch.shapes import params_struct

    return sum(p.numel() for p in params_struct(cfg).parameters()) * 16 / 2**30


def family_repeat_check(cfg, model, batch, remat: str) -> None:
    """The first step's loss and every gradient twice from the same state
    under ``torch.use_deterministic_algorithms(True)``: bitwise equal (the
    first gradients held on the host)."""
    from repro_torch.train.step import loss_and_grads

    torch.use_deterministic_algorithms(True)
    try:
        l0, g = loss_and_grads(model, cfg, batch, remat)
        first = {k: t.cpu() for k, t in g.items()}
        del g
        l1, g = loss_and_grads(model, cfg, batch, remat)
        same = torch.equal(l0, l1) and all(torch.equal(first[k], t.cpu()) for k, t in g.items())
        del g, first
    finally:
        torch.use_deterministic_algorithms(False)
    check(same, f"{cfg.name}: the first step repeated is bitwise equal (loss and every gradient)")


def one_layer(cfg) -> dict:
    """Overrides for the bf16 check's model: one period of the block
    pattern (one layer where the pattern has one block), one encoder
    layer."""
    over = dict(n_layers=len(cfg.block_pattern))
    if cfg.encoder_layers:
        over["encoder_layers"] = 1
    return over


def family_bf16_check(cfg, model, batch, remat: str) -> dict:
    """The first step's loss and global gradient norm in bf16 compute and in
    float32 compute (TF32 off) from the same float32 masters: their
    relative differences within BF16_LOSS_REL and BF16_GNORM_REL."""
    import dataclasses

    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.step import loss_and_grads

    out = {}
    for dt in ("bfloat16", "float32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        loss, g = loss_and_grads(model, dataclasses.replace(cfg, dtype=dt), batch, remat)
        out[dt] = (float(loss), float(global_norm(g.values())))
        del g
    (l16, n16), (l32, n32) = out["bfloat16"], out["float32"]
    rel_l, rel_n = abs(l16 - l32) / abs(l32), abs(n16 - n32) / abs(n32)
    check(math.isfinite(rel_l) and rel_l <= BF16_LOSS_REL and math.isfinite(rel_n)
          and rel_n <= BF16_GNORM_REL,
          f"{cfg.name}: bf16 against float32 compute, loss {l16} vs {l32} (rel {rel_l:.3e}, "
          f"bound {BF16_LOSS_REL}), grad norm {n16} vs {n32} (rel {rel_n:.3e}, bound "
          f"{BF16_GNORM_REL})")
    return dict(bf16_loss=l16, f32_loss=l32, bf16_gnorm=n16, f32_gnorm=n32, loss_rel=rel_l,
                gnorm_rel=rel_n, bf16_layers=cfg.n_layers)


def free_cuda() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def family_train(device, arch: str, over: dict, B: int, remat: str, cut: str) -> dict:
    """One family: the cut and the train state it leaves; the first step
    repeated bitwise under deterministic algorithms (not Whisper, whose
    Trainer is killed and resumed instead, after this path); bf16 against
    float32 compute at one layer; then a MixtureSampler (B3, B2) and
    FAMILY_TRAIN_STEPS make_train_step steps on its batches (B1 a batch),
    the first warm, the rest timed; one more step profiled (CUDA activity
    only: xLSTM's step launches ~250k kernels, too many to trace the host's
    side of in the smoke's time). The model is freed before the next
    family."""
    import repro_torch.configs as C
    from repro_torch.data import MixtureSampler, make_batch
    from repro_torch.kernels.cdf_scan import cdf_scan
    from repro_torch.kernels.forest_delta import forest_delta
    from repro_torch.kernels.forest_sample import forest_pack, forest_sample
    from repro_torch.launch.analytic import step_flops
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, init_opt
    from repro_torch.train.step import make_train_step

    S, steps = FAMILY_TRAIN_S, FAMILY_TRAIN_STEPS
    cfg = family_cfg(arch, over)
    kernels = {"cdf_scan": cdf_scan, "forest_delta": forest_delta,
               "forest_sample": forest_sample, "forest_pack": forest_pack}
    rec = dict(arch=arch, name=cfg.name, B=B, S=S)
    rec.update(state_gib=train_state_gib(cfg), published_state_gib=train_state_gib(C.get(arch)))
    print(f"families_train: {cfg.name} cut: {cut}; train state {rec['state_gib']:.1f} GiB "
          f"(16 B a parameter; the published config {rec['published_state_gib']:.1f} GiB)",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    model = init_params(cfg, gen, device, param_dtype=torch.float32).requires_grad_(True)
    rec["params"] = sum(p.numel() for p in model.parameters())
    first = make_batch(cfg, 0, B, S)
    if arch != FAMILY_TRAIN_RESUME:
        family_repeat_check(cfg, model, first, remat)
    small = one_layer(cfg)
    if all(getattr(cfg, k) == v for k, v in small.items()):
        rec.update(family_bf16_check(cfg, model, first, remat))
    else:
        import dataclasses

        c1 = dataclasses.replace(cfg, **small)
        m1 = init_params(c1, torch.Generator(device=device).manual_seed(0), device,
                         param_dtype=torch.float32).requires_grad_(True)
        rec.update(family_bf16_check(c1, m1, make_batch(c1, 0, B, S), remat))
        del m1
    del first
    free_cuda()

    oc = AdamWConfig(total_steps=100, warmup_steps=1)
    opt = init_opt(oc, model)
    step_fn = make_train_step(cfg, oc, remat=remat)
    before = {k: fn.launches for k, fn in kernels.items()}
    mixture = MixtureSampler(MIXTURE, seed=0, device=device)
    losses, times = [], []
    for step in range(steps):
        batch = make_batch(cfg, step, B, S, mixture=mixture)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, opt, m = step_fn(model, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
    rec["launches"] = {k: fn.launches - before[k] for k, fn in kernels.items()}
    check(all(math.isfinite(x) for x in losses), f"{cfg.name}: finite train losses {losses}")
    check(losses[-1] < losses[0], f"{cfg.name}: the train loss falls: {losses}")
    ms = statistics.median(times[1:])
    flops = step_flops(cfg, "train", S, B, remat)["step_flops"]
    rec.update(losses=losses, ms=ms, step_times_ms=times, tokens_per_s=B * S / ms * 1e3,
               step_flops=flops, flops_share=flops / (ms / 1e3) / BF16_OPS_PER_S)
    rec["step"] = profile_one(f"{cfg.name} train step ({B} x {S})",
                              lambda: step_fn(model, opt, batch), cpu=False)
    torch.cuda.synchronize()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["wall_s"] = time.perf_counter() - t0
    check(rec["peak_gib"] < FAMILY_TRAIN_PEAK_GIB,
          f"{cfg.name}: peak {rec['peak_gib']:.2f} GiB under {FAMILY_TRAIN_PEAK_GIB}")
    step = rec["step"]
    print(f"families_train {cfg.name}: {rec['params']} parameters, batch {B} x {S}, "
          f"float32 masters, bf16 compute, einsum attention, remat {remat}; losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; step {ms:.3f} ms (median of "
          f"{steps - 1} after one warm step, host clock, synchronized; steps "
          f"{', '.join(f'{x:.1f}' for x in times)}), {rec['tokens_per_s']:.1f} tokens/s; "
          f"model FLOPs {flops:.4e} a step (launch.analytic), "
          f"{rec['flops_share']:.4f} of {BF16_OPS_PER_S:.3g} FLOP/s; peak "
          f"{rec['peak_gib']:.2f} GiB (bound {FAMILY_TRAIN_PEAK_GIB}); profiled step "
          + (f"{step['launches']} launches, idle share {step['idle']:.3f}, device busy "
             f"{step['busy_ms']:.3f} of {step['wall_ms']:.3f} ms" if step else "not measured")
          + f"; bf16 vs float32 at {rec['bf16_layers']} layer(s): loss {rec['bf16_loss']:.6f} "
          f"vs {rec['f32_loss']:.6f} (rel {rec['loss_rel']:.3e}, bound {BF16_LOSS_REL}), grad "
          f"norm {rec['bf16_gnorm']:.6f} vs {rec['f32_gnorm']:.6f} (rel {rec['gnorm_rel']:.3e}, "
          f"bound {BF16_GNORM_REL}); "
          + ("first step repeated bitwise under deterministic algorithms; "
             if arch != FAMILY_TRAIN_RESUME else "")
          + "launches " + ", ".join(f"{k} {v}" for k, v in rec["launches"].items())
          + f"; the family's run {rec['wall_s']:.1f} s", flush=True)
    del model, opt, batch, step_fn
    free_cuda()
    return rec


def families_train_path(device, families=FAMILY_TRAIN) -> list:
    """Every family of FAMILY_TRAIN in turn (see family_train)."""
    return [family_train(device, arch, over, B, remat, cut)
            for arch, over, B, remat, cut in families]


def families_train_replay(device, families=FAMILY_TRAIN) -> None:
    """The families_train path's launches of the port's kernels again, for
    their device time: each family's MixtureSampler (B3, B2, B1's pack) and
    its FAMILY_TRAIN_STEPS batches (B1). The models' steps launch none of
    the port's kernels, and rerunning them would cost the smoke minutes."""
    from repro_torch.data import MixtureSampler, make_batch

    for arch, over, B, _, _ in families:
        cfg = family_cfg(arch, over)
        mixture = MixtureSampler(MIXTURE, seed=0, device=device)
        for step in range(FAMILY_TRAIN_STEPS):
            make_batch(cfg, step, B, FAMILY_TRAIN_S, mixture=mixture)


def whisper_resume(device, ckpt_root: Path) -> None:
    """Whisper-small's Trainer at FAMILY_TRAIN's batch: killed at step 2 and
    resumed, bitwise equal under deterministic algorithms (train_path)."""
    arch, over, B, _, _ = next(f for f in FAMILY_TRAIN if f[0] == FAMILY_TRAIN_RESUME)
    train_path(device, family_cfg(arch, over), ckpt_root, B=B, S=FAMILY_TRAIN_S,
               steps=FAMILY_TRAIN_STEPS)
    free_cuda()


# ---------------------------------------------------------------------------
# The dist_lm phase: the LM stack's dist layer (DTensor parameters placed by
# a sharding policy, the hints, the pod all-reduce, sharded restore) on a
# (1, 1) DeviceMesh over the single-rank nccl group of the dist phase.
# ---------------------------------------------------------------------------

DIST_LM_STEPS = 2            # train steps, sharded and unsharded, held bitwise
DIST_LM_ROWS = 16            # decode rows (cache_spec_tree's cache)
DIST_LM_PROMPT = 32          # prompt tokens before the decode steps
DIST_LM_DECODE = 4           # decode steps through make_serve_step


def dist_lm_train(device, cfg, mesh, batches, gen, B, S):
    """The dist_lm path's train steps under ``Policy.recommended(cfg,
    mesh, "train")`` against unsharded, bitwise, timed and profiled; then
    one step's gradients through the compressed pod all-reduce."""
    from repro_torch.dist import compression as Q
    from repro_torch.dist import sharding as TS
    from repro_torch.dist.local import whole
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, init_opt
    from repro_torch.train.step import loss_and_grads, make_train_step

    pol = TS.Policy.recommended(cfg, mesh, "train")
    oc = AdamWConfig(total_steps=100, warmup_steps=5)
    step = make_train_step(cfg, oc, remat="none")

    def master():
        return init_params(cfg, gen(0), device, param_dtype=torch.float32).requires_grad_()

    plain, sh = master(), TS.distribute_params(master(), mesh, pol)
    po, so = init_opt(oc, plain), init_opt(oc, sh)
    times = {"unsharded": [], "sharded": []}
    losses = []
    torch.use_deterministic_algorithms(True)
    try:
        for i in range(DIST_LM_STEPS):
            outs = []
            for name, p, o in (("unsharded", plain, po), ("sharded", sh, so)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, _, m = step(p, o, batches[i])
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e3)
                outs.append(m)
            for k in ("loss", "grad_norm", "lr"):
                check(torch.equal(outs[0][k], outs[1][k]), f"dist_lm step {i} {k} bitwise")
            losses.append(float(outs[0]["loss"]))
        check(all(torch.equal(whole(b), a) for a, b in zip(plain.parameters(), sh.parameters())),
              "dist_lm: every parameter after the steps bitwise")
        check(all(torch.equal(whole(so.m[k]), po.m[k]) and torch.equal(whole(so.v[k]), po.v[k])
                  for k in po.m), "dist_lm: every AdamW moment bitwise")
        for name, p, o in (("unsharded", plain, po), ("sharded", sh, so)):
            for i in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(p, o, batches[DIST_LM_STEPS + i])
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e3)
        prof = {name: profile_one(f"dist_lm train step {name} ({B} x {S})",
                                  lambda p=p, o=o: step(p, o, batches[-1]))
                for name, p, o in (("unsharded", plain, po), ("sharded", sh, so))}
    finally:
        torch.use_deterministic_algorithms(False)
    train_peak = torch.cuda.max_memory_allocated()
    ms = {k: statistics.median(v[DIST_LM_STEPS:]) for k, v in times.items()}
    print(f"dist_lm train: {cfg.name} on a (1, 1) mesh, {pol}, {B} x {S}, float32 masters, "
          f"{cfg.dtype} compute: {DIST_LM_STEPS} steps bitwise equal to unsharded (losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}, every parameter and moment); ms a step "
          f"(median of 3 after them, host clock, synchronized) unsharded {ms['unsharded']:.3f}, "
          f"sharded {ms['sharded']:.3f} (DTensor dispatch {ms['sharded'] - ms['unsharded']:.3f} "
          f"ms, x{ms['sharded'] / ms['unsharded']:.2f}); launches / idle share a step "
          + ", ".join(f"{k} {v.get('launches', 'not measured')} / "
                      f"{v['idle']:.3f}" if v else f"{k} not measured"
                      for k, v in prof.items())
          + f"; peak {train_peak / 2**30:.3f} GiB", flush=True)

    # the step's gradients through the pod all-reduce, compressed
    _, grads = loss_and_grads(sh, cfg, batches[0])
    reduce = Q.make_pod_allreduce(compress=True)
    worst, n = 0.0, 0
    for g in grads.values():
        g = g.to_local()
        q, s = Q.quantize_int8(g)
        check(torch.equal(reduce(g), Q.dequantize_int8(q, s)),
              "compressed all-reduce at world size 1 == dequantize(quantize(g))")
        deq, res = Q.compress_grads_with_feedback(g, None)
        deq2, res2 = Q.compress_grads_with_feedback(g, res)
        worst = max(worst, float((deq + res - g).abs().max()),
                    float((deq2 + res2 - (g + res)).abs().max()))
        n += g.numel()
    check(worst <= 1e-9, f"error feedback conserves the gradient ({worst})")
    print(f"dist_lm compression: {len(grads)} gradients, {n} values: the shared-scale int8 "
          f"all-reduce == dequantize(quantize(g)) bitwise; error feedback conserved to "
          f"{worst:.3e} (bound 1e-9)", flush=True)
    del plain, sh, po, so, grads
    free_cuda()


def dist_lm_path(device, cfg, mesh, B=TRAIN_B, S=TRAIN_S, replay=False) -> dict:
    """Qwen1.5-0.5B at full width under three policies of the (1, 1) mesh,
    each against the unsharded model on the same inputs, bit for bit (at
    world size 1 every spec sanitizes to Replicate, so the local ops are
    the unsharded ops): ``DIST_LM_STEPS`` train steps under
    ``Policy.recommended(cfg, mesh, "train")`` on the MixtureSampler's
    batches (float32 masters, bf16 compute, deterministic algorithms); the
    flash eval forward (B10 through the local-heads wrapper) under
    ``Policy.for_mesh`` with ``Hints(gather_weights=True, seq_shard=True)``;
    ``DIST_LM_DECODE`` decode steps through ``make_serve_step`` (B3, B9) on
    a ``cache_spec_tree``-placed cache under the decode preset; the
    compressed pod all-reduce of one step's gradients. Prints ms a step,
    launches and idle share sharded beside unsharded, and the peak.
    ``replay`` (the profiled rerun) leaves out the train steps and the
    all-reduce, which launch none of the port's kernels."""
    import dataclasses

    from repro_torch.data import MixtureSampler, make_batch
    from repro_torch.dist import hints as H
    from repro_torch.dist import sharding as TS
    from repro_torch.dist.local import whole
    from repro_torch.models import forward, init_params, prefill
    from repro_torch.train.step import make_serve_step

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the mixture built twice: late in the process a profiler window drops its
    # first forest build's records (PERF.md section 7); the second is whole
    MixtureSampler(MIXTURE, seed=0, device=device)
    mixture = MixtureSampler(MIXTURE, seed=0, device=device)
    batches = [make_batch(cfg, s, B, S, mixture=mixture) for s in range(DIST_LM_STEPS + 4)]
    if not replay:
        dist_lm_train(device, cfg, mesh, batches, gen, B, S)

    # the hinted flash eval forward, for_mesh + gather/seq hints
    flash = dataclasses.replace(cfg, attn_impl="flash")
    ev = init_params(cfg, gen(0), device)
    pol_f = TS.Policy.for_mesh(mesh)
    ed = TS.distribute_params(init_params(cfg, gen(0), device), mesh, pol_f)
    batch = make_batch(cfg, 0, EVAL_B, EVAL_S, mixture=mixture)
    hints = H.Hints(pol_f, gather_weights=True, seq_shard=True)
    eval_ms = {}
    with torch.no_grad():
        for name, model, ctx in (("unsharded", ev, contextlib.nullcontext()),
                                 ("hinted", ed, H.sharding_hints(hints))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with ctx:
                out = forward(model, flash, batch)[0]
            torch.cuda.synchronize()
            eval_ms[name] = ((time.perf_counter() - t) * 1e3, out)
    check(torch.equal(whole(eval_ms["hinted"][1]), eval_ms["unsharded"][1]),
          "dist_lm: hinted flash eval forward bitwise")
    print(f"dist_lm eval: flash forward {EVAL_B} x {EVAL_S} under {pol_f} with {hints}: logits "
          f"bitwise equal to unsharded; ms (host clock, synchronized, one call) unsharded "
          f"{eval_ms['unsharded'][0]:.3f}, hinted {eval_ms['hinted'][0]:.3f}", flush=True)
    del ed, eval_ms, batch

    # decode steps on a cache placed by cache_spec_tree, decode preset
    pol_d = TS.Policy.recommended(cfg, mesh, "decode")
    dd = TS.distribute_params(init_params(cfg, gen(0), device), mesh, pol_d)
    tok = torch.randint(0, cfg.vocab, (DIST_LM_ROWS, DIST_LM_PROMPT), generator=gen(3),
                        device=device)
    logits, cache, _ = prefill(ev, cfg, {"tokens": tok}, max_seq=DIST_LM_PROMPT + 16)
    dcache = TS.distribute_cache(cfg, {b: {k: t.clone() for k, t in c.items()}
                                       for b, c in cache.items()}, mesh, pol_d)
    serve = make_serve_step(cfg)
    nxt, pos = logits.argmax(-1), torch.full((DIST_LM_ROWS,), DIST_LM_PROMPT, device=device)
    xgen, dec_ms = gen(4), {"unsharded": 0.0, "sharded": 0.0}
    for _ in range(DIST_LM_DECODE):
        xi = torch.rand(DIST_LM_ROWS, generator=xgen, device=device)
        got = {}
        for name, p, c in (("unsharded", ev, cache), ("sharded", dd, dcache)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got[name], _ = serve(p, c, nxt, pos, xi)
            torch.cuda.synchronize()
            dec_ms[name] += (time.perf_counter() - t) * 1e3 / DIST_LM_DECODE
        check(torch.equal(got["sharded"], got["unsharded"]), "dist_lm: decode tokens equal")
        nxt, pos = got["unsharded"], pos + 1
    check(all(torch.equal(whole(dcache[b][k]), t) for b, c in cache.items() for k, t in c.items()),
          "dist_lm: the placed cache bitwise equal after the decode steps")
    peak = torch.cuda.max_memory_allocated()
    print(f"dist_lm decode: {DIST_LM_DECODE} make_serve_step steps over {DIST_LM_ROWS} rows "
          f"(prompt {DIST_LM_PROMPT}) under {pol_d}, cache placed by cache_spec_tree: tokens and "
          f"cache bitwise equal to unsharded; ms a step (host clock) unsharded "
          f"{dec_ms['unsharded']:.3f}, sharded {dec_ms['sharded']:.3f}; path peak "
          f"{peak / 2**30:.3f} GiB", flush=True)
    del ev, dd, cache, dcache
    free_cuda()


def dist_lm_checks(device, cfg, mesh, ckpt_root: Path, B=TRAIN_B, S=TRAIN_S) -> None:
    """Outside the counted path: the trainer's checkpoint, saved unsharded
    at step 2, restored into a sharded Trainer (``restore(shardings=)``)
    bitwise and resumed one step bitwise; and B10 on local query heads at
    a nonzero head offset against its plain version on the same heads."""
    import dataclasses
    import shutil

    from repro_torch.data import make_batch
    from repro_torch.dist import sharding as TS
    from repro_torch.dist.local import _kv_heads, whole
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import ref_flash_attention
    from repro_torch.train import TrainConfig, Trainer

    shutil.rmtree(ckpt_root, ignore_errors=True)
    tc = TrainConfig(steps=2, global_batch=B, seq_len=S, ckpt_dir=str(ckpt_root), ckpt_every=2,
                     keep=1, log_every=1)
    pol = TS.Policy.recommended(cfg, mesh, "train")
    torch.use_deterministic_algorithms(True)
    try:
        a = Trainer(cfg, tc, log_fn=lambda s: None, device=device).run()
        tr = Trainer(cfg, dataclasses.replace(tc, steps=3), log_fn=lambda s: None, device=device,
                     mesh=mesh, policy=pol)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt = tr.init_state()
        opt = tr._restore(params, opt)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        check(int(opt.step) == 2, "dist_lm: restored at step 2")
        check(all(torch.equal(whole(q), p) for p, q in zip(a["params"].parameters(),
                                                           params.parameters())),
              "dist_lm: restored sharded parameters bitwise")
        check(all(torch.equal(whole(opt.m[k]), a["opt"].m[k])
                  and torch.equal(whole(opt.v[k]), a["opt"].v[k]) for k in opt.m),
              "dist_lm: restored sharded moments bitwise")
        batch = make_batch(cfg, 2, B, S, mixture=tr.mixture)
        _, _, m1 = tr.step_fn(a["params"], a["opt"], batch)
        _, _, m2 = tr.step_fn(params, opt, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    check(torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["grad_norm"], m2["grad_norm"]),
          "dist_lm: resumed sharded step bitwise")
    check(all(torch.equal(whole(q), p) for p, q in zip(a["params"].parameters(),
                                                       params.parameters())),
          "dist_lm: resumed sharded parameters bitwise")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    print(f"dist_lm restore: the Trainer's checkpoint saved unsharded at step 2, restored "
          f"into a sharded Trainer under {pol} (restore(shardings=), {restore_s:.3f} s with "
          f"init) bitwise, and its step 3 bitwise (loss {float(m2['loss']):.6f})", flush=True)
    del a, tr, params, opt
    free_cuda()

    # B10 on a rank's local query heads at a nonzero head offset
    g = torch.Generator(device=device).manual_seed(5)
    for H_, KV, h0, Hl in ((16, 4, 6, 4), (16, 4, 8, 8), (16, 16, 4, 4)):
        q = torch.randn(1, 512, H_, 64, generator=g, device=device).to(torch.bfloat16)
        k = torch.randn(1, 512, KV, 64, generator=g, device=device).to(torch.bfloat16)
        v = torch.randn(1, 512, KV, 64, generator=g, device=device).to(torch.bfloat16)
        kl, vl = _kv_heads(k, h0, Hl, H_ // KV), _kv_heads(v, h0, Hl, H_ // KV)
        got = flash_attention(q[:, :, h0:h0 + Hl], kl, vl, causal=True)
        want = ref_flash_attention(q, k, v, causal=True)[:, :, h0:h0 + Hl]
        err = float((got.float() - want.float()).abs().max())
        check(err <= FLASH_TOL[torch.bfloat16],
              f"B10 on local heads {h0}..{h0 + Hl} of {H_} over {KV} KV heads: {err}")
        print(f"dist_lm B10 local heads: heads {h0}..{h0 + Hl - 1} of {H_} over {KV} KV heads "
              f"(KV {'sliced' if kl.shape[2] * (H_ // KV) == Hl else 'picked a head'}), "
              f"max |err| {err:.3e} against the plain version on the same heads "
              f"(tol {FLASH_TOL[torch.bfloat16]})", flush=True)


# ---------------------------------------------------------------------------
# The dist_families phase: every non-dense family distributed on the (1, 1)
# mesh over the single-rank nccl group (the MoE, Mamba and xLSTM local forms,
# the encoder and the embedding frontend, the decode cache write), each run
# against its unsharded twin, bit for bit.
# ---------------------------------------------------------------------------

DIST_FAMILY_ROWS = 16        # decode rows
DIST_FAMILY_PROMPT = 32      # prompt tokens (embeddings) before the decode steps
DIST_FAMILY_DECODE = 4       # timed make_serve_step steps, then one profiled
DIST_FAMILY_TRAIN = ("kimi_k2_1t_a32b", "jamba_1_5_large_398b")  # FAMILY_TRAIN's cuts
DIST_FAMILY_KERNELS = ("cdf_scan", "forest_delta", "forest_sample", "forest_pack",
                       "sample_rows", "flash_attention")


def undistribute(model) -> None:
    """A model distributed on a mesh of one device back to plain parameters
    (each DTensor's local tensor is the whole parameter there)."""
    for name, p in list(model.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, attr, torch.nn.Parameter(p.to_local(), requires_grad=p.requires_grad))
    del model.dist_state


def _add_window(acc: dict, w: dict, launched: dict) -> None:
    """Sum a traced window's kernel device ms and records into ``acc``,
    and check that every kernel it launched has device time there."""
    check(bool(w), "dist_families: the profiler measured device time in its window")
    for k, n in launched.items():
        check(n == 0 or w["kernel_ms"][k] > 0, f"{k}: device time in its dist_families window")
        acc["ms"][k] += w["kernel_ms"][k]
        acc["records"][k] += w["records"][k]


def dist_family_serve(device, mesh, arch: str, over: dict, cut: str, acc: dict) -> dict:
    """One family of FAMILIES at its cut, bf16: prefill of DIST_FAMILY_ROWS
    rows, DIST_FAMILY_DECODE timed ``make_serve_step`` steps (B3, B9) and
    one profiled, and, where the model attends, the flash eval forward
    (B10); first unsharded, then the same model distributed in place
    (never two copies resident) under ``Policy.recommended(cfg, mesh,
    "decode")`` on a ``cache_spec_tree``-placed cache, then under JAX's 2-D
    preset with ``shard_seq``: logits, tokens, caches and nll bitwise."""
    import dataclasses
    import gc

    from repro_torch.data import make_batch
    from repro_torch.dist import sharding as TS
    from repro_torch.dist.local import whole
    from repro_torch.kernels.cdf_scan import cdf_scan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.sample_tiled import sample_rows
    from repro_torch.models import init_params, loss_fn, prefill
    from repro_torch.train.step import make_serve_step

    cfg = family_cfg(arch, over)
    print(f"dist_families: {cfg.name} cut: {cut}", flush=True)
    B, P, n = DIST_FAMILY_ROWS, DIST_FAMILY_PROMPT, DIST_FAMILY_DECODE
    embed = cfg.frontend == "embed"
    raw = make_batch(cfg, 0, B, WHISPER_FRAMES if cfg.encoder_layers else P + n + 1)
    key = "embeds" if embed else "tokens"
    batch = {key: torch.as_tensor(raw[key][:, :P], device=device)}
    if cfg.encoder_layers:
        batch["frames"] = torch.as_tensor(raw["frames"], device=device)
    attn = bool(cfg.block_pattern.count("attn") or cfg.encoder_layers)
    ev = make_batch(cfg, 1, *FAMILY_EVAL.get(arch, (1, 2048))) if attn else None
    flash = dataclasses.replace(cfg, attn_impl="flash")
    serve = make_serve_step(cfg)
    kernels = {"cdf_scan": cdf_scan, "sample_rows": sample_rows,
               "flash_attention": flash_attention}

    def run(model, pol):
        """One run; ``pol`` None: unsharded."""
        logits, cache, enc = prefill(model, cfg, batch, P + n + 2)
        out = dict(prefill=whole(logits), toks=[], times=[])
        g = torch.Generator(device=device).manual_seed(4)
        nxt, pos = out["prefill"].argmax(-1), torch.full((B,), P, device=device)
        for i in range(n + 1):
            xi = torch.rand(B, generator=g, device=device)
            x = (torch.as_tensor(raw["embeds"][:, P + i:P + i + 1], device=device)
                 if embed else nxt)

            def one(x=x, pos=pos, xi=xi):
                return serve(model, cache, x, pos, xi, enc)[0]

            if i < n:
                torch.cuda.synchronize()
                t = time.perf_counter()
                tok = one()
                torch.cuda.synchronize()
                out["times"].append((time.perf_counter() - t) * 1e3)
            else:
                before = {k: fn.launches for k, fn in kernels.items()}
                tok, out["step"] = traced(one)
                _add_window(acc, out["step"], {k: fn.launches - before[k]
                                               for k, fn in kernels.items()})
            out["toks"].append(tok)
            nxt, pos = tok, pos + 1
        out["cache"] = {b: {k: whole(t) for k, t in c.items()} for b, c in cache.items()}
        if attn:
            before = flash_attention.launches
            with torch.no_grad():
                m, w = traced(lambda: loss_fn(model, flash, ev)[1])
            _add_window(acc, w, {"flash_attention": flash_attention.launches - before})
            out["nll"], out["flash"] = whole(m["nll"]), w
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    runs = {"unsharded": run(model, None)}
    pols = {"decode": TS.Policy.recommended(cfg, mesh, "decode"),
            "2d": TS.Policy(dp=(), tp=tuple(mesh.mesh_dim_names), fsdp=(), shard_seq=True,
                            sp="model")}
    for name, pol in pols.items():
        TS.distribute_params(model, mesh, pol)
        runs[name] = run(model, pol)
        undistribute(model)
        want, got = runs["unsharded"], runs[name]
        check(torch.equal(got["prefill"], want["prefill"]),
              f"dist_families {cfg.name} {name}: prefill logits bitwise")
        check(all(torch.equal(a, b) for a, b in zip(got["toks"], want["toks"])),
              f"dist_families {cfg.name} {name}: decode tokens bitwise")
        check(all(torch.equal(got["cache"][b][k], t) for b, c in want["cache"].items()
                  for k, t in c.items()), f"dist_families {cfg.name} {name}: cache bitwise")
        if attn:
            check(torch.equal(got["nll"], want["nll"]),
                  f"dist_families {cfg.name} {name}: flash eval nll bitwise")
        del got["cache"]
    del model, runs["unsharded"]["cache"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    rec = dict(name=cfg.name, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               wall_s=time.perf_counter() - t0,
               ms={k: statistics.median(r["times"]) for k, r in runs.items()},
               step={k: r["step"] for k, r in runs.items()},
               flash_ms={k: r["flash"]["wall_ms"] for k, r in runs.items() if attn})
    check(rec["peak_gib"] < FAMILY_TRAIN_PEAK_GIB,
          f"dist_families {cfg.name}: peak {rec['peak_gib']:.2f} GiB")
    print(f"dist_families {cfg.name}: prefill, {n + 1} make_serve_step steps over {B} rows and "
          + ("the flash eval forward " if attn else "")
          + "bitwise equal unsharded, under recommended(decode) and the 2-D shard_seq preset "
          f"({pols['2d']}); decode step ms (median of {n}, host clock, synchronized) "
          + ", ".join(f"{k} {v:.3f}" for k, v in rec["ms"].items())
          + "; profiled step launches / idle share "
          + ", ".join(f"{k} {v['launches']} / {v['idle']:.3f}" for k, v in rec["step"].items())
          + ("; flash forward ms (profiled) " + ", ".join(
              f"{k} {v:.3f}" for k, v in rec["flash_ms"].items()) if attn else "")
          + f"; peak {rec['peak_gib']:.2f} GiB; {rec['wall_s']:.1f} s", flush=True)
    return rec


def dist_family_train(device, mesh, arch: str, over: dict, B: int, remat: str, cut: str,
                      acc: dict) -> dict:
    """One train step of a FAMILY_TRAIN cut on the MixtureSampler's batch
    (B3, B2, B1's pack and B1, in a traced window), float32 masters, bf16
    compute, under deterministic algorithms: unsharded, then a fresh model
    from the same seed under ``Policy.recommended(cfg, mesh, "train")``
    (never two resident): loss, gradient norm and every parameter after
    the step bitwise (the unsharded parameters held on the host); a second
    step of each profiled."""
    import gc

    from repro_torch.data import MixtureSampler, make_batch
    from repro_torch.dist import sharding as TS
    from repro_torch.dist.local import whole
    from repro_torch.kernels.cdf_scan import cdf_scan
    from repro_torch.kernels.forest_delta import forest_delta
    from repro_torch.kernels.forest_sample import forest_pack, forest_sample
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, init_opt
    from repro_torch.train.step import make_train_step

    cfg = family_cfg(arch, over)
    S = FAMILY_TRAIN_S
    print(f"dist_families train: {cfg.name} cut: {cut}", flush=True)
    kernels = {"cdf_scan": cdf_scan, "forest_delta": forest_delta,
               "forest_sample": forest_sample, "forest_pack": forest_pack}
    before = {k: fn.launches for k, fn in kernels.items()}

    def batches():
        # the mixture built twice: late in the process a profiler window drops
        # its first forest build's records (PERF.md section 7); the second is whole
        MixtureSampler(MIXTURE, seed=0, device=device)
        mixture = MixtureSampler(MIXTURE, seed=0, device=device)
        return [make_batch(cfg, s, B, S, mixture=mixture) for s in range(2)]

    bs, w = traced(batches)
    _add_window(acc, w, {k: fn.launches - before[k] for k, fn in kernels.items()})
    oc = AdamWConfig(total_steps=100, warmup_steps=1)
    pol = TS.Policy.recommended(cfg, mesh, "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, host = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for name in ("unsharded", "sharded"):
            model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device,
                                param_dtype=torch.float32).requires_grad_()
            if name == "sharded":
                TS.distribute_params(model, mesh, pol)
            opt = init_opt(oc, model)
            step = make_train_step(cfg, oc, remat=remat)
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step(model, opt, bs[0])[2]   # bind no name to the state: it is freed
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            params = {k: whole(p).detach().to("cpu", copy=True)
                      for k, p in model.named_parameters()}
            if name == "unsharded":
                host = params
            else:
                check(all(torch.equal(params[k], host[k]) for k in host),
                      f"dist_families {cfg.name}: every parameter after the step bitwise")
            del params
            prof = profile_one(f"dist_families {cfg.name} train step {name} ({B} x {S})",
                               lambda: step(model, opt, bs[1]), cpu=False)
            out[name] = dict(ms=ms, loss=m["loss"], grad_norm=m["grad_norm"], step=prof)
            del model, opt, step
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    for k in ("loss", "grad_norm"):
        check(torch.equal(out["unsharded"][k], out["sharded"][k]),
              f"dist_families {cfg.name}: train step {k} bitwise")
    del host
    torch.cuda.synchronize()
    rec = dict(name=cfg.name, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               wall_s=time.perf_counter() - t0, ms={k: v["ms"] for k, v in out.items()},
               step={k: v["step"] for k, v in out.items()})
    check(rec["peak_gib"] < FAMILY_TRAIN_PEAK_GIB,
          f"dist_families {cfg.name} train: peak {rec['peak_gib']:.2f} GiB")
    print(f"dist_families train {cfg.name}: one step {B} x {S} under {pol}, float32 masters, "
          f"bf16 compute, remat {remat}: loss {float(out['sharded']['loss']):.6f}, grad norm "
          f"and every parameter bitwise equal unsharded; step ms (the first, host clock, "
          f"synchronized) " + ", ".join(f"{k} {v:.3f}" for k, v in rec["ms"].items())
          + "; the second step profiled, launches / idle share "
          + ", ".join(f"{k} {v['launches']} / {v['idle']:.3f}" if v else f"{k} not measured"
                      for k, v in rec["step"].items())
          + f"; peak {rec['peak_gib']:.2f} GiB; {rec['wall_s']:.1f} s", flush=True)
    return rec


def dist_families_path(device, mesh, families=FAMILIES, train=DIST_FAMILY_TRAIN) -> dict:
    """Every family of FAMILIES served sharded beside unsharded
    (``dist_family_serve``), then one sharded train step of the
    FAMILY_TRAIN cuts named in ``train`` (``dist_family_train``). The
    kernel-launching calls run in profiler windows; returns their summed
    device ms and records by kernel."""
    acc = {"ms": dict.fromkeys(KERNEL_SYMBOLS, 0.0), "records": dict.fromkeys(KERNEL_SYMBOLS, 0)}
    for arch, _, over, cut in families:
        dist_family_serve(device, mesh, arch, over, cut, acc)
    for arch, over, B, remat, cut in FAMILY_TRAIN:
        if arch in train:
            dist_family_train(device, mesh, arch, over, B, remat, cut, acc)
    print("dist_families kernel device ms in its profiler windows (device records): "
          + ", ".join(f"{k} {acc['ms'][k]:.4f} ({acc['records'][k]})"
                      for k in DIST_FAMILY_KERNELS if acc["ms"][k] > 0), flush=True)
    return acc


# ---------------------------------------------------------------------------
# The dryrun path: the port's dry-run tools (launch.dryrun on meta tensors
# under the fake process-group backend, no card) on two production cells,
# and their prediction of the dist_lm train cell against a real step on the
# (1, 1) nccl mesh of the dist phase.
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("qwen1.5-0.5b", "train_4k"), ("kimi-k2-1t-a32b", "decode_32k"))
DRYRUN_TIMEOUT = 120        # seconds a dry-run subprocess may take
DRYRUN_STEPS = 3            # timed sharded steps of the dist_lm cell, after one
# The dist_lm train cell's prediction: the dry run's parts composed on a
# fake world of one rank, as the JAX suite's test_mini_dryrun_in_process
# composes JAX's; prints one JSON line.
DRYRUN_PREDICT = """
import json, sys
import repro_torch.configs as C
from repro_torch.dist import sharding as TS
from repro_torch.launch import analytic as A, dryrun as D, roofline as R
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import ShapeSpec
arch, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = C.get(arch)
with D.fake_world(1):
    mesh = make_production_mesh(mesh_shape=(1, 1))
    pol = TS.Policy.recommended(cfg, mesh, "train")
    p = D.predict(cfg, ShapeSpec("dist_lm", S, B, "train"), mesh, pol, remat="none")
    af = A.step_flops(cfg, "train", S, B, "none")
    ab = A.step_bytes(cfg, "train", S, B, opt_bytes_per_param=12)
    roof = R.analyze(p["records"], p["traced_flops"], mesh, 1, p["trip_hints"],
                     af["step_flops"], ab["step_bytes"])
useful = R.model_flops(cfg, B * S)["model_flops_6ND"]
bound = max(roof.t_compute, roof.t_mem, roof.t_coll, roof.t_coll_wire)
print(json.dumps({"policy": str(pol), "roofline": roof.to_dict(), "useful_flops": useful,
                  "roofline_fraction": useful / (R.PEAK_FLOPS * bound),
                  **{k: p[k] for k in ("lower_s", "compile_s", "argument_size_in_bytes",
                                       "argument_bytes_by_input", "temp_size_in_bytes")}}))
"""


def dryrun_spawn(args: list, out_dir: Path) -> subprocess.Popen:
    """A dry-run subprocess: no card visible (the fake backend and ``meta``
    tensors need none), the checkout's ``src`` on the path."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": str(root / "src")}
    out_dir.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([sys.executable] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env, cwd=root)


def dryrun_wait(proc: subprocess.Popen, what: str) -> str:
    """The subprocess's output once it ends with code 0 within
    DRYRUN_TIMEOUT (killed otherwise)."""
    try:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"chip_smoke: {what} took over {DRYRUN_TIMEOUT} s")
    check(proc.returncode == 0, f"{what} exits 0 ({out[-2000:]})")
    return out


def dryrun_path(device, arch, mesh) -> dict:
    """The dryrun path (docstring item 9f) on ``arch``'s dist_lm cell.
    Returns the prediction and the measured step."""
    import repro_torch.configs as C
    from types import SimpleNamespace

    from repro_torch.dist import sharding as TS
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, init_opt
    from repro_torch.train.step import make_train_step

    t0 = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_dryrun"
    cells = [(arch, shape, out_dir / f"{arch}__{shape}.json",
              dryrun_spawn(["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                            "--auto-policy", "--out", str(out_dir / f"{arch}__{shape}.json")],
                           out_dir)) for arch, shape in DRYRUN_CELLS]
    B, S = TRAIN_B, TRAIN_S
    pred_proc = dryrun_spawn(["-c", DRYRUN_PREDICT, arch, str(B), str(S)], out_dir)
    cfg = C.get(arch)

    # the real step of the cell on the card, while the dry runs trace
    pol = TS.Policy.recommended(cfg, mesh, "train")
    model = TS.distribute_params(
        init_params(cfg, torch.Generator(device=device).manual_seed(0), device,
                    param_dtype=torch.float32).requires_grad_(), mesh, pol)
    oc = AdamWConfig(total_steps=100, warmup_steps=5)
    opt = init_opt(oc, model)
    g = torch.Generator(device=device).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=g, device=device,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    real = D.input_bytes(SimpleNamespace(groups={"params": model, "opt": opt, "batch": batch}))
    step = make_train_step(cfg, oc, remat="none")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(DRYRUN_STEPS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(model, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    grown = torch.cuda.max_memory_allocated() - base
    ms = statistics.median(times[1:])
    del model, opt, batch
    free_cuda()

    for arch, shape, path, proc in cells:
        dryrun_wait(proc, f"dry run of {arch} {shape}")
        rec = json.loads(path.read_text())
        check(rec["status"] == "ok", f"dry run of {arch} {shape}: status ok")
        rf = rec["roofline"]
        check(all(math.isfinite(rf[k]) and rf[k] > 0 for k in ("t_compute_s", "t_mem_s",
                                                                "t_coll_s")),
              f"dry run of {arch} {shape}: finite, positive roofline terms")
        print(f"dryrun {arch} {shape} pod1 ({rec['chips']} GPUs, {rec['mesh']}, auto policy "
              f"{rec['policy']}): status {rec['status']}, lower_s {rec['lower_s']:.3f}, "
              f"compile_s {rec['compile_s']:.3f}; a rank: arguments "
              f"{rec['argument_size_in_bytes']} B {rec['argument_bytes_by_input']}, temp "
              f"{rec['temp_size_in_bytes']} B; t_compute {rf['t_compute_s']:.6g} s, t_mem "
              f"{rf['t_mem_s']:.6g} s, t_coll {rf['t_coll_s']:.6g} s (wire "
              f"{rf['t_coll_wire_s']:.6g} s), dominant {rf['dominant']} (H100 SXM datasheet "
              f"constants)", flush=True)

    pred = json.loads(dryrun_wait(pred_proc, "dist_lm cell prediction").strip().splitlines()[-1])
    rf = pred["roofline"]
    check(pred["argument_bytes_by_input"] == real,
          f"dryrun: predicted argument bytes a rank {pred['argument_bytes_by_input']} == the "
          f"card state's {real}")
    floor_ms = max(rf["t_compute_s"], rf["t_mem_s"]) * 1e3
    check(ms >= floor_ms, f"dryrun: measured step {ms:.3f} ms >= max(t_compute, t_mem) "
          f"{floor_ms:.3f} ms")
    args_b = pred["argument_size_in_bytes"]
    print(f"dryrun dist_lm cell ({cfg.name}, {B} x {S}, remat none, {pred['policy']}, (1, 1) "
          f"mesh): predicted argument bytes a rank {args_b} == the card state's "
          f"{sum(real.values())} ({real}); measured step {ms:.3f} ms (median of "
          f"{DRYRUN_STEPS} after one, host clock, synchronized) >= max(t_compute "
          f"{rf['t_compute_s'] * 1e3:.3f}, t_mem {rf['t_mem_s'] * 1e3:.3f}) ms, t_coll "
          f"{rf['t_coll_s'] * 1e3:.3f} ms; predicted peak (arguments + temp) "
          f"{(args_b + pred['temp_size_in_bytes']) / 2**30:.3f} GiB beside the measured "
          f"{(sum(real.values()) + grown) / 2**30:.3f} GiB (state + the step's "
          f"max_memory_allocated growth {grown / 2**30:.3f} GiB); roofline_fraction "
          f"{pred['roofline_fraction']:.4f} predicted, the measured step's "
          f"{pred['useful_flops'] / (R.PEAK_FLOPS * ms / 1e3):.4f}; prediction traced in "
          f"{pred['lower_s'] + pred['compile_s']:.3f} s; path "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return {"ms": ms, "prediction": pred, "real_bytes": real, "grown": grown}


# ---------------------------------------------------------------------------
# The examples path: each walkthrough of examples/torch_*.py on the card, in
# a process of its own under torch.profiler (CUDA activity), its kernels'
# launches and device ms read in that process.
# ---------------------------------------------------------------------------

EXAMPLE_TRAIN_STEPS = 40    # torch_train_lm.py's 113M model: 40 of its default 300 steps
EXAMPLES = (
    ("torch_quickstart.py", ()),
    ("torch_density_map_sampling.py", ("--out", "density_map")),
    ("torch_pool_serving.py", ()),
    ("torch_sharded_forest.py", ()),
    ("torch_failover_demo.py", ()),
    ("torch_serve_batched.py", ()),
    ("torch_train_lm.py", ("--steps", str(EXAMPLE_TRAIN_STEPS))),
)
EXAMPLE_TIMEOUT = 240       # seconds an example's process may take
# Makes JAX and the JAX package unimportable, then takes argv as an
# example's path and its arguments: ``run_example()`` runs it as
# ``__main__``. The CPU tests run ``NO_JAX_RUNNER + "run_example()"``.
NO_JAX_RUNNER = """
import runpy, sys
class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name}: the torch examples import no JAX")
sys.meta_path.insert(0, NoJax())
sys.argv = sys.argv[1:]
def run_example():
    runpy.run_path(sys.argv[0], run_name="__main__")
"""
# Runs the example on the card under torch.profiler, then prints one line
# of its kernels' launches, device ms and device records.
EXAMPLE_RUNNER = NO_JAX_RUNNER + """
import json
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as S
wrappers = S.kernel_wrappers()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    run_example()
    torch.cuda.synchronize()
events = S.device_events(prof)
print("EXAMPLE_KERNELS " + json.dumps({
    "launches": {k: fn.launches for k, fn in wrappers.items()},
    "device_ms": S.kernel_device_ms(events), "records": S.kernel_records(events)}))
"""


def examples_path(root: Path) -> dict:
    """Each of ``EXAMPLES`` (file under ``examples/``, arguments) on the
    card in its own process, one after another, from a scratch directory
    under ``build/`` (removed after): a line each with its exit code, wall
    seconds and last lines. Fails if any exits non-zero. Returns the
    examples' summed ``launches``, ``device_ms`` and ``records`` by kernel
    and the phase's ``wall_s``."""
    import shutil

    work = root / "build" / "chip_smoke_examples"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(root / "src"), str(root)])}
    total = {"launches": dict.fromkeys(KERNEL_SYMBOLS, 0),
             "device_ms": dict.fromkeys(KERNEL_SYMBOLS, 0.0),
             "records": dict.fromkeys(KERNEL_SYMBOLS, 0)}
    failed = []
    t0 = time.perf_counter()
    for name, args in EXAMPLES:
        t = time.perf_counter()
        try:
            p = subprocess.run([sys.executable, "-c", EXAMPLE_RUNNER,
                                str(root / "examples" / name), *args],
                               cwd=work, env=env, capture_output=True, text=True,
                               timeout=EXAMPLE_TIMEOUT)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = (f"killed after {EXAMPLE_TIMEOUT} s",
                            *(b.decode(errors="replace") if isinstance(b, bytes) else b or ""
                              for b in (e.stdout, e.stderr)))
        wall = time.perf_counter() - t
        lines = out.strip().splitlines()
        rec = [ln for ln in lines if ln.startswith("EXAMPLE_KERNELS ")]
        said = [ln for ln in lines if not ln.startswith("EXAMPLE_KERNELS ")]
        print(f"example {' '.join((name,) + tuple(args))}: exit {rc}, {wall:.3f} s wall "
              "(its own process: start, library load and the profiler included); "
              f"last lines: {' | '.join(said[-3:])}", flush=True)
        if rc != 0 or not rec:
            failed.append(name)
            print(out[-2000:] + err[-4000:], flush=True)
            continue
        got = json.loads(rec[-1].split(" ", 1)[1])
        for key, acc in total.items():
            for k, v in got[key].items():
                acc[k] += v
    shutil.rmtree(work, ignore_errors=True)
    check(not failed, f"every example exits 0 (failed: {failed})")
    total["wall_s"] = time.perf_counter() - t0
    return total


def kernel_wrappers() -> dict:
    """Each kernel's wrapper by name: its ``launches`` is the count."""
    from repro_torch.kernels.alias_build import alias_build_batched
    from repro_torch.kernels.alias_sample import alias_sample_batched
    from repro_torch.kernels.cdf_scan import cdf_scan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.forest_delta import forest_delta, forest_delta_update
    from repro_torch.kernels.forest_sample import (
        forest_pack,
        forest_sample,
        forest_sample_batched,
        forest_sample_batched_streams,
    )
    from repro_torch.kernels.sample_tiled import sample_rows

    return {"cdf_scan": cdf_scan, "forest_delta": forest_delta,
            "forest_sample": forest_sample,
            "forest_pack": forest_pack,
            "forest_delta_update": forest_delta_update,
            "forest_sample_batched": forest_sample_batched,
            "forest_sample_batched_streams": forest_sample_batched_streams,
            "alias_build_batched": alias_build_batched,
            "alias_sample_batched": alias_sample_batched,
            "sample_rows": sample_rows,
            "flash_attention": flash_attention}


def run(build_s: float) -> dict:
    """The whole smoke run on the card (``build_s``: the kernel library's
    build time); returns the kernels record."""
    import repro_torch.configs as C
    from repro_torch.configs.paper_workloads import env_map_2d
    from repro_torch.launch.mesh import make_host_mesh

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

    wrappers = kernel_wrappers()

    counts, path_ms = {}, {}

    def counted(label, path, *args, **kwargs):
        """Drive one path with every count at 0; keep and print its counts,
        and return the path's result."""
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = path(*args, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts[label] = {k: fn.launches for k, fn in wrappers.items()}
        print(f"launches on the {label} path ({wall:.3f} s, host clock): {counts[label]}",
              flush=True)
        return out

    def profiled(label, path, *args, **kwargs):
        """Drive one path again with every count at 0, under torch.profiler
        (CUDA activity only) and with its printing muted: each kernel's
        summed device time there. Its counts must equal the first run's.
        The first run stays unprofiled, so the times it prints carry no
        tracing cost. Returns the path's result."""
        from torch.profiler import ProfilerActivity, profile

        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        with contextlib.redirect_stdout(io.StringIO()), \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = path(*args, **kwargs)
            torch.cuda.synchronize()
        check({k: fn.launches for k, fn in wrappers.items()} == counts[label],
              f"the {label} path launches the same kernels when run again")
        events = device_events(prof)
        path_ms[label] = kernel_device_ms(events)
        records = kernel_records(events)
        for k, c in counts[label].items():
            check(c == 0 or path_ms[label][k] > 0,
                  f"{k}: device time on the {label} path under its symbols")
        print(f"kernel device ms on the {label} path (profiler, the path's launches again; "
              "device records / launches): "
              + ", ".join(f"{k} {v:.4f} ({records[k]} / {counts[label][k]})"
                          for k, v in path_ms[label].items() if v > 0), flush=True)
        return out

    counted("main", main_path, device, weights, m, n_draws, gen)
    root = Path(__file__).resolve().parent
    ex = examples_path(root)
    counts["examples"], path_ms["examples"] = ex["launches"], ex["device_ms"]
    print(f"launches on the examples path ({ex['wall_s']:.3f} s, host clock, "
          f"{len(EXAMPLES)} processes): {counts['examples']}", flush=True)
    print("kernel device ms on the examples path (profiler, in each example's process; "
          "device records / launches): "
          + ", ".join(f"{k} {v:.4f} ({ex['records'][k]} / {counts['examples'][k]})"
                      for k, v in path_ms["examples"].items() if v > 0), flush=True)
    for name, c in counts["examples"].items():
        check(c > 0 or name == "flash_attention", f"{name} launched on the examples path")
        check(c == 0 or path_ms["examples"][name] > 0,
              f"{name}: device time on the examples path under its symbols")
    del ex
    import torch.distributed as dist

    torch.cuda.set_device(0)
    t = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    dist.barrier(device_ids=[0])  # the communicator is made on the first collective
    print(f"nccl process group of one rank, first collective included: "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    drec = counted("dist", dist_path, device, weights, m, n_draws, gen)
    for name in ("forest_delta", "cdf_scan", "forest_delta_update"):
        check(counts["dist"][name] > 0, f"{name} launched on the dist path")
    dist_checks(drec, device, weights, m)
    del drec
    counted("paper", paper_path, device)
    paper_checks(device)
    mrec = counted("map2d", map2d_path, device)
    for name in ("cdf_scan", "forest_delta", "forest_sample", "forest_pack",
                 "forest_delta_update", "forest_sample_batched"):
        check(counts["map2d"][name] > 0, f"{name} launched on the map2d path")
    map2d_checks(mrec, device)
    map2d_profile(mrec)
    del mrec
    rec = counted("pool", pool_path, device)
    stream_drains = POOL_STREAM_DRAINS + 1  # and one host-uniform drain
    check((counts["pool"]["forest_sample_batched_streams"], counts["pool"]["alias_sample_batched"],
           counts["pool"]["forest_sample_batched"]) == (stream_drains, stream_drains + 1, 1),
          "each drain launches one forest kernel and one alias kernel over all its classes")
    pool_checks(rec, device)
    raw.update(pool_kernels(rec, device, gen, POOL_KERNEL_LANES))
    for name, r in drain_kernels(rec, device).items():
        raw[name]["at_drain"] = r
    alias_build_times(device)
    pool_admission_by_class(rec, device)
    raw["forest_sample_batched_streams"]["at_drain"]["stream_drain"] = pool_profile(
        rec, device, POOL_DRAWS)["stream"]
    counted("robust", robust_path, rec, device, root)
    for name in ("cdf_scan", "forest_sample_batched", "forest_sample_batched_streams",
                 "alias_build_batched", "alias_sample_batched", "sample_rows"):
        check(counts["robust"][name] > 0, f"{name} launched on the robust path")
    del rec

    cfg = C.get(SERVE_ARCH)
    srec = counted("serve", serve_path, device, cfg)
    serve_err = serve_checks(srec, device)
    serve_model_check(device, cfg)
    serve_chi_square(srec, device, gen, SERVE_CHI2_DRAWS)
    serve_other_modes(srec, device, cfg)
    serve_profile(srec, device, cfg)
    del srec
    raw.update(serve_kernels(device, gen))
    raw["cdf_scan"]["at_decode"] = scan_decode_times(device, gen)
    scan_stack_check(device, gen)
    raw["sample_rows"]["max_abs_err"] = max(raw["sample_rows"]["max_abs_err"], serve_err)

    raw.update(flash_kernels(device, gen, build_s))
    tcfg = C.get(TRAIN_ARCH)
    erec = counted("eval", eval_path, device, tcfg)
    eval_profile(erec)
    del erec
    ckpt_root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    trec = counted("train", train_path, device, tcfg, ckpt_root)
    for name in ("cdf_scan", "forest_delta", "forest_sample", "forest_pack"):
        check(counts["train"][name] > 0, f"{name} launched by the trainer's mixture")
    check(counts["train"]["flash_attention"] == 0, "training runs einsum attention")
    train_timing(trec, tcfg, device)
    del trec
    train_launcher(ckpt_root)
    counted("families", families_path, device)
    for name in ("cdf_scan", "sample_rows", "flash_attention"):
        check(counts["families"][name] > 0, f"{name} launched on the families path")
    counted("families_train", families_train_path, device)
    for name in ("cdf_scan", "forest_delta", "forest_sample", "forest_pack"):
        check(counts["families_train"][name] > 0,
              f"{name} launched by the families' training mixtures")
    check(counts["families_train"]["flash_attention"] == 0, "training runs einsum attention")
    whisper_resume(device, ckpt_root)
    mesh = make_host_mesh(1, 1, device=device)
    counted("dist_lm", dist_lm_path, device, tcfg, mesh)
    for name in ("cdf_scan", "forest_delta", "forest_sample", "forest_pack", "sample_rows",
                 "flash_attention"):
        check(counts["dist_lm"][name] > 0, f"{name} launched on the dist_lm path")
    check(counts["dist_lm"]["flash_attention"] == 2 * tcfg.n_layers,
          "B10 once per layer of each eval forward, unsharded and hinted")
    dist_lm_checks(device, tcfg, mesh, ckpt_root)
    path_ms["dist_families"] = counted("dist_families", dist_families_path, device, mesh)["ms"]
    for name in ("cdf_scan", "forest_delta", "forest_sample", "forest_pack", "sample_rows",
                 "flash_attention"):
        check(counts["dist_families"][name] > 0, f"{name} launched on the dist_families path")
    counted("dryrun", dryrun_path, device, TRAIN_ARCH, mesh)

    profiled("main", main_path, device, weights, m, n_draws, gen)
    profiled("dist", dist_path, device, weights, m, n_draws, gen)
    profiled("dist_lm", dist_lm_path, device, tcfg, mesh, replay=True)
    dist.destroy_process_group()
    profiled("paper", paper_path, device)
    profiled("map2d", map2d_path, device)
    rec = profiled("pool", pool_path, device)
    profiled("robust", robust_path, rec, device, root)
    del rec
    profiled("serve", serve_path, device, cfg)
    profiled("eval", eval_path, device, tcfg)
    profiled("train", train_replay, device, tcfg)
    _, path_ms["families"] = families_traced(device, counts["families"])
    profiled("families_train", families_train_replay, device)

    sources = {k: (f"{k}.cu", r) for k, r in (
        ("cdf_scan", "src/repro/kernels/cdf_scan.py:78"),
        ("forest_delta", "src/repro/kernels/forest_delta.py:37"),
        ("forest_sample", "src/repro/kernels/forest_sample.py:320"))}
    # B1's layout, packed once per forest; B1's TPU kernel reads the six arrays
    sources["forest_pack"] = ("forest_sample.cu", "src/repro/kernels/forest_sample.py:320")
    sources.update(POOL_KERNELS)
    sources["sample_rows"] = ("sample_tiled.cu", "src/repro/kernels/sample_tiled.py:46")
    sources["flash_attention"] = ("flash_attention.cu",
                                  "src/repro/kernels/flash_attention.py:73")
    kernels = []
    for name, (src, replaces) in sources.items():
        r = raw[name]
        own = ("main" if name in ("cdf_scan", "forest_delta", "forest_sample", "forest_pack")
               else "serve" if name == "sample_rows"
               else "eval" if name == "flash_attention" else "pool")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": counts[own][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
            "launches_by_path": {p: counts[p][name] for p in PATHS},
            "device_ms_by_path": {p: path_ms[p][name] for p in PATHS},
        })
        if "at_drain" in r:
            kernels[-1]["at_drain"] = r["at_drain"]
        for key in ("sector_ms", "packed_sector_ms", "one_call_ms", "at_f32", "at_hd112",
                    "at_shapes", "launch_floor_ms"):
            if key in r:
                kernels[-1][key] = r[key]
        if "at_decode" in r:
            kernels[-1]["at_decode"] = {
                k: {"shape": list(SCAN_DECODE_SHAPE), "ms": d["ms"], "plain_ms": d["plain_ms"],
                    "library_ms": d["library_ms"], "cumsum_ms": d["cumsum_ms"],
                    "bound_ms": d["bound"][0], "max_abs_err": d["max_abs_err"]}
                for k, d in r["at_decode"].items()}
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} launched on its path")
    return {"kernels": kernels}


def main() -> int:
    # cuBLAS is deterministic under torch.use_deterministic_algorithms only
    # with a fixed workspace, set before its first handle (the train phase)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    build_s = time.perf_counter() - t
    print(f"kernel library built and loaded in {build_s:.3f} s", flush=True)

    record = run(build_s)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
