"""Time kernel B9 (``sample_rows``, the per-row two-level inverse-CDF
search of decode sampling) of two checkouts of this repository on one
card, in turns.

    python3 tools/ab_sample_rows.py OLD_DIR NEW_DIR

Each checkout's own ``repro_torch`` (its kernel library built at first use
under that checkout's ``build/``) runs in a process of its own, in the
order old, new, new, old. Each process makes the same seeded CDF rows (B3
softmax rows of ``3 * randn`` logits) and uniforms at the decode shapes
(16, 151936, 1) and (256, 151936, 1), GPT-2's vocabulary (16, 50257, 1)
(rows off the 16-byte grid) and (16, 151936, 8), holds B9 elementwise
against its plain version, and times B9 and ``torch.searchsorted`` (right,
the one library call that computes the same index on monotone rows) with
``chip_smoke.cuda_ms_per_call`` (calls queued behind a card spin, back to
back between one pair of CUDA events). Where the checkout's library has an
empty kernel (``_build.empty_launch``), it times that too: the launch
floor (reported for the new checkout alone where the old has none). Then
it drives ``chip_smoke.serve_path`` (the smoke's serve phase: Qwen1.5-0.5B
at full width in bf16, seeded random weights, 32 + 4 requests, its printing
muted) under torch.profiler and reports B9's device ms and launches there.
Prints the card's name and power limit, then one line a measurement: old
and new, each the mean of its two processes (each process's value in
brackets), and old / new; the runner is ``tools/ab_runner.py``.
"""
from __future__ import annotations

import contextlib
import io
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((16, 151936, 1), (256, 151936, 1), (16, 50257, 1), (16, 151936, 8))


def child(tree: Path) -> dict:
    """The B9 measurements of ``tree`` in this process."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.configs as C
    from chip_smoke import SERVE_ARCH, check, cuda_ms_per_call, kernel_device_ms, serve_path
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.cdf_scan import cdf_scan
    from repro_torch.kernels.sample_tiled import sample_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for B, V, k in SHAPES:
        cdf = cdf_scan(torch.randn((B, V), generator=gen, device=dev) * 3.0)
        xi = torch.rand((B, k), generator=gen, device=dev)
        check(torch.equal(sample_rows(cdf, xi), ref.ref_sample_rows(cdf, xi)),
              f"B9 == plain at {(B, V, k)} in {tree}")
        out[f"B9 {(B, V, k)} ms per call"] = cuda_ms_per_call(lambda: sample_rows(cdf, xi), 200)
        out[f"torch.searchsorted {(B, V, k)} ms per call"] = cuda_ms_per_call(
            lambda: torch.searchsorted(cdf, xi, right=True), 200)
    if hasattr(_build, "empty_launch"):
        out["empty kernel (launch floor) ms per call"] = cuda_ms_per_call(
            lambda: _build.empty_launch(dev), 200)
    cfg = C.get(SERVE_ARCH)
    sample_rows.launches = 0
    with contextlib.redirect_stdout(io.StringIO()), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve_path(dev, cfg)
        torch.cuda.synchronize()
    out["serve path: B9 device ms"] = kernel_device_ms(prof)["sample_rows"]
    out["serve path: B9 launches"] = float(sample_rows.launches)
    return out


if __name__ == "__main__":
    from ab_runner import main  # beside this file, first on sys.path

    sys.exit(main(__file__, child, "B9 (sample_rows), ms per call (cuda_ms_per_call); the "
                  "serve path: torch.profiler device ms", __doc__))
