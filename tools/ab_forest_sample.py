"""Time kernel B1 (``forest_sample``, Algorithm 2 over one forest) of two
checkouts of this repository on one card, in turns.

    python3 tools/ab_forest_sample.py OLD_DIR NEW_DIR

Each checkout's own ``repro_torch`` (its kernel library built at first use
under that checkout's ``build/``) runs in a process of its own, in the order
old, new, new, old. Each process builds the main path's forest
(``env_map_2d(1024, 1024)``, n = m = 2^20) through ``build_forest`` and,
where the checkout has ``forest_pack``, packs it once, as the samplers do.
It first holds the kernel elementwise against its plain version on the card
(2^24 uniforms, both ``use_fallback`` values, and the three degenerate
forests of ``chip_smoke.py``), then measures: B1 at 2^24 lanes, and at the
``ForestSampler`` call sizes 2^15 and 2^16, each per call (``cuda_ms_per_call``:
calls queued behind a card spin, back to back) and as one call between CUDA
events (median of 20; the wrapper's host time falls inside); B1 per call at
2^20 lanes on each degenerate forest; the device ms of one ``sample_forest``
call on the bare forest (torch.profiler, every kernel it runs, the pack
included where the checkout packs on the way); and B1's and the pack's
device ms over ``chip_smoke.main_path`` (the smoke's main path, its printing
muted). Prints the card's name and power limit, then one line a
measurement: old and new, each the mean of its two processes (each
process's value in brackets), and old / new; the runner is
``tools/ab_runner.py``.
"""
from __future__ import annotations

import contextlib
import io
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LANES = 1 << 24
SAMPLER_LANES = (1 << 15, 1 << 16)
DEGENERATE_LANES = 1 << 20


def child(tree: Path) -> dict:
    """The B1 measurements of ``tree`` in this process."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import numpy as np
    import torch

    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (
        SIDE,
        check,
        cuda_ms,
        cuda_ms_per_call,
        degenerate_forests,
        device_ms,
        kernel_device_ms,
        main_path,
    )
    from repro_torch.configs.paper_workloads import env_map_2d
    from repro_torch.core import build_forest, sample_forest
    from repro_torch.kernels import forest_sample as fs
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    weights = env_map_2d(SIDE, SIDE, seed=0).reshape(-1).astype(np.float32)
    m = weights.shape[0]

    def sampler(f):
        """B1 on forest ``f`` as its holder calls it: with the pack made
        once where the checkout has one."""
        six = (f.cdf, f.table, f.left, f.right, f.cell_first, f.fallback)
        packer = getattr(fs, "forest_pack", None)
        if packer is None:
            return lambda x, fb=True: fs.forest_sample(*six, x, use_fallback=fb)
        pk = packer(f.cdf, f.table, f.left, f.right, f.fallback)
        return lambda x, fb=True: fs.forest_sample(*six, x, use_fallback=fb, packed=pk)

    forest = build_forest(weights, m, device=dev)
    b1 = sampler(forest)
    xi = torch.rand(LANES, generator=gen, device=dev)
    for fb in (True, False):
        check(torch.equal(b1(xi, fb), ref.ref_forest_sample(*forest, xi, fb)),
              f"B1 == plain at 2^24 lanes, use_fallback={fb}")
    out = {}
    out["B1 2^24 lanes: ms per call"] = cuda_ms_per_call(lambda: b1(xi), 20)
    out["B1 2^24 lanes: ms one call"] = cuda_ms(lambda: b1(xi), 20)
    for q in SAMPLER_LANES:
        x = xi[:q].clone()
        out[f"B1 2^{q.bit_length() - 1} lanes: ms per call"] = cuda_ms_per_call(
            lambda: b1(x), 200)
        out[f"B1 2^{q.bit_length() - 1} lanes: ms one call"] = cuda_ms(lambda: b1(x), 20)
    for name, fd in degenerate_forests(dev).items():
        bd = sampler(fd)
        x = xi[:DEGENERATE_LANES].clone()
        for fb in (True, False):
            check(torch.equal(bd(x, fb), ref.ref_forest_sample(*fd, x, fb)),
                  f"B1 == plain on {name}, use_fallback={fb}")
        out[f"B1 2^20 lanes, {name}: ms per call"] = cuda_ms_per_call(lambda: bd(x), 50)
    out["sample_forest 2^24 lanes, bare forest: device ms"] = device_ms(
        lambda: sample_forest(forest, xi, device=dev), 5)
    with contextlib.redirect_stdout(io.StringIO()), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        main_path(dev, weights, m, LANES, gen)
        torch.cuda.synchronize()
    path_ms = kernel_device_ms(prof)
    out["main path: B1 device ms"] = path_ms["forest_sample"]
    out["main path: forest_pack device ms"] = path_ms["forest_pack"]
    return out


if __name__ == "__main__":
    from ab_runner import main  # beside this file, first on sys.path

    sys.exit(main(__file__, child, "B1 forest_sample (lanes: CUDA events; sample_forest and "
                  "the main path: torch.profiler device ms)", __doc__))
