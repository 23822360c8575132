"""Paper Table 1 on the PyTorch port: memory-load counts (maximum / average
/ average_32) for Cutpoint+binary-search vs Cutpoint+radix-forest on the
four distributions of Fig. 12, with the forests built by the port on
``device``.

    PYTHONPATH=src python -m benchmarks.torch_table1 [--device cpu|cuda]

The counts are deterministic functions of the forest arrays, which are
functions of the CDF bits: given the JAX package's CDF (``cdf_of``), every
row equals ``benchmarks/table1.py``'s. The port's own CDF may differ from
JAX's by a few ulp (``ROADMAP.md`` C2), and one row moves with it.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.paper_workloads import TABLE1
from repro_torch.core import (
    build_cdf,
    forest_from_cdf,
    forest_to_numpy,
    np_sample_cutpoint_binary_counting,
    np_sample_forest_counting,
    table1_row,
)
from repro_torch.device import resolve, to_device


def forests(n: int = 256, m: int = 256, device="cuda", cdf_of=None) -> dict:
    """The forest of each Table 1 distribution, built on ``device`` from the
    port's ``build_cdf`` or from ``cdf_of(name, weights)``."""
    dev = resolve(device)
    out = {}
    for name, make in TABLE1.items():
        w = make(n)
        cdf = build_cdf(w, device=dev) if cdf_of is None else to_device(
            cdf_of(name, w), dev, torch.float32)
        out[name] = forest_from_cdf(cdf, m, device=dev)
    return out


def run(n: int = 256, m: int = 256, n_samples: int = 1 << 16, seed: int = 0,
        device="cuda", cdf_of=None):
    rng = np.random.default_rng(seed)
    xi = rng.random(n_samples).astype(np.float32)
    rows = []
    for name, f in forests(n, m, device, cdf_of).items():
        fn = forest_to_numpy(f)
        cdf = fn["cdf"]
        i_b, loads_b = np_sample_cutpoint_binary_counting(cdf, fn["cell_first"], fn["table"], xi)
        i_f, loads_f = np_sample_forest_counting(f, xi)
        if not np.all(cdf[i_b] == cdf[i_f]):
            raise RuntimeError(f"{name}: cutpoint+binary and the forest disagree")
        rows.append((name, "cutpoint+binary", table1_row(loads_b)))
        rows.append((name, "cutpoint+radix_forest", table1_row(loads_f)))
    return rows


PAPER = {  # the paper's reported numbers for side-by-side context
    ("i^20", "cutpoint+binary"): (8, 1.25, 3.66),
    ("i^20", "cutpoint+radix_forest"): (16, 1.23, 3.46),
    ("(i mod 32 + 1)^25", "cutpoint+binary"): (6, 1.30, 4.62),
    ("(i mod 32 + 1)^25", "cutpoint+radix_forest"): (13, 1.22, 3.72),
    ("(i mod 64 + 1)^35", "cutpoint+binary"): (7, 1.19, 4.33),
    ("(i mod 64 + 1)^35", "cutpoint+radix_forest"): (13, 1.11, 2.46),
    ("4 spikes", "cutpoint+binary"): (4, 1.60, 3.98),
    ("4 spikes", "cutpoint+radix_forest"): (5, 1.67, 4.93),
}


def main(device="cuda") -> list[str]:
    out = []
    for name, method, row in run(device=device):
        p = PAPER.get((name, method))
        paper_s = f" | paper: max={p[0]} avg={p[1]:.2f} avg32={p[2]:.2f}" if p else ""
        out.append(
            f"table1,{name},{method},max={row['maximum']},"
            f"avg={row['average']:.2f},avg32={row['average_32']:.2f}{paper_s}"
        )
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    print("\n".join(main(ap.parse_args().device)))
