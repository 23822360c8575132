"""Quickstart on the PyTorch/CUDA port: build a radix tree forest, sample,
inspect (paper Secs. 3.1-3.2). The twin of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/torch_quickstart.py               # on the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions

One distribution, many draws is the paper's amortized workload; for the
multi-tenant twin (thousands of small per-request distributions, batched
construction + bulk mixed-batch sampling via ``repro_torch.pool``) see
``examples/torch_pool_serving.py``. For the 2-D walkthrough (the paper's
environment-map application served as a row marginal plus pow2-size-class
conditional stacks, ``repro_torch.spatial.Map2DSampler``) see
``examples/torch_density_map_sampling.py``.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (
    build_forest,
    depth_stats,
    normalize_weights,
    np_sample_forest_counting,
    sample_binary,
    sample_forest,
    table1_row,
    validate_forest,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device

    # A high-dynamic-range discrete distribution (the paper's sweet spot).
    n, m = 1024, 1024
    weights = normalize_weights(np.arange(1, n + 1, dtype=np.float64) ** 20)

    forest = build_forest(weights, m, device=dev)
    validate_forest(forest)
    print(f"forest over n={n} intervals, m={m} guide cells")
    print(f"  tagged single-interval cells: {int((forest.table < 0).sum())}/{m}")
    print(f"  max tree depth: {depth_stats(forest)['max_depth']}")
    print(f"  degenerate cells flagged for balanced fallback: "
          f"{int(forest.fallback.sum())}")

    # Sample: monotone inverse CDF via guide table + radix tree (Algorithm 2).
    xi = np.random.default_rng(0).random(1 << 16).astype(np.float32)
    idx = sample_forest(forest, xi, device=dev)
    oracle = sample_binary(forest.cdf, xi, device=dev)
    assert torch.equal(idx, oracle), "forest must invert the CDF exactly"
    print("sampling: forest == searchsorted oracle on 65536 draws")

    # The cost the paper optimizes: memory loads, esp. the warp-synchronized max.
    _, loads = np_sample_forest_counting(forest, xi)
    print("load counts:", table1_row(loads))

    # Distribution check.
    counts = np.bincount(idx.cpu().numpy(), minlength=n)
    top = np.argsort(weights)[-3:][::-1]
    for i in top:
        print(f"  p[{i}]={weights[i]:.4f}  observed={counts[i] / len(xi):.4f}")


if __name__ == "__main__":
    main()
