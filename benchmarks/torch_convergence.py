"""Paper Figs. 7-9 on the PyTorch port: QMC convergence, inverse mapping
vs Alias Method, with the forests built and descended by the port on
``device``.

    PYTHONPATH=src python -m benchmarks.torch_convergence [--device cpu|cuda]

1-D (Fig. 7): a smooth high-dynamic-range density sampled at 64 steps.
2-D (Figs. 8-9): synthetic HDR environment map, row then column inversion
(the marginal through ``sample_forest``, every row's conditional in one
``build_forest_rows`` pass and one ``sample_forest_rows`` launch).
Metric (Fig. 9): quadratic error sum_i (c_i/N - p_i)^2. The Alias Method
baseline is the host Vose build and numpy draw, as in
``benchmarks/convergence.py``. ``cdf_of(weights)`` replaces the port's
``build_cdf`` for the 1-D density and the 2-D row marginal (the column
CDFs are the numpy ``np_build_cdf``, as in the JAX benchmark); ``counts``,
a list, receives each inverse histogram.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.paper_workloads import env_map_2d
from repro_torch.core import (
    build_cdf,
    build_forest_rows,
    forest_from_cdf,
    pack_forest,
    quadratic_error,
    sample_forest,
    sample_forest_rows,
    star_discrepancy_1d,
)
from repro_torch.core.alias import build_alias, np_sample_alias
from repro_torch.core.cdf import normalize_weights, np_build_cdf
from repro_torch.core.lds import sobol
from repro_torch.device import resolve, to_device


def density_1d(n: int = 64) -> np.ndarray:
    x = np.linspace(0, 1, n)
    w = np.exp(8 * np.sin(2 * np.pi * x) ** 2) * (1.2 + np.cos(5 * x))
    return normalize_weights(w + 1e-9)


def _forest(p: np.ndarray, m: int, dev, cdf_of):
    cdf = build_cdf(p, device=dev) if cdf_of is None else to_device(
        cdf_of(p), dev, torch.float32)
    return forest_from_cdf(cdf, m, device=dev)


def _alias(p: np.ndarray):
    at = build_alias(p, device="cpu")
    return at.q.numpy().astype(np.float64), at.alias.numpy()


def run_1d(max_log2: int = 18, device="cuda", cdf_of=None, counts=None):
    dev = resolve(device)
    p = density_1d()
    f = _forest(p, 64, dev, cdf_of)
    packed = pack_forest(f)
    q, alias = _alias(p)
    rows = []
    for lg in range(8, max_log2 + 1, 2):
        n = 1 << lg
        xi = sobol(n, dims=1)[:, 0].astype(np.float32)
        inv = sample_forest(f, xi, device=dev, packed=packed).cpu().numpy()
        ali = np_sample_alias(q, alias, xi)
        c_inv = np.bincount(inv, minlength=64)
        if counts is not None:
            counts.append(c_inv)
        e_inv = quadratic_error(c_inv, p)
        e_ali = quadratic_error(np.bincount(ali, minlength=64), p)
        rows.append((n, e_inv, e_ali))
    return rows


def run_2d(max_log2: int = 20, h: int = 128, w: int = 256, device="cuda", cdf_of=None,
           counts=None):
    dev = resolve(device)
    img = env_map_2d(h, w)
    rowsum = normalize_weights(img.sum(axis=1))
    f_rows = _forest(rowsum, h, dev, cdf_of)
    packed = pack_forest(f_rows)
    # all per-row column forests in ONE data-parallel pass (paper Sec. 5)
    col_cdfs = np.stack(
        [np_build_cdf(normalize_weights(img[r] + 1e-18)) for r in range(h)]
    )
    f_cols = build_forest_rows(col_cdfs, m=min(w, 256), device=dev)
    qa, aa = _alias(rowsum)
    a_cols = [_alias(normalize_weights(img[r] + 1e-18)) for r in range(h)]
    p_flat = (img / img.sum()).ravel()

    out = []
    for lg in range(10, max_log2 + 1, 2):
        n = 1 << lg
        pts = sobol(n, dims=2).astype(np.float32)

        # inverse: monotone row then column, the rows staying on the device
        ri = sample_forest(f_rows, pts[:, 0], device=dev, packed=packed)
        ci = sample_forest_rows(f_cols, ri, pts[:, 1])
        flat = (ri.long() * w + ci.long()).cpu().numpy()
        c_inv = np.bincount(flat, minlength=h * w)
        if counts is not None:
            counts.append(c_inv)
        e_inv = quadratic_error(c_inv, p_flat)

        # alias: row then column
        ra = np_sample_alias(qa, aa, pts[:, 0])
        ca = np.empty(n, np.int64)
        for r in np.unique(ra):
            mask = ra == r
            ca[mask] = np_sample_alias(*a_cols[r], pts[mask, 1])
        e_ali = quadratic_error(np.bincount(ra * w + ca, minlength=h * w), p_flat)
        out.append((n, e_inv, e_ali))
    return out


def run_discrepancy(n: int = 4096, device="cuda", cdf_of=None):
    """Fig. 1's 'unwarped space' argument, 1-D: star discrepancy of the
    samples mapped back through the CDF (inverse preserves the input's
    discrepancy; alias scrambles it)."""
    dev = resolve(device)
    p = density_1d()
    f = _forest(p, 64, dev, cdf_of)
    q, alias = _alias(p)
    xi = sobol(n, dims=1)[:, 0].astype(np.float32)
    d_input = star_discrepancy_1d(xi)
    cdf = f.cdf.cpu().numpy().astype(np.float64)

    inv = sample_forest(f, xi, device=dev).cpu().numpy()
    # unwarp: position of xi inside its interval, mapped back to [0,1)
    width = np.maximum(cdf[inv + 1] - cdf[inv], 1e-30)
    unwarped_inv = cdf[inv] + np.clip((xi - cdf[inv]) / width, 0, 1) * width

    ali = np_sample_alias(q, alias, xi)
    na = len(p)
    frac = xi * na - np.floor(xi * na)
    unwarped_ali = cdf[ali] + frac * np.maximum(cdf[ali + 1] - cdf[ali], 1e-30)

    return {
        "input": d_input,
        "inverse": star_discrepancy_1d(unwarped_inv),
        "alias": star_discrepancy_1d(unwarped_ali),
    }


def main(device="cuda") -> list[str]:
    out = []
    for n, e_inv, e_ali in run_1d(device=device):
        out.append(
            f"fig7_1d,n={n},err_inverse={e_inv:.3e},err_alias={e_ali:.3e},"
            f"ratio={e_ali / max(e_inv, 1e-30):.2f}"
        )
    for n, e_inv, e_ali in run_2d(device=device):
        out.append(
            f"fig9_2d,n={n},err_inverse={e_inv:.3e},err_alias={e_ali:.3e},"
            f"ratio={e_ali / max(e_inv, 1e-30):.2f}"
        )
    d = run_discrepancy(device=device)
    out.append(
        f"fig1_discrepancy,input={d['input']:.4f},inverse={d['inverse']:.4f},"
        f"alias={d['alias']:.4f}"
    )
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    print("\n".join(main(ap.parse_args().device)))
