"""Figure-8 reproduction on the PyTorch/CUDA port: sample a 2-D HDR
environment map with the radix forest (monotone, row-then-column) vs the
Alias Method, on a low-discrepancy point set. Writes PGM images of the
sampled histograms and prints errors. The twin of
``examples/density_map_sampling.py``.

The forest branch runs through :class:`repro_torch.spatial.Map2DSampler`:
one multi-row build a size class, and the whole point set resolves in one
bulk ``sample_map`` drain (the marginal descent, then one grouped launch
over the conditionals' classes). The alias branch builds every row's
table in one batched call and drains in one. A differential gate asserts
that the bulk path reproduces the per-row row-then-column reference
elementwise, with exact zero-mass-row semantics (an empty row's marginal
interval has zero width, so no uniform can select it).

  PYTHONPATH=src python examples/torch_density_map_sampling.py [--n 16384] [--device cpu]
"""
import argparse
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.paper_workloads import env_map_2d
from repro_torch.core import build_forest, normalize_weights, quadratic_error, sample_forest
from repro_torch.core.alias import build_alias, np_sample_alias
from repro_torch.core.lds import sobol
from repro_torch.pool import build_alias_batched, sample_alias_batched
from repro_torch.spatial import Map2DSampler


def write_pgm(path: str, img: np.ndarray) -> None:
    a = img / max(img.max(), 1e-30)
    a = (np.sqrt(a) * 255).astype(np.uint8)  # gamma for visibility
    with open(path, "wb") as fh:
        fh.write(f"P5\n{a.shape[1]} {a.shape[0]}\n255\n".encode())
        fh.write(a.tobytes())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--h", type=int, default=96)
    ap.add_argument("--w", type=int, default=192)
    ap.add_argument("--out", default="experiments/torch_density_map")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    h, w, n, dev = args.h, args.w, args.n, args.device
    img = env_map_2d(h, w)
    p_flat = (img / img.sum()).ravel()
    pts = sobol(n, dims=2).astype(np.float32)

    # ---- forest branch: the bulk 2-D pipeline (no per-row build loop)
    sampler = Map2DSampler(img, device=dev)
    ri_t, ci_t, _, _ = sampler.sample_map(pts)
    ri, ci = ri_t.cpu().numpy(), ci_t.cpu().numpy()
    inv_counts = np.bincount(
        sampler.flat_index(ri, ci), minlength=h * w
    ).reshape(h, w)

    # Differential gate: the row-then-column per-row loop. Class rows
    # behave exactly like build_forest over the pow2-padded row, so the
    # oracle builds at the class width; the bulk path must match
    # ELEMENTWISE: same rows, same columns, hence the same histogram.
    wc = int(sampler._class_of[0])
    marg = normalize_weights(img.sum(axis=1))
    assert np.array_equal(sampler.marginal_weights(), marg), "served marginal"
    f_rows = build_forest(marg, h, device=dev)
    rr = sample_forest(f_rows, pts[:, 0], device=dev).cpu().numpy()
    assert np.array_equal(rr, ri), "bulk marginal diverged from reference"
    cr = np.empty(n, np.int64)
    for r in np.unique(rr):
        mask = rr == r
        wpad = np.pad(normalize_weights(img[r]), (0, wc - w))
        f_col = build_forest(wpad, wc, device=dev)
        cr[mask] = np.minimum(
            sample_forest(f_col, pts[mask, 1], device=dev).cpu().numpy(), w - 1
        )
    assert np.array_equal(cr, ci), "bulk conditional diverged from reference"

    # ---- alias branch: batched build + one bulk drain
    a_rows = build_alias(normalize_weights(img.sum(axis=1)), device=dev)
    ra = np_sample_alias(
        a_rows.q.cpu().numpy().astype(np.float64), a_rows.alias.cpu().numpy(), pts[:, 0]
    )
    cond = np.stack([normalize_weights(img[r]) for r in range(h)])
    tbl = build_alias_batched(cond, device=dev)
    ca = sample_alias_batched(
        tbl, torch.as_tensor(ra, dtype=torch.int32), pts[:, 1]
    ).cpu().numpy()
    ali_counts = np.bincount(ra * w + ca, minlength=h * w).reshape(h, w)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    write_pgm(out / "target.pgm", img)
    write_pgm(out / "inverse.pgm", inv_counts.astype(np.float64))
    write_pgm(out / "alias.pgm", ali_counts.astype(np.float64))
    e_inv = quadratic_error(inv_counts.ravel(), p_flat)
    e_ali = quadratic_error(ali_counts.ravel(), p_flat)
    print(f"n={n}: quadratic error inverse={e_inv:.3e} alias={e_ali:.3e} "
          f"(alias/inverse = {e_ali / max(e_inv, 1e-30):.2f}x)")
    print(f"forest drain: {sampler.last_drain}")
    print(f"wrote {out}/target.pgm, inverse.pgm, alias.pgm")


if __name__ == "__main__":
    main()
