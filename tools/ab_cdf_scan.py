"""Time B3 (``cdf_scan``) of two checkouts of this repository on one card,
in turns.

    python3 tools/ab_cdf_scan.py OLD_DIR NEW_DIR

Each checkout's own ``repro_torch`` (its wrapper, and its kernel library
built at first use under that checkout's ``build/``) runs in a process of
its own, in the order old, new, new, old. Each process makes the same
seeded inputs and times, with this checkout's ``chip_smoke.cuda_ms_per_call``
(calls queued behind a card spin, back to back between one pair of CUDA
events), the scan at: the decode shape (16, 151936) softmax in bf16 and
float32; one decode row (1, 151936) bf16; the main path's chunk rows
(64, 16384) raw; the pool's chunk rows (B * 64, L) raw for L in 1, 16, 256
and 1024, for an admission wave of B = 341 tenants (4096 tenants over 12
classes) and for one tenant's update (B = 1); and the carry rows (B, 64)
raw for both. Every result is checked against the plain version within
``SCAN_ATOL`` times the row total. Prints the card's name and power limit,
then one line a shape: old and new, each the mean of its two processes
(each process's time in brackets), and old / new.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DECODE_V = 151936
WAVE_B = 341  # tenants of one size class in a 4096-tenant, 12-class pool


def shapes() -> list[tuple[str, int, int, str, bool, bool]]:
    """(label, B, V, dtype, softmax, normalize) of every timed scan."""
    out = [("decode (16, 151936) bf16 softmax", 16, DECODE_V, "bfloat16", True, True),
           ("decode (16, 151936) f32 softmax", 16, DECODE_V, "float32", True, True),
           ("one row (1, 151936) bf16 softmax", 1, DECODE_V, "bfloat16", True, True),
           ("main chunk rows (64, 16384) f32 raw", 64, 16384, "float32", False, False)]
    for B in (WAVE_B, 1):
        for L in (1, 16, 256, 1024):
            out.append((f"pool chunk rows ({B} x 64, {L}) raw", B * 64, L, "float32",
                        False, False))
        out.append((f"pool carry rows ({B}, 64) raw", B, 64, "float32", False, False))
    return out


def child(tree: Path) -> dict:
    """The measurements of ``tree``'s B3 in this process."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    from chip_smoke import check, cuda_ms_per_call
    from repro_torch.kernels import ref
    from repro_torch.kernels.cdf_scan import SCAN_ATOL, cdf_scan

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for label, B, V, dtype, softmax, normalize in shapes():
        if softmax:
            x = torch.randn((B, V), generator=gen, device=dev) * 3.0
        else:
            x = torch.rand((B, V), generator=gen, device=dev)
        x = x.to(getattr(torch, dtype))
        got = cdf_scan(x, softmax=softmax, normalize=normalize)
        want = ref.ref_cdf_scan(x, softmax=softmax, normalize=normalize)
        check(bool(((got - want).abs() <= SCAN_ATOL * want[:, -1:].abs()).all()),
              f"{label} within SCAN_ATOL in {tree}")
        n = 20 if B * V > 1 << 22 else 100
        out[label] = cuda_ms_per_call(
            lambda: cdf_scan(x, softmax=softmax, normalize=normalize), n)
    return out


if __name__ == "__main__":
    from ab_runner import main  # beside this file, first on sys.path

    sys.exit(main(__file__, child, "B3 (cdf_scan), ms per call (cuda_ms_per_call)",
                  __doc__))
