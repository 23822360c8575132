"""Time kernel B10's float32 body (``flash_attention`` on float32 inputs)
of two checkouts of this repository on one card, in turns.

    python3 tools/ab_flash_f32.py OLD_DIR NEW_DIR

Each checkout's own ``repro_torch`` (its kernel library built at first use
under that checkout's ``build/``) runs in a process of its own, in the
order old, new, new, old. Each process makes the same seeded float32
inputs at: the ragged non-causal case of ``chip_smoke.py`` (1, 1000, 4/2
heads, hd 64), the eval shape in float32 (2, 2048, 16/16 heads, hd 64,
causal) and Qwen3-4B's GQA in float32 (1, 1024, 32/8 heads, hd 128,
causal). At each it holds the kernel within 2e-5 of the plain version (the
JAX suite's float32 tolerance; the largest error is printed too), then
times the kernel and ``scaled_dot_product_attention`` on the same tensors
(K/V expanded for GQA, laid out (B, heads, S, hd) before timing) with
``chip_smoke.cuda_ms_per_call`` (calls queued behind a card spin, back to
back between one pair of CUDA events). Prints the card's name and power
limit, then one line a measurement: old and new, each the mean of its two
processes (each process's value in brackets), and old / new; the runner is
``tools/ab_runner.py``.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5
# (B, S, H, KV, hd, causal)
SHAPES = ((1, 1000, 4, 2, 64, False), (2, 2048, 16, 16, 64, True),
          (1, 1024, 32, 8, 128, True))


def child(tree: Path) -> dict:
    """The float32 B10 measurements of ``tree`` in this process."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch
    import torch.nn.functional as F

    from chip_smoke import check, cuda_ms_per_call
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    out = {}
    for B, S, H, KV, hd, causal in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
        got, want = flash_attention(q, k, v, causal), ref.ref_flash_attention(q, k, v, causal)
        check(torch.allclose(got, want, rtol=TOL, atol=TOL),
              f"float32 B10 within {TOL} of plain at {(B, S, H, KV, hd, causal)} in {tree}")
        qt, kt, vt = (t.repeat_interleave(H // t.shape[2], dim=2).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        label = f"({B}, {S}, {H}/{KV}, hd {hd}, causal={causal})"
        out[f"{label} max |err| vs plain"] = float((got - want).abs().max())
        out[f"{label} B10 f32 ms per call"] = cuda_ms_per_call(
            lambda: flash_attention(q, k, v, causal), 10)
        out[f"{label} SDPA ms per call"] = cuda_ms_per_call(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 10)
    return out


if __name__ == "__main__":
    from ab_runner import main  # beside this file, first on sys.path

    sys.exit(main(__file__, child, "B10 float32 (flash_attention), ms per call "
                  "(cuda_ms_per_call)", __doc__))
