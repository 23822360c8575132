"""Time the trainer's checkpoint save of two checkouts of this repository
on one card, in turns.

    python3 tools/ab_ckpt_save.py OLD_DIR NEW_DIR

Each checkout's own ``repro_torch`` runs in a process of its own, in the
order old, new, new, old. Each process makes the Trainer of Qwen1.5-0.5B at
full width (float32 masters and AdamW state on the card, from the same
seed) and times, on the host clock, its checkpoint save at step 1 into
that checkout's ``build/`` (``mgr.save`` of ``_tree(params, opt)``, then
``mgr.wait``: whatever layout that checkout's trainer writes), and the
bytes it wrote. Prints the card's name and power limit, then one line a
measurement: old and new, each the mean of its two processes (each
process's value in brackets), and old / new.
"""
from __future__ import annotations

import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen1_5_0_5b"


def child(tree: Path) -> dict:
    """The save of ``tree``'s trainer in this process."""
    sys.path[:0] = [str(tree / "src")]
    import torch

    import repro_torch.configs as C
    from repro_torch.train import TrainConfig, Trainer

    d = tree / "build" / "ab_ckpt_save"
    shutil.rmtree(d, ignore_errors=True)
    tr = Trainer(C.get(ARCH), TrainConfig(steps=1, ckpt_dir=str(d), keep=1),
                 log_fn=lambda _: None, device="cuda")
    params, opt = tr.init_state()
    torch.cuda.synchronize()
    t = time.perf_counter()
    tr.mgr.save(tr._tree(params, opt), 1)
    tr.mgr.wait()
    save_s = time.perf_counter() - t
    nbytes = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
    shutil.rmtree(d, ignore_errors=True)
    return {"save s (host clock)": save_s, "bytes on disk": float(nbytes)}


if __name__ == "__main__":
    from ab_runner import main  # beside this file, first on sys.path

    sys.exit(main(__file__, child, f"Trainer checkpoint save, {ARCH} at full width", __doc__))
