"""Fault-tolerance demo on the PyTorch/CUDA port: train, crash at a chosen
step, resume, verify the resumed trajectory is bitwise identical to an
uninterrupted run. The twin of ``examples/failover_demo.py``.

  PYTHONPATH=src python examples/torch_failover_demo.py [--device cpu]

On the card both runs use deterministic algorithms (cuBLAS with a fixed
workspace, set before its first handle), so every step replays exactly.
"""
import argparse
import dataclasses
import os
import shutil

import torch

import repro_torch.configs as C
from repro_torch.train import TrainConfig, Trainer


def tc(path):
    return TrainConfig(steps=20, global_batch=4, seq_len=32,
                       ckpt_dir=path, ckpt_every=6, log_every=5)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before cuBLAS's first handle
    torch.use_deterministic_algorithms(True)
    cfg = dataclasses.replace(
        C.get_reduced("granite_3_8b"), dtype="float32", n_layers=2,
        d_model=96, n_heads=4, n_kv_heads=2, head_dim=24, d_ff=192, vocab=512,
    )

    shutil.rmtree("checkpoints/torch_failover_a", ignore_errors=True)
    shutil.rmtree("checkpoints/torch_failover_b", ignore_errors=True)

    print("== reference run (no failure) ==")
    ref = Trainer(cfg, tc("checkpoints/torch_failover_a"), device=dev).run()

    print("== run with injected failure at step 13 ==")
    try:
        Trainer(cfg, tc("checkpoints/torch_failover_b"), fail_at_step=13, device=dev).run()
    except RuntimeError as e:
        print(f"CRASH: {e}")

    print("== resume (auto-detects latest checkpoint) ==")
    resumed = Trainer(cfg, tc("checkpoints/torch_failover_b"), device=dev).run()

    same = all(
        torch.equal(a, b)
        for a, b in zip(ref["params"].parameters(), resumed["params"].parameters())
    )
    print(f"bitwise identical to uninterrupted run: {same}")
    assert same


if __name__ == "__main__":
    main()
