"""Training driver on the PyTorch/CUDA port: ~100M-parameter LM on the
synthetic mixture pipeline (radix-forest corpus sampling), with
checkpointing and auto-resume. The twin of ``examples/train_lm.py``.

The default config is a 113M-param dense decoder; --preset tiny gives a
fast sanity run. Kill it mid-run and re-invoke: it resumes from the last
checkpoint and (by the fault-tolerance contract) lands on the identical
trajectory.

  PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --steps 60 --device cpu
  PYTHONPATH=src python examples/torch_train_lm.py --steps 300   # ~100M params, the card
"""
import argparse
import dataclasses

import repro_torch.configs as C
from repro_torch.models.config import ModelConfig
from repro_torch.train import AdamWConfig, TrainConfig, Trainer


def preset_100m() -> ModelConfig:
    return dataclasses.replace(
        C.get("qwen1_5_0_5b"),
        name="dense-113m",
        n_layers=10, d_model=640, n_heads=10, n_kv_heads=10, head_dim=64,
        d_ff=1728, vocab=50304, tie_embeddings=False, dtype="float32",
    )


def preset_tiny() -> ModelConfig:
    return dataclasses.replace(
        preset_100m(), name="dense-3m", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=256, vocab=2048,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="100m", choices=["100m", "tiny"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="checkpoints/torch_train_lm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = preset_100m() if args.preset == "100m" else preset_tiny()
    total, _ = cfg.param_count()
    print(f"model {cfg.name}: {total / 1e6:.1f}M params")
    tc = TrainConfig(
        steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=f"{args.ckpt}_{args.preset}", ckpt_every=25, log_every=5,
        mixture_weights=(0.5, 0.25, 0.125, 0.125),
    )
    oc = AdamWConfig(lr=6e-4, total_steps=args.steps,
                     warmup_steps=max(args.steps // 20, 2))
    out = Trainer(cfg, tc, oc=oc, device=args.device).run()
    if out["final_loss"] is None:  # resumed at the last step: nothing left to run
        print(f"final loss: none (the checkpoint is already at step {args.steps})")
    else:
        print(f"final loss: {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
