"""Training launcher: the Trainer on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --preset full --steps 4 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --preset reduced --steps 2 --device cpu

``--arch`` takes any of the ten architectures of ``repro_torch.configs``
(or an alias); ``--preset full`` takes its published widths, ``reduced``
the CPU smoke scale; float32 master parameters, compute in the config's dtype,
einsum attention, checkpoints under ``--ckpt`` (default
``checkpoints/<arch>_<preset>``; a run there resumes from its latest
checkpoint). ``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import repro_torch.configs as C
    from repro_torch.train import TrainConfig, Trainer

    cfg = C.get(args.arch) if args.preset == "full" else C.get_reduced(args.arch)
    tc = TrainConfig(
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        ckpt_dir=args.ckpt or f"checkpoints/{C.canonical(args.arch)}_{args.preset}",
        remat=args.remat,
        microbatches=args.microbatches,
    )
    out = Trainer(cfg, tc, device=args.device).run()
    print(f"done: final loss {out['final_loss']}")


if __name__ == "__main__":
    main()
