"""Serving launcher: continuous batching with the radix-CDF token sampler.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --device cpu

Serves random prompts through a reduced-width, float32 model with seeded
random weights on ``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--mode", default="inverse_qmc",
                    choices=["inverse_qmc", "inverse_rng", "alias"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import dataclasses

    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.device import resolve
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine, TokenSampler

    cfg = dataclasses.replace(C.get_reduced(args.arch), dtype="float32")
    device = resolve(args.device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    eng = ServeEngine(
        params, cfg, n_slots=args.slots, max_seq=256,
        sampler=TokenSampler(mode=args.mode, n_slots=args.slots, device=device),
        device=device,
    )
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=8), max_new=args.max_new)
        for i in range(args.requests)
    ]
    for r in reqs:
        eng.submit(r)
    eng.run()
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    print(f"served {done}/{len(reqs)} requests, {toks} tokens, "
          f"{eng.steps} batched decode steps, sampler={args.mode}, device={device}")


if __name__ == "__main__":
    main()
