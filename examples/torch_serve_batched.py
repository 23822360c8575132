"""End-to-end serving driver on the PyTorch/CUDA port (the paper's kind:
sampling in the serving hot path). Builds a small LM, runs
continuous-batched decode over a stream of requests, sampling every token
through the fused CDF scan and the per-row tiled inverse at per-slot QMC
stream points. The twin of ``examples/serve_batched.py``.

  PYTHONPATH=src python examples/torch_serve_batched.py [--requests 16] [--mode alias] [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeEngine, TokenSampler


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--mode", default="inverse_qmc",
                    choices=["inverse_qmc", "inverse_rng", "alias"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device

    cfg = dataclasses.replace(
        C.get_reduced("qwen3_4b"), dtype="float32",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=1024,
    )
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    sampler = TokenSampler(mode=args.mode, n_slots=args.slots,
                           temperature=0.8, device=dev)
    eng = ServeEngine(params, cfg, n_slots=args.slots, max_seq=128,
                      sampler=sampler, device=dev)

    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=rng.integers(4, 12)),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    t0 = time.time()
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=2000)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in reqs)
    print(f"mode={args.mode}: {len(reqs)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s, {eng.steps} batched decode steps)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt={list(r.prompt)[:6]}... -> {r.out[:12]}...")
    assert all(r.done for r in reqs)


if __name__ == "__main__":
    main()
