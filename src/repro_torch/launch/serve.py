"""Serving launcher: continuous batching with the radix-CDF token sampler.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --device cpu

Serves random prompts through a reduced-width, float32 model with seeded
random weights on ``--device`` (default ``cuda``). ``--arch`` takes any of
the ten architectures; the engine prefills token prompts, so for the
``embed`` frontend (internvl2-76b) and the encoder-decoder (whisper-small)
the launcher drives the model's ``prefill`` and ``decode_step`` itself,
with synthetic embeddings and frames as ``data.make_batch`` draws them.
"""
from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="an architecture of repro_torch.configs.ARCHS (module or published name)")
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
    if cfg.frontend == "embed" or cfg.encoder_layers:
        sampler = TokenSampler(mode=args.mode, n_slots=args.requests, device=device)
        steps = serve_model_level(params, cfg, sampler, args.requests, args.max_new)
        print(f"served {args.requests}/{args.requests} requests, "
              f"{args.requests * args.max_new} tokens, {steps} batched decode steps "
              f"(model-level prefill and decode_step), sampler={args.mode}, device={device}")
        return
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


def serve_model_level(params, cfg, sampler, n: int, max_new: int) -> int:
    """The ``n`` requests as one batch through ``prefill`` and
    ``decode_step``: an 8-token prompt of ``make_batch``'s synthetic inputs
    (embeddings under the embed frontend, frames for an encoder), then
    ``max_new - 1`` decode steps; under the embed frontend each step feeds
    fresh synthetic embeddings (the model has no token table). Returns the
    decode steps taken."""
    import numpy as np

    from repro_torch.data import make_batch
    from repro_torch.models import decode_step, prefill

    batch = make_batch(cfg, 0, n, 8)
    slots = np.arange(n)
    logits, cache, enc_out = prefill(params, cfg, batch, max_seq=8 + max_new)
    tok = sampler.sample(logits, slots)
    rng = np.random.default_rng(1)
    for step in range(max_new - 1):
        x = (rng.normal(0, 1, (n, 1, cfg.d_model)).astype(np.float32)
             if cfg.frontend == "embed" else tok)
        logits, cache = decode_step(params, cfg, cache, x, np.full(n, 8 + step), enc_out)
        tok = sampler.sample(logits, slots)
    return max_new - 1

if __name__ == "__main__":
    main()
