"""Train and serve steps: the units a training loop or server calls.

``make_train_step``: loss -> gradients -> AdamW, with optional microbatch
gradient accumulation (the batch reshaped to ``(k, B/k, ...)``, gradients
summed in ``grad_dtype`` and divided by ``k``), as the JAX package's
``train/step.py``. ``make_serve_step``: one decode token through the cached
stack, then the paper's sampler: fused softmax -> CDF rows (kernel
``cdf_scan``) and the per-row inverse (kernel ``sample_rows``).
"""
from __future__ import annotations

import torch

from repro_torch.device import to_device
from repro_torch.dist.local import whole
from repro_torch.kernels import ops
from repro_torch.models import decode_step as model_decode
from repro_torch.models import loss_fn, prefill
from repro_torch.models.config import ModelConfig

from .optimizer import AdamWConfig, OptState, apply_updates


def loss_and_grads(params, cfg: ModelConfig, batch: dict, remat: str = "none"):
    """One step's loss (detached) and ``{parameter name: gradient}`` of
    ``loss_fn`` on ``batch``. For a distributed model (DTensor parameters)
    the loss is a replicated plain tensor and each gradient a DTensor."""
    names, ps = zip(*params.named_parameters())
    loss, _ = loss_fn(params, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, ps)
    return whole(loss.detach()), dict(zip(names, grads))


def make_train_step(cfg: ModelConfig, oc: AdamWConfig, remat: str = "dots",
                    microbatches: int = 1, grad_dtype: str = "float32"):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)``. ``params`` is a :class:`~repro_torch.models.LM` whose
    parameters require grad; it and ``opt_state`` are updated in place.
    ``batch`` holds (B, ...) arrays or tensors; with ``microbatches=k`` they
    are cut into ``k`` microbatches of ``B/k`` rows. ``metrics``: ``loss``,
    ``grad_norm``, ``lr`` (float32 tensors)."""
    gdt = torch.bfloat16 if grad_dtype == "bfloat16" else torch.float32

    def train_step(params, opt_state: OptState, batch: dict):
        batch = {k: to_device(v, params.device) for k, v in batch.items()}
        if microbatches == 1:
            loss, grads = loss_and_grads(params, cfg, batch, remat)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"batch of {B} rows does not split into {microbatches}")
            n = B // microbatches
            gsum = {k: torch.zeros_like(p, dtype=gdt) for k, p in params.named_parameters()}
            lsum = torch.zeros((), dtype=torch.float32, device=params.device)
            for i in range(microbatches):
                micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, g = loss_and_grads(params, cfg, micro, remat)
                for k in gsum:
                    gsum[k] = gsum[k] + g[k].to(gdt)
                lsum = lsum + l
            grads = {k: g / microbatches for k, g in gsum.items()}
            loss = lsum / microbatches
        params, opt_state, om = apply_updates(oc, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_serve_step(cfg: ModelConfig, temperature: float = 1.0):
    """Returns ``serve_step(params, cache, token, pos, xi[, enc_out]) ->
    (next_token (B,) int32, cache)``. ``xi``: one uniform per row (B,), e.g.
    from the per-slot QMC streams, which keep the monotone warp stratified;
    ``enc_out``: the encoder output of the prefill, for an encoder-decoder.
    With a distributed model the inputs may be DTensors sharded over the
    batch; the sampler takes whole rows and uniforms."""

    @torch.no_grad()
    def serve_step(params, cache, token, pos, xi, enc_out=None):
        logits, cache = model_decode(params, cfg, cache, token, pos, enc_out)
        logits = whole(logits)   # the sampler's kernels take the whole rows
        cdf = ops.fused_cdf(logits / temperature, softmax=True)
        xi = whole(to_device(xi, logits.device, torch.float32))
        return ops.sample_rows(cdf, xi[:, None])[:, 0], cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    """Returns ``prefill_step(params, batch) -> (last logits, cache,
    enc_out)``; ``enc_out`` is the encoder output (``None`` without an
    encoder), which ``serve_step`` takes."""

    def prefill_step(params, batch):
        return prefill(params, cfg, batch, max_seq=max_seq)

    return prefill_step
