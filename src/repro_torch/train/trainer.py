"""Training driver: deterministic data, checkpoint/restart, failure injection.

The restart contract of the JAX package's ``train/trainer.py``: batches are
pure functions of (seed, step), and the checkpoint stores (parameters,
optimizer state, step), so kill-at-any-step + resume reproduces the same
trajectory. The port keeps float32 master parameters and computes in
``cfg.dtype`` (each layer casts at use), as the JAX package does; the
parameters are initialized from a torch generator seeded with ``seed``
(other draws than JAX's PRNG, the same distributions).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.ckpt import CheckpointManager, latest_step
from repro_torch.data.mixture import MixtureSampler
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig

from .optimizer import AdamWConfig, OptState, init_opt
from .step import make_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 64
    seed: int = 0
    ckpt_dir: str = "checkpoints/run"
    ckpt_every: int = 25
    keep: int = 3
    log_every: int = 10
    remat: str = "none"
    microbatches: int = 1
    mixture_weights: tuple = (0.5, 0.25, 0.125, 0.125)


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 oc: AdamWConfig | None = None,
                 fail_at_step: int | None = None,
                 log_fn: Callable[[str], None] = print,
                 device="cuda"):
        self.cfg = cfg
        self.tc = tc
        self.oc = oc or AdamWConfig(total_steps=tc.steps, warmup_steps=max(tc.steps // 20, 1))
        self.fail_at_step = fail_at_step
        self.log = log_fn
        self.device = resolve(device)
        self.mixture = MixtureSampler(tc.mixture_weights, seed=tc.seed, device=self.device)
        self.step_fn = make_train_step(cfg, self.oc, remat=tc.remat,
                                       microbatches=tc.microbatches)
        self.mgr = CheckpointManager(tc.ckpt_dir, keep=tc.keep)

    def init_state(self):
        """Float32 master parameters (trainable) and zero AdamW state."""
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = init_params(self.cfg, gen, self.device, param_dtype=torch.float32)
        params.requires_grad_(True)
        return params, init_opt(self.oc, params)

    @staticmethod
    def _tree(params, opt: OptState):
        return (dict(params.named_parameters()), opt)

    def run(self) -> dict[str, Any]:
        params, opt = self.init_state()
        start = 0
        if latest_step(self.tc.ckpt_dir) is not None:
            (named, opt), _ = self.mgr.restore_latest(self._tree(params, opt))
            with torch.no_grad():
                for k, p in params.named_parameters():
                    p.copy_(named[k])
            start = int(opt.step)
            self.log(f"resumed from step {start}")
        metrics_hist = []
        t0 = time.time()
        for step in range(start, self.tc.steps):
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = make_batch(self.cfg, step, self.tc.global_batch, self.tc.seq_len,
                               mixture=self.mixture, seed=self.tc.seed)
            params, opt, m = self.step_fn(params, opt, batch)
            if step % self.tc.log_every == 0 or step == self.tc.steps - 1:
                loss = float(m["loss"])
                self.log(
                    f"step {step:5d} loss {loss:.4f} "
                    f"gnorm {float(m['grad_norm']):.3f} "
                    f"lr {float(m['lr']):.2e} "
                    f"({(time.time() - t0):.1f}s)"
                )
                metrics_hist.append({"step": step, "loss": loss})
            if (step + 1) % self.tc.ckpt_every == 0 or step == self.tc.steps - 1:
                self.mgr.save(self._tree(params, opt), step + 1)
        self.mgr.wait()
        return {
            "params": params,
            "opt": opt,
            "metrics": metrics_hist,
            "final_loss": metrics_hist[-1]["loss"] if metrics_hist else None,
        }
