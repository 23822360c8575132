"""Training driver: deterministic data, checkpoint/restart, failure injection.

The restart contract of the JAX package's ``train/trainer.py``: batches are
pure functions of (seed, step), and the checkpoint stores (parameters,
optimizer state, step), so kill-at-any-step + resume reproduces the same
trajectory. The port keeps float32 master parameters and computes in
``cfg.dtype`` (each layer casts at use), as the JAX package does; the
parameters are initialized from a torch generator seeded with ``seed``
(other draws than JAX's PRNG, the same distributions).

Checkpoints are written in the JAX trainer's layout: the tree ``(params,
OptState)`` keyed by JAX's pytree paths (``0/layers/b0/wq``, ``1/step``,
``1/m/embed``, ...), per-period leaves stacked over the periods, weights
``(in, out)``, each leaf in its own dtype. The map
(:mod:`repro_torch.models.layout`) runs on host copies at the trainer's
boundary; ``ckpt.save``/``restore`` stay generic. One checkpoint directory
therefore resumes in either package.

Given a ``mesh`` and a ``policy`` (``dist.sharding.Policy``), the trainer
runs sharded: the parameters become DTensors placed by the policy
(``distribute_params``; every rank makes the same seeded init), the moments
shard like them, and a checkpoint, saved unsharded (whole arrays, written
by global rank 0 after every rank has gathered), resumes into the sharded
run through ``ckpt.restore(shardings=)`` (``dist.sharding.
jax_tree_shardings``): each rank keeps its shards.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.ckpt import CheckpointManager, latest_step
from repro_torch.data.mixture import MixtureSampler
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve
from repro_torch.dist.local import whole
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.layout import named_from_jax, named_to_jax

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
                 device="cuda", mesh=None, policy=None):
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
        if (mesh is None) != (policy is None):
            raise ValueError("a sharded Trainer takes both mesh and policy")
        self.mesh, self.policy = mesh, policy

    def init_state(self):
        """Float32 master parameters (trainable) and zero AdamW state."""
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = init_params(self.cfg, gen, self.device, param_dtype=torch.float32)
        params.requires_grad_(True)
        if self.mesh is not None:
            from repro_torch.dist.sharding import distribute_params

            distribute_params(params, self.mesh, self.policy)
        return params, init_opt(self.oc, params)

    def _tree(self, params, opt: OptState, leaf=None):
        """``(params, OptState)`` in the JAX trainer's checkpoint layout,
        each tensor mapped through ``leaf`` (default: a host copy of the
        whole tensor, gathered from its shards)."""
        leaf = leaf or (lambda t: whole(t.detach()).cpu())

        def jax_layout(named):
            return named_to_jax({k: leaf(t) for k, t in named.items()}, self.cfg)

        return (jax_layout(dict(params.named_parameters())),
                OptState(leaf(opt.step), jax_layout(opt.m), jax_layout(opt.v)))

    def _restore(self, params, opt: OptState) -> OptState:
        """Load the latest checkpoint (of either package) into ``params``
        and ``opt`` in place; returns the restored state."""
        # shapes and dtypes only: no host copy of the model
        like = self._tree(params, opt, leaf=lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                                  device="meta"))
        shardings = None
        if self.mesh is not None:
            from repro_torch.dist.sharding import jax_tree_shardings

            sh = jax_tree_shardings(self.cfg, self.mesh, self.policy)
            shardings = (sh, OptState(None, sh, sh))
        (tree_p, tree_o), _ = self.mgr.restore_latest(like, shardings)
        with torch.no_grad():
            for dst, src in ((dict(params.named_parameters()), tree_p),
                             (opt.m, tree_o.m), (opt.v, tree_o.v)):
                for k, t in named_from_jax(src, self.cfg).items():
                    if isinstance(t, DTensor):   # to the parameter's own placements
                        t = t.redistribute(dst[k].device_mesh, dst[k].placements)
                    dst[k].copy_(t)
        return OptState(tree_o.step.to(opt.step.device), opt.m, opt.v)

    def run(self) -> dict[str, Any]:
        params, opt = self.init_state()
        start = 0
        if latest_step(self.tc.ckpt_dir) is not None:
            opt = self._restore(params, opt)
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
                tree = self._tree(params, opt)   # every rank gathers
                if self.mesh is None or dist.get_rank() == 0:
                    self.mgr.save(tree, step + 1)
        self.mgr.wait()
        if self.mesh is not None:
            dist.barrier()   # rank 0's checkpoint is on disk for every rank
        return {
            "params": params,
            "opt": opt,
            "metrics": metrics_hist,
            "final_loss": metrics_hist[-1]["loss"] if metrics_hist else None,
        }
