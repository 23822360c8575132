"""Training: AdamW, the train/prefill/serve steps, and the trainer."""
from .optimizer import AdamWConfig, OptState, apply_updates, init_opt
from .step import make_prefill_step, make_serve_step, make_train_step
from .trainer import TrainConfig, Trainer

__all__ = [
    "AdamWConfig", "OptState", "apply_updates", "init_opt",
    "make_prefill_step", "make_serve_step", "make_train_step",
    "TrainConfig", "Trainer",
]
