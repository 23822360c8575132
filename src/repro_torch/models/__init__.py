"""The port's LM stack, dense family: configuration, layers, the eval and
training entry points ``forward`` and ``loss_fn``, and the serving entry
points ``prefill`` and ``decode_step``."""
from .config import ModelConfig, reduced
from .model import (
    DenseLM,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)

__all__ = ["DenseLM", "ModelConfig", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "prefill", "reduced"]
