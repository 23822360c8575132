"""The port's LM stack, every family of the JAX package: configuration,
layers, the MoE, Mamba and xLSTM blocks, the eval and training entry points
``forward`` and ``loss_fn``, and the serving entry points ``prefill`` and
``decode_step``."""
from .config import ModelConfig, reduced
from .model import (
    LM,
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)

__all__ = ["LM", "ModelConfig", "decode_step", "encode", "forward", "init_cache",
           "init_params", "loss_fn", "prefill", "reduced"]
