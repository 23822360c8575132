"""The port's LM stack, dense family: configuration, layers, and the
serving entry points ``prefill`` and ``decode_step``."""
from .config import ModelConfig, reduced
from .model import DenseLM, decode_step, init_cache, init_params, prefill

__all__ = ["DenseLM", "ModelConfig", "decode_step", "init_cache", "init_params",
           "prefill", "reduced"]
