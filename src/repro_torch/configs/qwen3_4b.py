"""Qwen3-4B: dense, GQA kv=8, qk-norm.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936 [hf:Qwen/Qwen3-*].
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
)

REDUCED = reduced(CONFIG)
