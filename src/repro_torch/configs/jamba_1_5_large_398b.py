"""Jamba-1.5-Large: hybrid Mamba+attention 1:7, MoE 16e top-2 every 2nd layer.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536 [arXiv:2403.19887].
Period-8 super-block: attention at position 4 (1 attn : 7 mamba), MoE on odd
positions (the published 398B total, 94B active).
Sub-quadratic (mostly-SSM) -> runs long_500k.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    mlp_pattern=("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe"),
    n_experts=16,
    top_k=2,
    ssm_state=16,
    ssm_expand=2,
)

REDUCED = reduced(CONFIG)
