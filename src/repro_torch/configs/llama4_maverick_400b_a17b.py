"""Llama-4 Maverick (assignment numbers verbatim): MoE 128e top-1.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048
[hf:meta-llama/Llama-4-*]. Early-fusion multimodal in the original; the
assignment exercises the text backbone. Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    block_pattern=("attn",),
    mlp_pattern=("moe",),
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
    moe_ff=8192,
)

REDUCED = reduced(CONFIG)
