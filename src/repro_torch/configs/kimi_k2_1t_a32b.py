"""Kimi K2: trillion-parameter MoE (DeepSeek-V3-style fine-grained experts).

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8 + 1 shared [Kimi K2 paper table]. First layer dense in
the original; assignment numbers applied uniformly. ~1.03T total params.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    block_pattern=("attn",),
    mlp_pattern=("moe",),
    n_experts=384,
    top_k=8,
    n_shared_experts=1,
    moe_ff=2048,
    # 61 is prime: period must divide n_layers -> period 1.
)

REDUCED = reduced(CONFIG)
