"""InternVL2-76B backbone (InternLM2-like LLM; InternViT frontend stubbed).

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 [arXiv:2404.16821].
frontend="embed": input_specs() supplies mixed text+patch embeddings
(B, S, d_model) directly; labels mask the patch positions with -1.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    block_pattern=("attn",),
    mlp_pattern=("dense",),
    frontend="embed",
)

REDUCED = reduced(CONFIG)
