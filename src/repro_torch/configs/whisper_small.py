"""Whisper-small: encoder-decoder, conv audio frontend stubbed.

12L (x2: 12 enc + 12 dec) d_model=768 12H d_ff=3072 vocab=51865
[arXiv:2212.04356]. input_specs() supplies precomputed frame embeddings
(B, S_enc, d_model) — the conv1d stack is a stub per the assignment.
RoPE replaces learned/sinusoidal positions.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    block_pattern=("attn",),
    mlp_pattern=("dense",),
    encoder_layers=12,
    cross_attention=True,
    frontend="audio",
)

REDUCED = reduced(CONFIG)
