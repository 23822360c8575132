"""Granite-3 8B: dense, GQA kv=8.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155 [hf:ibm-granite].
Note vocab 49155 is odd (3 x 16385): exercises GSPMD uneven vocab sharding.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
)

REDUCED = reduced(CONFIG)
