"""StableLM-3B: dense decoder. 32L d_model=2560 32H d_ff=6912 vocab=50304."""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
)

REDUCED = reduced(CONFIG)
