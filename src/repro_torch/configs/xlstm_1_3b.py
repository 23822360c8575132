"""xLSTM-1.3B: alternating mLSTM / sLSTM blocks (1:1 at this scale).

48L d_model=2048 4H d_ff=0 (projections live inside the blocks) vocab=50304
[arXiv:2405.04517]. Fully recurrent -> sub-quadratic -> runs long_500k.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    block_pattern=("mlstm", "slstm"),
    mlp_pattern=("none",),
    mlstm_chunk=128,
)

REDUCED = reduced(CONFIG)
