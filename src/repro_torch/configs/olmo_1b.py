"""olmo-1b [arXiv:2402.00838; hf]: 16L d2048 16H (MHA) d_ff=8192 vocab=50304,
non-parametric LayerNorm."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, kv_heads=16, d_ff=8192,
    vocab=50304, head_dim=128,
    norm="nonparam_ln",
    remat="layer",
)
