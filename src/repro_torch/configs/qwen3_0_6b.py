"""qwen3-0.6b [hf:Qwen/Qwen3-0.6B]: 28L d1024 16H (GQA kv=8) d_ff=3072
vocab=151936, qk_norm, head_dim=128."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, kv_heads=8, d_ff=3072,
    vocab=151936, head_dim=128,
    qk_norm=True,
    remat="layer",
)
