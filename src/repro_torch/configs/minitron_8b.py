"""minitron-8b [arXiv:2407.14679; hf]: 32L d4096 32H (GQA kv=8) d_ff=16384
vocab=256000 (pruned nemotron)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, kv_heads=8, d_ff=16384,
    vocab=256000, head_dim=128,
    remat="layer",
)
