"""glm4-9b [hf:THUDM/glm-4-9b]: 40L d4096 32H (GQA kv=2) d_ff=13696
vocab=151552, RoPE."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, kv_heads=2, d_ff=13696,
    vocab=151552, head_dim=128,
    remat="layer",
)
