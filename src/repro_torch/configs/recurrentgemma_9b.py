"""recurrentgemma-9b [arXiv:2402.19427]: 38L d4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention, pattern 2 recurrent : 1 attention,
window 2048."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, kv_heads=1, d_ff=12288,
    vocab=256000, head_dim=256,
    window=2048,
    block_pattern=("rec", "rec", "attn"),
    subquadratic=True,
    remat="layer",
)
