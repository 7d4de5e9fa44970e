"""rwkv6-3b (Finch) [arXiv:2404.05892; hf]: 32L d2560 (attention-free,
data-dependent decay) d_ff=8960 vocab=65536.

TPU adaptation (DESIGN.md): public head_size is 64 (40 heads); we use
head_dim=80 (32 heads) so the head dim tiles the 16-way model axis cleanly.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, kv_heads=0, d_ff=8960,
    vocab=65536,
    rwkv_head_dim=80,
    rope="none",
    subquadratic=True,
    remat="layer",
)
