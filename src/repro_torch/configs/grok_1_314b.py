"""grok-1-314b [hf:xai-org/grok-1; unverified]: 64L d6144 48H (GQA kv=8)
d_ff=32768 vocab=131072, MoE 8 experts top-2."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, kv_heads=8, d_ff=32768,
    vocab=131072, head_dim=128,
    n_experts=8, top_k=2, d_expert=32768,
    # 8 experts don't tile a 16-way model axis -> expert-TP (ffn sharded)
    moe_strategy="expert_tp",
    opt_state_dtype="bfloat16",   # 314B params: m/v in bf16 to fit HBM
    remat="layer",
)
