"""deepseek-v2-lite-16b [arXiv:2405.04434; hf]: 27L d2048 16H MLA kv_lora=512,
MoE 2 shared + 64 routed top-6, d_expert=1408, vocab=102400.

A copy of the JAX package's config, with its two deviations from the public
config (hf:deepseek-ai/DeepSeek-V2-Lite ``config.json``): MoE in every layer,
where the public config keeps a dense FFN in layer 1
(``first_k_dense_replace=1``), for a uniform scan body; and plain RoPE,
where the public config has YaRN (factor 40, mscale 0.707).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, kv_heads=16, d_ff=1408,
    vocab=102400, head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, d_expert=1408,
    moe_strategy="expert_parallel",   # 64 % 16 == 0 -> all-to-all EP
    kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    remat="layer",
)
