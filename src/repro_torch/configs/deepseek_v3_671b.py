"""deepseek-v3-671b [arXiv:2412.19437; hf]: 61L d7168 128H MLA (q_lora
1536, kv_lora 512, nope 128 + rope 64, v 128) under YaRN (factor 40 over
4096 positions, mscale 1 and 1), the first 3 layers dense (d_ff 18432),
then 256 routed experts of 2048 a layer, 8 a token, and 1 shared expert;
sigmoid scores with a selection bias moved by gamma 0.001 a step (no
auxiliary loss but the sequence-wise balance loss at alpha 1e-4), the top
4 of 8 groups by the sum of each group's two best biased scores, gates
normalised and times 2.5; vocab 129280.

A port-only architecture (no JAX config mirrors it), from the public
config (hf:deepseek-ai/DeepSeek-V3 ``config.json``) but for its one MTP
layer, which the port does not build. ``experts_held`` 0: every expert is
held; a deployment sets the chip's share with ``with_``.
"""
from .base import PortArchConfig

CONFIG = PortArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, kv_heads=128, d_ff=18432,
    vocab=129280, head_dim=128,
    n_experts=256, n_shared_experts=1, top_k=8, d_expert=2048,
    moe_strategy="expert_parallel",
    kv_lora=512, q_lora=1536, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    opt_state_dtype="bfloat16", remat="layer",
    first_dense=3, scoring="sigmoid", n_group=8, topk_group=4,
    routed_scaling=2.5, bias_speed=0.001, balance_alpha=0.0001,
    yarn_factor=40.0, yarn_original=4096, yarn_beta_fast=32.0,
    yarn_beta_slow=1.0, yarn_mscale=1.0, yarn_mscale_all_dim=1.0,
)
