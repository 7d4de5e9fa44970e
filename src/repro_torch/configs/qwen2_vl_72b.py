"""qwen2-vl-72b [arXiv:2409.12191; hf]: 80L d8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE. Vision frontend is a STUB — input_specs() provides
precomputed patch embeddings + 3D M-RoPE position ids."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, kv_heads=8, d_ff=29568,
    vocab=152064, head_dim=128,
    rope="mrope",
    embed_inputs=True,
    opt_state_dtype="bfloat16",   # 72B
    remat="layer",
)
