"""seamless-m4t-large-v2 [arXiv:2308.11596; hf]: enc-dec 24L+24L d1024 16H
d_ff=8192 vocab=256206. Modality frontend is a STUB — input_specs() provides
precomputed audio-frame embeddings (per the assignment)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_encoder_layers=24, d_model=1024, n_heads=16, kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    norm="layernorm", rope="none",
    embed_inputs=True,
    remat="layer",
)
