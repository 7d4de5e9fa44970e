"""Architecture config registry: ``get_config("<arch-id>")`` plus reduced
smoke configs for CPU tests.

The schema and the config files are copies of the JAX package's, so the
port imports nothing of it. ``ARCH_IDS`` lists every architecture the repo
knows, and the port runs all of them. ``PORT_ONLY_ARCH_IDS`` lists the
architectures that only the port has (``PortArchConfig``s, which no JAX
config mirrors); ``get_config`` and ``smoke_config`` resolve them too.
"""
from __future__ import annotations

import importlib
from typing import Dict

from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                   ArchConfig, PortArchConfig, ShapeConfig, shapes_for)

ARCH_IDS = [
    "grok-1-314b",
    "deepseek-v2-lite-16b",
    "glm4-9b",
    "olmo-1b",
    "qwen3-0.6b",
    "minitron-8b",
    "rwkv6-3b",
    "recurrentgemma-9b",
    "seamless-m4t-large-v2",
    "qwen2-vl-72b",
]

# what the port runs: every arch of the repo (dense, moe over GQA or MLA,
# ssm, hybrid, encdec through ``EncDecLM`` and vlm with M-RoPE)
PORTED_ARCH_IDS = tuple(ARCH_IDS)

# what only the port has: deepseek-v3's q-LoRA MLA under YaRN, grouped
# sigmoid routing with a selection bias, leading dense layers
PORT_ONLY_ARCH_IDS = ("deepseek-v3-671b",)


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS and arch_id not in PORT_ONLY_ARCH_IDS:
        raise KeyError(f"unknown arch id {arch_id!r}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def smoke_config(arch_id: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (small layers/width,
    tiny vocab), as the JAX package reduces it."""
    cfg = get_config(arch_id)
    kw = dict(
        n_layers=len(cfg.block_pattern) + 1 if cfg.block_pattern else 2,
        d_model=64,
        d_ff=128,
        vocab=256,
        remat="none",
        opt_state_dtype="float32",
    )
    if cfg.n_heads:
        kw.update(n_heads=4, kv_heads=min(cfg.kv_heads, 2), head_dim=16)
    if cfg.n_experts:
        kw.update(n_experts=4, n_shared_experts=min(cfg.n_shared_experts, 1),
                  top_k=2, d_expert=64)
    if cfg.kv_lora:
        kw.update(kv_lora=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    if cfg.family == "ssm":
        kw.update(rwkv_head_dim=16)
    if cfg.n_encoder_layers:
        kw.update(n_encoder_layers=2)
    if cfg.window:
        kw.update(window=16)
    kw["page_size"] = 8
    if cfg.bias_layers:
        # deepseek-v3: one dense layer and two expert layers; 16 experts in
        # 4 groups, 2 groups a token, 4 of the 16 held; q-LoRA; YaRN at
        # factor 4 over 64 positions, so that its ramp has inner points
        kw.update(n_layers=3, first_dense=1, n_experts=16, top_k=4,
                  d_expert=32, n_group=4, topk_group=2, experts_held=4,
                  first_held=4, q_lora=24, qk_rope_dim=16, yarn_factor=4.0,
                  yarn_original=64)
    return cfg.with_(**kw)


__all__ = ["ALL_SHAPES", "ARCH_IDS", "ArchConfig", "DECODE_32K", "LONG_500K",
           "PORTED_ARCH_IDS", "PORT_ONLY_ARCH_IDS", "PREFILL_32K",
           "PortArchConfig", "ShapeConfig", "TRAIN_4K", "all_configs",
           "get_config", "shapes_for", "smoke_config"]
