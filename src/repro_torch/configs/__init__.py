"""Architecture config registry: ``get_config("<arch-id>")`` plus reduced
smoke configs for CPU tests.

The schema and the config files are copies of the JAX package's, so the
port imports nothing of it. ``ARCH_IDS`` lists every architecture the repo
knows; ``get_config`` raises ``NotImplementedError`` for the ones the port
does not run yet.
"""
from __future__ import annotations

import importlib

from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                   ArchConfig, ShapeConfig, shapes_for)

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

# dense GQA decoders with RoPE and RMSNorm: what the port's LM runs today
PORTED_ARCH_IDS = ("glm4-9b", "qwen3-0.6b")


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch id {arch_id!r}")
    if arch_id not in PORTED_ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id!r} is not ported to repro_torch yet "
            f"(ported: {', '.join(PORTED_ARCH_IDS)})")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


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
    if cfg.window:
        kw.update(window=16)
    kw["page_size"] = 8
    return cfg.with_(**kw)


__all__ = ["ALL_SHAPES", "ARCH_IDS", "ArchConfig", "DECODE_32K", "LONG_500K",
           "PORTED_ARCH_IDS", "PREFILL_32K", "ShapeConfig", "TRAIN_4K",
           "get_config", "shapes_for", "smoke_config"]
