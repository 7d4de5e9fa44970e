"""Model registry and input specs for every (architecture x shape) cell, as
the JAX package's ``models/model.py``.

A spec is a tensor on the ``meta`` device: it carries the shape and dtype
of the reference's ``ShapeDtypeStruct`` and allocates nothing. The counts
and caches come from the model built on ``meta`` (``_on_meta``), whose
``init`` takes no generator; the entry points' ``resolve_device`` still
refuses ``meta``, so nothing else reaches it.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Union

import torch

from ..configs.base import ArchConfig, ShapeConfig
from .common import META
from .encdec import EncDecLM
from .lm import LM, tree_map

Pytree = Any

_SPEC_DTYPES = {"int32": torch.int32, "float32": torch.float32,
                "bfloat16": torch.bfloat16}


def build_model(cfg: ArchConfig, **kw) -> Union[LM, EncDecLM]:
    """``EncDecLM`` for the encdec family (``scan_impl``, ``moe_impl`` and
    ``mla_absorbed`` dropped from ``kw``, as the reference drops what it
    does not take), else the ``LM`` (dense, moe over GQA or MLA, ssm,
    hybrid, vlm). ``kw`` goes to the model (the impls, ``mla_absorbed``,
    ``device``)."""
    if cfg.family == "encdec":
        for key in ("scan_impl", "moe_impl", "mla_absorbed"):
            kw.pop(key, None)
        return EncDecLM(cfg, **kw)
    return LM(cfg, **kw)


def _on_meta(cfg: ArchConfig, model=None) -> Union[LM, EncDecLM]:
    """``model`` (by default ``build_model(cfg)``'s) as a copy whose device
    is ``meta``: its ``init(None)`` and caches hold no memory."""
    model = copy.copy(model or build_model(cfg, device="cpu"))
    model.device = META
    return model


def _spec(shape, dtype: str) -> torch.Tensor:
    return torch.empty(shape, dtype=_SPEC_DTYPES[dtype], device=META)


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, T = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {"src_embeds": _spec((B, T, cfg.d_model), cfg.compute_dtype),
                "tokens": _spec((B, T), "int32"),
                "labels": _spec((B, T), "int32")}
    batch: Dict[str, Any] = {"labels": _spec((B, T), "int32")}
    if cfg.embed_inputs:
        batch["embeds"] = _spec((B, T, cfg.d_model), cfg.compute_dtype)
    else:
        batch["tokens"] = _spec((B, T), "int32")
    if cfg.rope == "mrope":
        batch["positions"] = _spec((B, 3, T), "int32")
    return batch


def prefill_batch_specs(cfg: ArchConfig,
                        shape: ShapeConfig) -> Dict[str, Any]:
    B, T = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        # the encoder takes the seq_len frames; the decoder a short prompt
        return {"src_embeds": _spec((B, T, cfg.d_model), cfg.compute_dtype),
                "tokens": _spec((B, 128), "int32")}
    batch: Dict[str, Any] = {}
    if cfg.embed_inputs:
        batch["embeds"] = _spec((B, T, cfg.d_model), cfg.compute_dtype)
    else:
        batch["tokens"] = _spec((B, T), "int32")
    if cfg.rope == "mrope":
        batch["positions"] = _spec((B, 3, T), "int32")
    return batch


def decode_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B = shape.global_batch
    batch: Dict[str, Any] = {"tokens": _spec((B, 1), "int32")}
    if cfg.rope == "mrope":
        batch["positions"] = _spec((B, 3, 1), "int32")
    return batch


def decode_cache_specs(model, cfg: ArchConfig, shape: ShapeConfig) -> Pytree:
    """The cache of a decode step with a ``seq_len``-token context, on
    ``meta`` whatever ``model``'s device; the enc-dec's cross K/V sized to
    the encoder memory (``seq_len`` frames)."""
    B, T = shape.global_batch, shape.seq_len
    cache = _on_meta(cfg, model).decode_cache_init(B, T)
    if cfg.family == "encdec":
        cross = (cfg.n_layers, B, cfg.kv_heads, T, cfg.resolved_head_dim)
        cache = dict(cache, cross_k=_spec(cross, cfg.kv_cache_dtype),
                     cross_v=_spec(cross, cfg.kv_cache_dtype))
    return cache


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                model=None) -> Dict[str, Any]:
    """All inputs of the step function this shape runs."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape)}
    if shape.kind == "decode":
        return {"batch": decode_batch_specs(cfg, shape),
                "cache": decode_cache_specs(model, cfg, shape),
                "pos": _spec((), "int32")}
    raise ValueError(shape.kind)


def count_params(cfg: ArchConfig) -> int:
    """The leaves of ``init``'s params, summed, from the model on
    ``meta``."""
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), _on_meta(cfg).init(None))
    return sum(sizes)


def active_params(cfg: ArchConfig) -> int:
    """Active params per token (MoE: shared + top_k routed experts)."""
    total = count_params(cfg)
    if not cfg.n_experts:
        return total
    per_expert = 3 * cfg.d_model * cfg.d_expert
    inactive = (cfg.n_experts - cfg.top_k) * per_expert * cfg.n_layers
    return total - inactive
