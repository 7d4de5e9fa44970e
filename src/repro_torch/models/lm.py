"""Decoder-only LM, dense family.

Params keep the JAX reference's layout: a nested dict with the stacked
``layers`` dim first, so the bridge to the reference is a map over names and
checkpoints stay cross-loadable. The reference scans layers with
``lax.scan``; PyTorch runs eagerly, so here it is a Python loop over the
stacked dim.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from . import blocks
from .common import normal

Pytree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict/list (None kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked params/cache tree (views, no copies)."""
    return tree_map(lambda t: t[i], tree)


class LM:
    """Config-driven dense language model. All state is explicit: params and
    caches are passed in and returned."""

    def __init__(self, cfg: ArchConfig, attn_impl: str = "kernel",
                 device: DeviceLike = "cuda"):
        if cfg.family != "dense" or cfg.n_experts or cfg.kv_lora:
            raise NotImplementedError(
                f"{cfg.name}: only the dense family is ported (family="
                f"{cfg.family!r})")
        if cfg.window is not None or cfg.rope not in ("rope", "none") \
                or cfg.embed_inputs:
            raise NotImplementedError(
                f"{cfg.name}: sliding windows, M-RoPE and embedding inputs "
                f"are not ported yet")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> Pytree:
        """Random params drawn from ``gen``, which must live on the model's
        device. Same names and shapes as the reference's ``LM.init``."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        L = cfg.n_layers
        return {
            "embed": normal(gen, (cfg.vocab, cfg.d_model)) * 0.02,
            "unembed": normal(gen, (cfg.d_model, cfg.vocab))
            * (1.0 / math.sqrt(cfg.d_model)),
            "final_norm": blocks._norm_init(cfg, cfg.d_model, gen),
            "layers": {"attn": blocks.attn_init(gen, cfg, lead=(L,)),
                       "ffn": blocks.ffn_init(gen, cfg, lead=(L,))},
        }

    # ------------------------------------------------------------- forward
    def _compute_cast(self, params):
        """Weights of rank >= 2 in fp32 go to ``compute_dtype`` (the stacked
        layer norms included, as in the reference). Idempotent: params that
        were cast already come back as they are."""
        dt = torch_dtype(self.cfg.compute_dtype)

        def cast(w):
            if w.dtype == torch.float32 and w.dim() >= 2:
                return w.to(dt)
            return w
        return tree_map(cast, params)

    def _tokens(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch["tokens"], device=self.device).long()

    def _embed(self, params, batch):
        dt = torch_dtype(self.cfg.compute_dtype)
        return params["embed"][self._tokens(batch)].to(dt)

    def _positions(self, T: int, offset: int = 0) -> torch.Tensor:
        return torch.arange(T, device=self.device) + offset

    def _layer_apply(self, p, x, positions, cache=None, pos=None):
        x, c = blocks.attn_apply(p["attn"], x, cfg=self.cfg,
                                 positions=positions, cache=cache, pos=pos,
                                 attn_impl=self.attn_impl)
        x = blocks.ffn_apply(p["ffn"], x, cfg=self.cfg)
        return x, c

    def _logits(self, params, x):
        x = blocks.apply_norm(self.cfg, params.get("final_norm"), x)
        return torch.einsum("btd,dv->btv", x, params["unembed"])

    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits, aux_loss)."""
        params = self._compute_cast(params)
        x = self._embed(params, batch)
        positions = self._positions(x.shape[1])
        for i in range(self.cfg.n_layers):
            x, _ = self._layer_apply(_layer(params["layers"], i), x,
                                     positions)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return self._logits(params, x), aux

    # ------------------------------------------------------------- serving
    def decode_cache_init(self, batch: int, max_len: int) -> Pytree:
        cfg = self.cfg
        c = blocks.attn_cache_init(cfg, batch, max_len,
                                   torch_dtype(cfg.kv_cache_dtype),
                                   self.device)
        return {k: v.unsqueeze(0).repeat(cfg.n_layers, *([1] * v.dim()))
                for k, v in c.items()}

    def decode_step(self, params, batch, cache, pos: int):
        """One-token decode. batch: {"tokens": [B, 1]}. Returns (logits
        [B, 1, V], cache); the cache is updated in place."""
        params = self._compute_cast(params)
        x = self._embed(params, batch)
        positions = self._positions(1, offset=int(pos))
        for i in range(self.cfg.n_layers):
            x, _ = self._layer_apply(_layer(params["layers"], i), x,
                                     positions, cache=_layer(cache, i),
                                     pos=pos)
        return self._logits(params, x), cache

    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Prompt processing; returns (logits, decode-ready cache).
        ``max_len`` sizes the kv cache (default: prompt length)."""
        cfg = self.cfg
        params = self._compute_cast(params)
        x = self._embed(params, batch)
        T = x.shape[1]
        max_len = max_len or T
        dt = torch_dtype(cfg.kv_cache_dtype)
        positions = self._positions(T)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            kv = blocks.attn_prefill_kv(lp["attn"], x, cfg=cfg,
                                        positions=positions)
            c = blocks.pack_prefill_cache(cfg, kv, max_len, dt)
            ks.append(c["k"])
            vs.append(c["v"])
            x, _ = self._layer_apply(lp, x, positions)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        return self._logits(params, x), cache
