"""Encoder-decoder LM (seamless-m4t-large-v2's backbone).

The audio frontend is a stub, as in the JAX reference: the encoder takes
precomputed frame embeddings [B, S, d]. Positions are sinusoidal, added at
embed time (the config has rope="none"). Encoder layers: bidirectional
self-attention (the flash kernel, ``causal=False``) and FFN. Decoder
layers: causal self-attention (the flash kernel over a whole sequence, the
plain ``attention_ref`` over the cache in decode), cross-attention over the
encoder memory (plain, as the reference runs it) and FFN.

Params keep the reference's layout: ``embed``, ``unembed``, ``enc`` {attn,
ffn} and ``dec`` {self, cross, ffn} stacked on a leading layers dim,
``enc_norm`` and ``final_norm``. The reference scans the layers; here they
run in a Python loop over the stacked dim.

Training: ``loss`` is the reference's, and under grad (a param requires
it) with ``cfg.remat == "layer"`` each encoder layer and each decoder layer
is rematerialised (``torch.utils.checkpoint``, non-reentrant), as the
reference wraps both scans' bodies in ``jax.checkpoint``. The decoder
layer computes its cross K/V from the memory inside that body, so the
memory's gradient flows back into the encoder. Self-attention takes
``_FlashAttention`` (the kernel's forward, the plain backward); the
cross-attention stays plain autograd through ``attention_ref``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..sharding import (carry_rules, constrain, gather_fsdp, get_mesh,
                        layer_axes)
from . import blocks
from .common import check_gen, cross_entropy_loss, normal, param_dtype
from .lm import (_layer, _requires_grad, _unstack, compute_cast, stack_axes,
                 torch_dtype)

Pytree = Any


def sinusoidal(T: int, d: int, offset: int = 0,
               device: DeviceLike = "cpu") -> torch.Tensor:
    """[T, d] fp32 position table: the sines of all d/2 frequencies, then
    their cosines (not interleaved), positions from ``offset``."""
    pos = (torch.arange(T, device=device) + offset)[:, None].float()
    i = torch.arange(d // 2, device=device)[None, :].float()
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecLM:
    """Config-driven encoder-decoder. All state is explicit: params and
    caches are passed in and returned. ``attn_impl`` picks the attention
    of the encoder and of the decoder's full-sequence self-attention
    ("kernel": the CUDA flash kernel, its plain version on CPU tensors)."""

    def __init__(self, cfg: ArchConfig, attn_impl: str = "kernel",
                 device: DeviceLike = "cuda"):
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDecLM runs the encdec family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init_state(self) -> Dict[str, torch.Tensor]:
        """No state beside the params (``LM.init_state``'s empty case)."""
        return {}

    def init(self, gen: Optional[torch.Generator],
             dtype: Optional[torch.dtype] = None) -> Pytree:
        """Random params drawn from ``gen`` (on the model's device), with
        the reference's names and shapes; ``dtype`` and ``gen=None`` as in
        ``LM.init``."""
        check_gen(gen, self.device)
        cfg = self.cfg
        d, L, Le = cfg.d_model, cfg.n_layers, cfg.n_encoder_layers
        emb, unemb = (cfg.vocab, d), (d, cfg.vocab)
        return {
            "embed": normal(gen, emb, param_dtype(emb, dtype)).mul_(0.02),
            "unembed": normal(gen, unemb, param_dtype(unemb, dtype)).mul_(
                1.0 / math.sqrt(d)),
            "enc": {"attn": blocks.attn_init(gen, cfg, lead=(Le,),
                                             dtype=dtype),
                    "ffn": blocks.ffn_init(gen, cfg, lead=(Le,),
                                           dtype=dtype)},
            "dec": {"self": blocks.attn_init(gen, cfg, lead=(L,),
                                             dtype=dtype),
                    "cross": blocks.attn_init(gen, cfg, lead=(L,),
                                              dtype=dtype),
                    "ffn": blocks.ffn_init(gen, cfg, lead=(L,), dtype=dtype)},
            "enc_norm": blocks._norm_init(cfg, d, gen, dtype=dtype),
            "final_norm": blocks._norm_init(cfg, d, gen, dtype=dtype),
        }

    def param_axes(self) -> Pytree:
        """The logical axes of ``init``'s params, as the reference's."""
        cfg = self.cfg
        return {
            "embed": ("vocab", None), "unembed": ("embed", "vocab"),
            "enc": stack_axes({"attn": blocks.attn_axes(cfg),
                               "ffn": blocks.ffn_axes(cfg)}),
            "dec": stack_axes({"self": blocks.attn_axes(cfg),
                               "cross": blocks.attn_axes(cfg),
                               "ffn": blocks.ffn_axes(cfg)}),
            "enc_norm": blocks._norm_axes(cfg),
            "final_norm": blocks._norm_axes(cfg),
        }

    def init_with_axes(self, gen: Optional[torch.Generator],
                       dtype: Optional[torch.dtype] = None):
        return self.init(gen, dtype), self.param_axes()

    def _fsdp(self, p, key: str):
        """Under a mesh, the params of ``key`` ("enc" or "dec": one layer;
        "top": the final norm and unembedding) with their FSDP dims
        gathered (``sharding.gather_fsdp``); ``p`` itself otherwise."""
        if get_mesh() is None:
            return p
        axes = self._axes
        ax = (axes["layer"][key] if key in ("enc", "dec")
              else {k: axes[k] for k in p})
        return gather_fsdp(p, ax)

    @functools.cached_property
    def _axes(self) -> Pytree:
        """``param_axes()`` and, under "layer", one layer's of "enc" and
        "dec", reckoned once for ``_fsdp``."""
        axes = self.param_axes()
        return dict(axes, layer={k: layer_axes(axes[k])
                                 for k in ("enc", "dec")})

    def _compute_cast(self, params):
        return compute_cast(params, self.cfg.compute_dtype)

    def _remat(self, params) -> bool:
        return _requires_grad(params) and self.cfg.remat == "layer"

    # ------------------------------------------------------------- encoder
    def encode(self, params, src_embeds) -> torch.Tensor:
        """Frame embeddings [B, S, d] -> encoder memory [B, S, d]. The params
        go through the compute cast first (a no-op on cast params, which is
        what the reference is given)."""
        cfg = self.cfg
        params = self._compute_cast(params)
        dt = torch_dtype(cfg.compute_dtype)
        x = torch.as_tensor(src_embeds, device=self.device).to(dt)
        S, d = x.shape[1], x.shape[2]
        x = x + sinusoidal(S, d, device=self.device).to(dt)
        x = constrain(x, ("batch", "seq", None))
        positions = torch.arange(S, device=self.device)
        remat = self._remat(params)
        for lp in _unstack(params["enc"], cfg.n_encoder_layers):
            if remat:
                x = checkpoint(carry_rules(self._enc_layer), lp, x, positions,
                               use_reentrant=False)
            else:
                x = self._enc_layer(lp, x, positions)
        return blocks.apply_norm(cfg, params.get("enc_norm"), x)

    def _enc_layer(self, lp, x, positions):
        lp = self._fsdp(lp, "enc")
        x, _ = blocks.attn_apply(lp["attn"], x, cfg=self.cfg,
                                 positions=positions, causal=False,
                                 attn_impl=self.attn_impl)
        return blocks.ffn_apply(lp["ffn"], x, cfg=self.cfg)

    def _cross_kv(self, lp, memory):
        """One decoder layer's cross-attention k/v from the encoder memory,
        head-major [B, KH, S, hd]."""
        k = blocks.project(memory, lp["cross"]["wk"], "bsd,dhk->bshk", "kv")
        v = blocks.project(memory, lp["cross"]["wv"], "bsd,dhk->bshk", "kv")
        return k.transpose(1, 2), v.transpose(1, 2)

    # ------------------------------------------------------------- decoder
    def _decoder(self, params, tokens, memory, cache=None, pos: int = 0):
        """Logits [B, T, V] of ``tokens`` [B, T] at positions pos.. . With
        ``cache`` the self-attention K/V are written into it in place at
        pos (any T, as the reference's ``dynamic_update_slice``) and the
        cross K/V come from it; without, over the whole sequence against
        ``memory``."""
        cfg = self.cfg
        dt = torch_dtype(cfg.compute_dtype)
        tokens = torch.as_tensor(tokens, device=self.device).long()
        T = tokens.shape[1]
        x = blocks.embed(params["embed"], tokens).to(dt)
        x = x + sinusoidal(T, cfg.d_model, offset=pos,
                           device=self.device).to(dt)
        x = constrain(x, ("batch", "seq", None))
        positions = torch.arange(T, device=self.device) + pos
        remat = cache is None and self._remat(params)
        for i, lp in enumerate(_unstack(params["dec"], cfg.n_layers)):
            if remat:
                x = checkpoint(carry_rules(self._dec_layer), lp, x, positions,
                               memory,
                               use_reentrant=False)
            else:
                x = self._dec_layer(lp, x, positions, memory, cache, i, pos)
        top = self._fsdp({k: params.get(k) for k in
                          ("final_norm", "unembed")}, "top")
        x = blocks.apply_norm(cfg, top["final_norm"], x)
        logits = blocks.project(x, top["unembed"], "btd,dv->btv", "vocab")
        return constrain(logits, ("batch", "seq", "vocab")), cache

    def _dec_layer(self, lp, x, positions, memory, cache=None, i: int = 0,
                   pos: int = 0):
        """Decoder layer ``i``: over the whole sequence against ``memory``
        (its cross K/V computed here, as in the reference's scanned body),
        or with ``cache`` at pos."""
        cfg = self.cfg
        lp = self._fsdp(lp, "dec")
        if cache is None:
            x, _ = blocks.attn_apply(lp["self"], x, cfg=cfg,
                                     positions=positions, causal=True,
                                     attn_impl=self.attn_impl)
            kv = self._cross_kv(lp, memory)
        else:
            x, _ = blocks.attn_apply(lp["self"], x, cfg=cfg,
                                     positions=positions,
                                     cache=_layer(cache["self"], i),
                                     pos=pos, attn_impl=self.attn_impl)
            kv = (cache["cross_k"][i], cache["cross_v"][i])
        x, _ = blocks.attn_apply(lp["cross"], x, cfg=cfg,
                                 positions=positions, kv_memory=kv)
        return blocks.ffn_apply(lp["ffn"], x, cfg=cfg)

    # ------------------------------------------------------------- public
    def forward(self, params, batch):
        """batch: {"src_embeds": [B, S, d], "tokens": [B, T]}. Returns
        (logits [B, T, V], a zero aux loss)."""
        params = self._compute_cast(params)
        memory = self.encode(params, batch["src_embeds"])
        logits, _ = self._decoder(params, batch["tokens"], memory)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=self.device)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE over ``batch["labels"] != -100``, as the
        reference's (no aux term)."""
        logits, _ = self.forward(params, batch)
        # under a mesh the vocab is gathered first: the labels' gather
        # along a sharded dim has no DTensor strategy
        logits = constrain(logits, ("batch", "seq", None))
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        return cross_entropy_loss(logits, labels)

    def decode_cache_init(self, batch: int, max_len: int,
                          memory: Optional[torch.Tensor] = None,
                          params=None) -> Pytree:
        """{"self": {"k", "v"} [L, B, KH, max_len, hd] zeros, "cross_k",
        "cross_v" [L, B, KH, S, hd]}: each decoder layer's cross K/V of
        ``memory`` (with its ``params``), or zeros of S = 1 without it; all
        in ``kv_cache_dtype``."""
        cfg = self.cfg
        dt = torch_dtype(cfg.kv_cache_dtype)
        L, KH, hd = cfg.n_layers, cfg.kv_heads, cfg.resolved_head_dim

        def zeros(n):
            return torch.zeros((L, batch, KH, n, hd), dtype=dt,
                               device=self.device)
        self_c = {"k": zeros(max_len), "v": zeros(max_len)}
        if memory is None:
            return {"self": self_c, "cross_k": zeros(1), "cross_v": zeros(1)}
        params = self._compute_cast(params)
        kvs = [self._cross_kv(lp, memory)
               for lp in _unstack(params["dec"], L)]
        return {"self": self_c,
                "cross_k": torch.stack([k.to(dt) for k, _ in kvs]),
                "cross_v": torch.stack([v.to(dt) for _, v in kvs])}

    def decode_step(self, params, batch, cache, pos: int):
        """Decoder tokens ``batch["tokens"]`` [B, T] at positions pos..
        (T = 1 a step; a prompt of T > 1 in one call at pos = 0). Returns
        (logits [B, T, V], cache): the self cache is written in place."""
        params = self._compute_cast(params)
        return self._decoder(params, batch["tokens"], None, cache=cache,
                             pos=int(pos))
