"""Per-layer blocks of the dense decoder: GQA attention (with qwen3's
qk_norm) and the SwiGLU FFN.

Every ``*_init`` builds the params of all layers at once, stacked on a
leading ``layers`` dim (``lead``), with the JAX reference's names and
layouts. Every ``*_apply`` takes one layer's params. ``attn_apply`` handles
both full-sequence (prefill) and single-token decode (``cache`` + ``pos``)
modes.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_ref
from .common import (apply_rope, dense_init, layer_norm, normal, rms_norm,
                     silu)


def _norm_init(cfg: ArchConfig, d: int, gen: torch.Generator,
               lead: Tuple[int, ...] = ()) -> Optional[torch.Tensor]:
    if cfg.norm == "nonparam_ln":
        return None
    return torch.ones((*lead, d), device=gen.device)


def apply_norm(cfg: ArchConfig, w, x):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, w)
    if cfg.norm == "layernorm":
        return layer_norm(x, w)
    if cfg.norm == "nonparam_ln":
        return layer_norm(x, None)
    raise ValueError(cfg.norm)


# ---------------------------------------------------------------------------
# GQA attention (dense / qwen3 qk_norm)
# ---------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg: ArchConfig,
              lead: Tuple[int, ...] = ()) -> Dict:
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, (H, hd), lead=lead),
        "wk": dense_init(gen, d, (KH, hd), lead=lead),
        "wv": dense_init(gen, d, (KH, hd), lead=lead),
        "wo": normal(gen, (*lead, H, hd, d)) * (1.0 / math.sqrt(H * hd)),
        "norm": _norm_init(cfg, d, gen, lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), device=gen.device)
        p["k_norm"] = torch.ones((*lead, hd), device=gen.device)
    return p


def _rope_qk(cfg: ArchConfig, q, k, positions):
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope != "none":
        raise NotImplementedError(f"rope {cfg.rope!r} is not ported yet")
    return q, k


def attn_apply(p, x, *, cfg: ArchConfig, positions, causal: bool = True,
               cache: Optional[Dict] = None, pos: Optional[int] = None,
               attn_impl: str = "kernel"):
    """x: [B, T, d]. Full mode when cache is None; decode otherwise.

    In decode mode the new k/v are written into ``cache`` in place (the
    reference returns an updated copy); the returned cache is the same
    dict."""
    h = apply_norm(cfg, p.get("norm"), x)
    q = torch.einsum("btd,dhk->bthk", h, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    k = torch.einsum("btd,dhk->bthk", h, p["wk"])
    v = torch.einsum("btd,dhk->bthk", h, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    q, k = _rope_qk(cfg, q, k, positions)
    qh = q.transpose(1, 2)                      # [B, H, T, hd]
    kh = k.transpose(1, 2)                      # [B, KH, Tk, hd]
    vh = v.transpose(1, 2)
    new_cache = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]          # [B, KH, Tmax, hd]
        T, Tmax = kh.shape[2], ck.shape[2]
        start = min(max(int(pos), 0), Tmax - T)  # dynamic_update_slice clamp
        ck[:, :, start:start + T] = kh.to(ck.dtype)
        cv[:, :, start:start + T] = vh.to(cv.dtype)
        new_cache = cache
        o = attention_ref(qh, ck.to(qh.dtype), cv.to(qh.dtype),
                          causal=True, window=cfg.window, q_offset=int(pos))
    else:
        # the kernel takes contiguous head-major tensors
        o = flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                            causal=causal, window=cfg.window, impl=attn_impl,
                            block_k=cfg.attn_block_k, p_bf16=cfg.attn_p_bf16)
    o = o.transpose(1, 2)                        # [B, T, H, hd]
    y = torch.einsum("bthk,hkd->btd", o, p["wo"])
    return x + y, new_cache


def attn_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype,
                    device) -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    shape = (batch, cfg.kv_heads, max_len, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_prefill_kv(p, x, *, cfg: ArchConfig, positions):
    """This layer's k/v for a prompt (to seed the decode cache), head-major
    [B, KH, T, hd]."""
    h = apply_norm(cfg, p.get("norm"), x)
    k = torch.einsum("btd,dhk->bthk", h, p["wk"])
    v = torch.einsum("btd,dhk->bthk", h, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    if cfg.rope == "rope":
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope != "none":
        raise NotImplementedError(f"rope {cfg.rope!r} is not ported yet")
    return k.transpose(1, 2), v.transpose(1, 2)


def pack_prefill_cache(cfg: ArchConfig, kv, max_len: int, dtype):
    """Arrange prompt k/v [B, KH, T, hd] into a dense decode cache of
    ``max_len`` slots (zero-padded, or cut). The sliding-window ring buffer
    is not ported yet."""
    if cfg.window:
        raise NotImplementedError("sliding-window decode caches are not "
                                  "ported yet")
    k, v = kv
    pad = max_len - k.shape[2]
    if pad > 0:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    elif pad < 0:
        k, v = k[:, :, :max_len], v[:, :, :max_len]
    return {"k": k.to(dtype), "v": v.to(dtype)}


# ---------------------------------------------------------------------------
# FFN (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
def ffn_init(gen: torch.Generator, cfg: ArchConfig,
             d_ff: Optional[int] = None, lead: Tuple[int, ...] = ()) -> Dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w1": dense_init(gen, d, f, lead=lead),
        "w3": dense_init(gen, d, f, lead=lead),
        "w2": dense_init(gen, f, d, lead=lead),
        "norm": _norm_init(cfg, d, gen, lead),
    }


def ffn_apply(p, x, *, cfg: ArchConfig, act: str = "silu"):
    h = apply_norm(cfg, p.get("norm"), x)
    g = torch.einsum("btd,df->btf", h, p["w1"])
    u = torch.einsum("btd,df->btf", h, p["w3"])
    # jax.nn.gelu defaults to the tanh approximation
    g = silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    y = torch.einsum("btf,fd->btd", g * u, p["w2"])
    return x + y
