"""Shared model building blocks: norms, RoPE, init helpers.

Params are plain nested dicts of tensors with the JAX reference's names and
layouts, so the bridge to and from the reference is a map over names.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

Params = Dict[str, Any]


def dense_init(gen: torch.Generator, in_dim: int,
               out_dims: Union[int, Tuple[int, ...]], *,
               lead: Tuple[int, ...] = (), dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """He/Glorot-ish init for a [*lead, in_dim, *out_dims] weight, drawn
    from ``gen`` on the generator's device. ``lead`` is the stacked-layer
    dim(s)."""
    if isinstance(out_dims, int):
        out_dims = (out_dims,)
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    return normal(gen, (*lead, in_dim, *out_dims), dtype) * scale


def normal(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if weight is not None:
        x = x * weight.float()
    return x.to(dt)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Non-parametric when weight/bias are None (OLMo: non-parametric LN)."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * weight.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU as the reference spells it (``jax.nn.silu``): x * (1 / (1 +
    exp(-x))), each op rounded to x's dtype. In bf16 this is what the
    reference computes; ``F.silu`` rounds once and differs by an ulp."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid as the reference computes ``jax.nn.sigmoid`` (``lax.logistic``)
    in bf16: 1 / (1 + exp(-x)), each op rounded to x's dtype.
    ``torch.sigmoid`` rounds once and differs by an ulp."""
    return 1.0 / (1.0 + torch.exp(-x))


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., T, H, D]; positions: broadcastable to [..., T]."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, device=x.device)              # [D/2]
    angles = positions[..., None].float() * freqs              # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]                      # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
