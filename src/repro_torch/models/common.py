"""Shared model building blocks: norms, activations, RoPE, init helpers,
and an einsum that promotes mixed operand types as ``jnp.einsum`` does.

Params are plain nested dicts of tensors with the JAX reference's names and
layouts, so the bridge to and from the reference is a map over names.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..sharding import is_sharded, replicated_like, sharded_einsum

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
    return normal(gen, (*lead, in_dim, *out_dims), dtype).mul_(scale)


META = torch.device("meta")


def gen_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where a draw from ``gen`` lands: the generator's device, or ``meta``
    for ``gen=None`` (an init on the meta device: shapes and dtypes, no
    memory, the registry's specs and counts)."""
    return META if gen is None else gen.device


def check_gen(gen: Optional[torch.Generator], device: torch.device) -> None:
    """A model's ``init`` draws from a generator on its own device; only a
    model on ``meta`` takes none."""
    if gen_device(gen).type != device.type:
        raise ValueError(f"generator on {gen_device(gen)}, model on {device}")


def normal(gen: Optional[torch.Generator], shape,
           dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen_device(gen))


def param_dtype(shape, dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The type a param leaf of ``shape`` is drawn in: ``dtype`` where the
    leaf has rank >= 2 (the leaves the compute cast converts), else fp32.
    ``dtype=None`` draws every leaf in fp32."""
    return dtype if dtype is not None and len(shape) >= 2 else torch.float32


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


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a Python scalar (a weak
    type) to the array's dtype before the op. Torch would keep the scalar
    in fp32 for a bf16 op and round only the result."""
    return torch.tensor(value, dtype=torch.float32).to(dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU as the reference spells ``jax.nn.gelu`` (the tanh form), each op
    rounded to x's dtype, its constants too:
    x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3)))), with x**3
    as ``lax.integer_pow`` computes it, x * (x * x). ``F.gelu`` rounds once
    and differs in bf16."""
    cube = x * (x * x)
    inner = _const(math.sqrt(2 / math.pi), x.dtype) * (
        x + _const(0.044715, x.dtype) * cube)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Softplus as the reference computes ``jax.nn.softplus``
    (``logaddexp(x, 0)``): max(x, 0) + log1p(exp(-|x|)), each op rounded to
    x's dtype. ``F.softplus`` rounds once and differs in bf16."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with ``jnp.einsum``'s promotion: operands of two
    float types meet in the wider one (bf16 x fp32 -> fp32, the bf16 side
    widened exactly). ``torch.einsum`` raises on mixed types. Under a
    mesh, on DTensors: ``sharding.sharded_einsum``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if is_sharded(a) or is_sharded(b):
        return sharded_einsum(eq, a.to(dt), b.to(dt))
    return torch.einsum(eq, a.to(dt), b.to(dt))


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def yarn_correction_dim(rotations: float, dim: int, theta: float,
                        original: int) -> float:
    """The rope dim whose wavelength turns ``rotations`` times over the
    ``original`` context: d ln(L0 / (2 pi rotations)) / (2 ln theta)."""
    return (dim * math.log(original / (rotations * 2 * math.pi))
            / (2 * math.log(theta)))


def yarn_range(dim: int, theta: float, original: int, beta_fast: float,
               beta_slow: float) -> Tuple[int, int]:
    """YaRN's ramp (low, high): floor of beta_fast's correction dim, at
    least 0, and ceil of beta_slow's, at most dim - 1."""
    low = math.floor(yarn_correction_dim(beta_fast, dim, theta, original))
    high = math.ceil(yarn_correction_dim(beta_slow, dim, theta, original))
    return max(low, 0), min(high, dim - 1)


def yarn_mscale(factor: float, mscale: float) -> float:
    """0.1 mscale ln(factor) + 1, or 1 at ``factor`` <= 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_freqs(dim: int, theta: float, factor: float, original: int,
               beta_fast: float, beta_slow: float,
               device=None) -> torch.Tensor:
    """YaRN's inverse frequencies [dim/2], as DeepSeek's
    ``DeepseekV3YarnRotaryEmbedding`` computes them: the plain ones below
    the ramp's ``low``, the ones divided by ``factor`` from its ``high``
    on, a linear blend between."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (factor * theta ** exps)
    low, high = yarn_range(dim, theta, original, beta_fast, beta_slow)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp                          # the extrapolated share
    return inter * (1 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, freqs: Optional[torch.Tensor] = None,
               mscale: float = 1.0) -> torch.Tensor:
    """x: [..., T, H, D]; positions: broadcastable to [..., T]. ``freqs``:
    the D/2 inverse frequencies (default: plain RoPE's of ``theta``);
    ``mscale``: a factor on cos and sin (YaRN's; 1 leaves them as they
    are)."""
    D = x.shape[-1]
    if freqs is None:
        freqs = rope_freqs(D, theta, device=x.device)          # [D/2]
    positions = replicated_like(positions, x)
    angles = positions[..., None].float() * freqs              # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]                      # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Optional[Tuple[int, int, int]] = None,
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL M-RoPE. x: [..., T, H, D]; positions: [..., 3, T] (t, h, w).
    The D/2 rotary frequencies are split into three sections, by default
    (D/2 - 2 floor(D/6), floor(D/6), floor(D/6)), and each frequency turns
    by its section's coordinate. Angles and rotation in fp32, cast back."""
    D = x.shape[-1]
    if sections is None:
        d6 = D // 2 // 3
        sections = (D // 2 - 2 * d6, d6, d6)
    freqs = rope_freqs(D, theta, device=x.device)              # [D/2]
    positions = replicated_like(positions, x)
    sec = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=sum(sections))                             # [D/2]
    coords = positions.float().movedim(-2, 0)                  # [3, ..., T]
    per_freq = coords[sec].movedim(0, -1)                      # [..., T, D/2]
    angles = per_freq * freqs
    cos = torch.cos(angles)[..., None, :]                      # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Mean CE over valid positions (``labels != ignore_index``), from
    fp32-upcast logits [..., V], as the reference's."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
    valid = labels != ignore_index
    nll = (lse - ll) * valid
    return nll.sum() / valid.sum().clamp_min(1)
