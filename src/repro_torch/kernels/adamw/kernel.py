"""Launcher of the hand-written CUDA AdamW kernel (``csrc/adamw.cu``).

The kernel replaces no TPU kernel: the JAX package's update is plain jnp
that XLA fuses. The source note in the ``.cu`` file says what bounds it on
the H100 and how its design deals with that. Two routes, chosen by
``kernel_route`` from the tensors' addresses alone, never on failure:

- ``"vector"``: p, m, v and g (unless g is a broadcast scalar) start on
  16-byte boundaries: 8 elements a thread an iteration with 16-byte loads
  and stores, the last ``n % 8`` one by one in the same launch.
- ``"scalar"``: any of them does not: one element a thread an iteration.

``ops.adamw`` is the wrapper that dispatches and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "adamw_step": ([_I] * 4 + [_P] * 4 + [ctypes.c_longlong, _I, _I, _P, _P]
                   + [_F] * 7 + [_P], _I),
}
ROUTES = ("vector", "scalar")


def _lib():
    return _build.load("adamw", _SIGNATURES)


def is_broadcast(g: torch.Tensor) -> bool:
    """Whether every element of ``g`` is the one at its data pointer (each
    dim of more than one element has stride 0): an unused leaf's zero
    gradient, one scalar expanded to the leaf's shape."""
    return all(st == 0 or n == 1 for n, st in zip(g.shape, g.stride()))


def kernel_route(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor) -> str:
    """``"vector"`` when p, m, v and (unless it is a broadcast scalar) g
    start on a 16-byte boundary, ``"scalar"`` otherwise."""
    ptrs = [p.data_ptr(), m.data_ptr(), v.data_ptr()]
    if not is_broadcast(g):
        ptrs.append(g.data_ptr())
    return "vector" if all(a % 16 == 0 for a in ptrs) else "scalar"


def check_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor) -> None:
    """Raise on a leaf the kernel does not take: p float32 or bfloat16; g
    float32 or bfloat16; m and v one dtype of those two; every tensor of
    p's shape and on p's device; p, m, v contiguous, g contiguous or a
    broadcast scalar."""
    named = (("param", p), ("gradient", g), ("m", m), ("v", v))
    for name, t in named:
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"adamw kernel: {name} is {t.dtype}, not float32 "
                            f"or bfloat16")
    if m.dtype != v.dtype:
        raise TypeError(f"adamw kernel: m is {m.dtype}, v {v.dtype}")
    for name, t in named[1:]:
        if t.device != p.device:
            raise ValueError(f"adamw kernel: {name} is on {t.device}, the "
                             f"param on {p.device}")
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"adamw kernel: {name} {tuple(t.shape)} is not "
                             f"the param's {tuple(p.shape)}")
    for name, t in named:
        if not t.is_contiguous() and not (t is g and is_broadcast(g)):
            raise ValueError(f"adamw kernel: {name} must be contiguous"
                             + (" or a broadcast scalar" if t is g else ""))


def adamw_kernel(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor, *,
                 lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float) -> str:
    """Launch the CUDA kernel once: p, m and v take their new values in
    place. bc1, bc2: 0-d fp32 tensors on p's device holding 1 - b1**t and
    1 - b2**t. Weight decay where p has rank >= 2. Returns the route."""
    check_leaf(p, g, m, v)
    if not p.is_cuda:
        raise ValueError(f"adamw kernel: the param is on {p.device}, not a "
                         f"CUDA device")
    for name, b in (("bc1", bc1), ("bc2", bc2)):
        if b.dtype != torch.float32 or b.numel() != 1 or b.device != p.device:
            raise ValueError(f"adamw kernel: {name} must be one float32 on "
                             f"{p.device}, not {b.dtype} {tuple(b.shape)} "
                             f"on {b.device}")
    route = kernel_route(p, g, m, v)
    lib = _lib()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        err = lib.adamw_step(
            _DTYPE_CODE[p.dtype], _DTYPE_CODE[g.dtype], _DTYPE_CODE[m.dtype],
            int(route == "vector"), p.data_ptr(), g.data_ptr(), m.data_ptr(),
            v.data_ptr(), p.numel(), int(is_broadcast(g)), int(p.dim() >= 2),
            bc1.data_ptr(), bc2.data_ptr(), lr, b1, b2, 1 - b1, 1 - b2, eps,
            weight_decay, stream)
    _build.check(lib, err, "adamw_step")
    return route
