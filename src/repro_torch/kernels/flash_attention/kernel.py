"""Launcher of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

The kernel replaces the Pallas TPU kernel ``flash_attention_kernel``
(``repro/kernels/flash_attention/kernel.py``); the source note in the
``.cu`` file says what bounds it on the H100 and how its design deals with
that. ``ops.flash_attention`` is the wrapper that pads, dispatches and
counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_attention_fwd": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                             _I, _I, _I, _I, _I, _P], _I),
}
D_MAX = 128            # csrc/flash_attention.cu D_MAX


def _lib():
    return _build.load("flash_attention", _SIGNATURES)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is on {t.device}"
                             f", not a CUDA device")
        if t.dim() != 4:
            raise ValueError(f"flash_attention kernel: {name} must be 4-D, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be "
                             f"contiguous")
        if t.dtype != q.dtype:
            raise TypeError("flash_attention kernel: q, k, v dtypes differ "
                            f"({q.dtype}, {k.dtype}, {v.dtype})")
        if t.device != q.device:
            raise ValueError("flash_attention kernel: q, k, v on different "
                             "devices")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel: dtype {q.dtype} not "
                        f"supported (float32, bfloat16)")
    B, H, _, D = q.shape
    Bk, KH, Tk, Dk = k.shape
    if v.shape[-1] != Dk:
        raise ValueError(f"flash_attention kernel: Dv ({v.shape[-1]}) must "
                         f"equal Dk ({Dk})")
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)} differ")
    if KH < 1 or H % KH:
        raise ValueError(f"flash_attention kernel: H ({H}) must be a "
                         f"multiple of KH ({KH})")
    if D > D_MAX:
        raise ValueError(f"flash_attention kernel: head dim {D} over the "
                         f"kernel's limit {D_MAX}")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           window: Optional[int] = None,
                           scale: Optional[float] = None, q_offset: int = 0,
                           kv_len: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel. q: [B, H, Tq, D]; k, v: [B, KH, Tk, D], all
    contiguous CUDA tensors of one dtype (float32 or bfloat16).
    ``kv_len``: true (unpadded) key count. Returns [B, H, Tq, D]."""
    check_kernel_inputs(q, k, v)
    B, H, Tq, D = q.shape
    KH, Tk = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    if kv_len is None:
        kv_len = Tk
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, H, KH, Tq, Tk, D, float(scale), int(causal),
            int(window is not None), int(window or 0), int(q_offset),
            int(kv_len), stream)
    _build.check(lib, err, "flash_attention_fwd")
    return out

