"""Launcher of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention.cu``).

The kernels replace the Pallas TPU kernel ``flash_attention_kernel``
(``repro/kernels/flash_attention/kernel.py``); the source note in the
``.cu`` file says what bounds them on the H100 and how their design deals
with that. Two routes, chosen by ``kernel_route`` from dtype and head dim
alone, never on failure:

- ``"wgmma"``: bf16 with D % 8 == 0 and Dv % 8 == 0. Tensor-core products (``wgmma``), tiles
  staged by TMA through a two-stage ring of mbarriers, a producer
  warpgroup and two consumer warpgroups that take turns on the tensor
  cores; persistent, one block per SM. ``wgmma_tiles`` reads its tiles
  from the library.
- ``"scalar"``: fp32 (whose 3e-5 tolerance rules out TF32), or a head dim
  that is no multiple of 8 (TMA needs 16-byte strides). Scalar fp32 FMAs
  over 64 x 64 tiles.

v's head dim Dv may differ from q's and k's D (MLA: D = 192, Dv = 128 at
deepseek-v2-lite-16b's width); the output is [B, H, Tq, Dv].

Both routes write each row's log-sum-exp of the scaled scores (``lse``,
[B, H, Tq] fp32; +inf for a row with no live key) when asked to, for the
training path's backward; without it they write the output alone, with the
same bits.

``ops.flash_attention`` is the wrapper that dispatches and counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_attention_fwd": ([_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _F, _I, _I, _I, _I, _I, _P], _I),
    "flash_attention_fwd_wgmma": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _I, _I, _I, _I, _P], _I),
    "flash_attention_wgmma_tiles": ([_I, _I, _P, _P, _P, _P], _I),
}
D_MAX = 256            # csrc/flash_attention.cu D_MAX
ROUTES = ("wgmma", "scalar")


def kernel_route(dtype: torch.dtype, head_dim: int,
                 v_head_dim: Optional[int] = None) -> str:
    """The kernel a launch takes: ``"wgmma"`` for bf16 with head dims (q's
    and k's, and v's, which defaults to theirs) that are multiples of 8,
    ``"scalar"`` otherwise."""
    dv = head_dim if v_head_dim is None else v_head_dim
    return "wgmma" if dtype == torch.bfloat16 and head_dim % 8 == 0 \
        and dv % 8 == 0 else "scalar"


def wgmma_tiles(head_dim: int, v_head_dim: Optional[int] = None) -> dict:
    """The wgmma route's tiles at ``head_dim`` (q, k) and ``v_head_dim`` (v
    and the output; default ``head_dim``), as the built library chooses
    them: each tile's head dim (rounded up, zero-filled past the tensor's),
    query rows and keys per tile."""
    out = [ctypes.c_int() for _ in range(4)]
    _lib().flash_attention_wgmma_tiles(
        head_dim, head_dim if v_head_dim is None else v_head_dim,
        *map(ctypes.byref, out))
    return dict(zip(("head_dim_tile", "v_head_dim_tile", "block_q",
                     "block_k"), (x.value for x in out)))


def _lib():
    return _build.load("flash_attention", _SIGNATURES)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise on anything the CUDA kernels do not take."""
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
    Dv = v.shape[-1]
    if tuple(v.shape[:3]) != tuple(k.shape[:3]) or Bk != B or Dk != D:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)} differ")
    if KH < 1 or H % KH:
        raise ValueError(f"flash_attention kernel: H ({H}) must be a "
                         f"multiple of KH ({KH})")
    if D > D_MAX or Dv > D_MAX:
        raise ValueError(f"flash_attention kernel: head dims {D}, {Dv} over "
                         f"the kernel's limit {D_MAX}")
    if kernel_route(q.dtype, D, Dv) == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention kernel: {name} must start "
                                 f"on a 16-byte boundary for TMA")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           window: Optional[int] = None,
                           scale: Optional[float] = None, q_offset: int = 0,
                           kv_len: Optional[int] = None,
                           return_lse: bool = False
                           ) -> Union[torch.Tensor,
                                      Tuple[torch.Tensor, torch.Tensor]]:
    """Launch the kernel of ``kernel_route(q.dtype, D, Dv)``. q: [B, H, Tq,
    D]; k: [B, KH, Tk, D]; v: [B, KH, Tk, Dv], all contiguous CUDA tensors
    of one dtype (float32 or bfloat16). ``kv_len``: keys at or past it are
    masked (default Tk). ``scale`` defaults to D^-0.5. Returns [B, H, Tq,
    Dv], and with ``return_lse`` also the rows' lse [B, H, Tq] in fp32 (one
    launch either way)."""
    check_kernel_inputs(q, k, v)
    B, H, Tq, D = q.shape
    KH, Tk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if scale is None:
        scale = D ** -0.5
    if kv_len is None:
        kv_len = Tk
    out = torch.empty((B, H, Tq, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, B, H, KH, Tq, Tk, D, Dv,
            float(scale), int(causal), int(window is not None),
            int(window or 0), int(q_offset), int(kv_len), stream)
    with torch.cuda.device(q.device):
        if kernel_route(q.dtype, D, Dv) == "wgmma":
            err = lib.flash_attention_fwd_wgmma(*args)
            what = "flash_attention_fwd_wgmma"
        else:
            err = lib.flash_attention_fwd(_DTYPE_CODE[q.dtype], *args)
            what = "flash_attention_fwd"
    _build.check(lib, err, what)
    return (out, lse) if return_lse else out
