"""Launcher of the hand-written CUDA paged decode-attention kernel
(``csrc/paged_attention.cu``).

The kernel replaces the Pallas TPU kernel ``paged_attention_kernel``
(``repro/kernels/paged_attention/kernel.py``): it reads K/V in place from the
page pool through the block tables, without gathering them into a dense
buffer. The source note in the ``.cu`` file says what bounds it on the H100
and how its design deals with that. ``ops.paged_attention`` is the wrapper
that dispatches and counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "paged_attention_fwd": ([_I] + [_P] * 8 + [_I] * 8 + [_F, _P], _I),
}
GD_MAX = 1024                  # csrc/paged_attention.cu GD_MAX (G * D)
SPLITS_MAX = 64                # csrc/paged_attention.cu SPLITS_MAX
SMEM_MAX = 232448              # bytes of shared memory one block may use
BLOCKS_PER_SM = 2              # split target: about this many blocks per SM


def smem_bytes(G: int, D: int, page: int, elem: int, stages: int = 2) -> int:
    """Shared memory of one split block (csrc/paged_attention.cu
    smem_bytes): ``stages`` copies of a page's K and V rows in the input
    type, then fp32 scratch."""
    return 2 * stages * page * D * elem + 4 * (G * D + G * page + 3 * G)


def split_plan(B: int, KH: int, max_pages: int, num_sms: int):
    """(splits, pages_per_split): about BLOCKS_PER_SM blocks per SM over the
    (sequence, kv head, split) grid, with no split left without a table
    entry."""
    want = -(-BLOCKS_PER_SM * num_sms // max(B * KH, 1))
    splits = max(1, min(want, max_pages, SPLITS_MAX))
    pages_per_split = -(-max_pages // splits) if max_pages else 1
    splits = max(1, -(-max_pages // pages_per_split))
    return splits, pages_per_split


def _lib():
    return _build.load("paged_attention", _SIGNATURES)


def check_kernel_inputs(q: torch.Tensor, kv_pages: torch.Tensor,
                        block_tables: torch.Tensor,
                        lengths: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    for name, t in (("q", q), ("kv_pages", kv_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_cuda:
            raise ValueError(f"paged_attention kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError("paged_attention kernel: inputs on different "
                             "devices")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel: {name} must be "
                             f"contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_attention kernel: dtype {q.dtype} not "
                        f"supported (float32, bfloat16)")
    if kv_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention kernel: q is {q.dtype} but "
                        f"kv_pages is {kv_pages.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention kernel: block_tables and lengths "
                        "must be int32")
    if q.dim() != 3 or kv_pages.dim() != 5 or kv_pages.shape[2] != 2:
        raise ValueError(f"paged_attention kernel: q {tuple(q.shape)} must be"
                         f" [B, H, D] and kv_pages {tuple(kv_pages.shape)} "
                         f"[P, page, 2, KH, D]")
    B, H, D = q.shape
    P, page, _, KH, Dk = kv_pages.shape
    if Dk != D:
        raise ValueError(f"paged_attention kernel: head dims differ "
                         f"(q {D}, kv {Dk})")
    if H % KH:
        raise ValueError(f"paged_attention kernel: H ({H}) must be a "
                         f"multiple of KH ({KH})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"paged_attention kernel: block_tables "
                         f"{tuple(block_tables.shape)} must be [B, max_pages]"
                         f" and lengths {tuple(lengths.shape)} [B], B={B}")
    G = H // KH
    if G * D > GD_MAX:
        raise ValueError(f"paged_attention kernel: G*D = {G * D} over the "
                         f"kernel's limit {GD_MAX}")
    elem = kv_pages.element_size()
    if (D * elem) % 16 or kv_pages.data_ptr() % 16:
        raise ValueError(f"paged_attention kernel: K/V rows must be whole "
                         f"16-byte chunks on a 16-byte boundary (D={D}, "
                         f"{elem}-byte elements)")
    need = smem_bytes(G, D, page, elem)     # double-buffered, the larger case
    if need > SMEM_MAX:
        raise ValueError(f"paged_attention kernel: page {page} x D {D} needs "
                         f"{need} bytes of shared memory, over {SMEM_MAX}")


def paged_attention_kernel(q: torch.Tensor, kv_pages: torch.Tensor,
                           block_tables: torch.Tensor, lengths: torch.Tensor,
                           *, scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel. q: [B, H, D]; kv_pages: [P, page, 2, KH, D]
    of q's dtype; block_tables: [B, max_pages] int32; lengths: [B] int32;
    all contiguous on one CUDA device. Returns [B, H, D]."""
    check_kernel_inputs(q, kv_pages, block_tables, lengths)
    B, H, D = q.shape
    page, KH = kv_pages.shape[1], kv_pages.shape[3]
    G, max_pages = H // KH, block_tables.shape[1]
    if scale is None:
        scale = D ** -0.5
    num_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits, pages_per_split = split_plan(B, KH, max_pages, num_sms)
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((B, KH, splits, G), **f32)
    part_l = torch.empty((B, KH, splits, G), **f32)
    part_acc = torch.empty((B, KH, splits, G, D), **f32)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.paged_attention_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), kv_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            B, H, KH, D, page, max_pages, splits, pages_per_split,
            float(scale), stream)
    _build.check(lib, err, "paged_attention_fwd")
    return out
