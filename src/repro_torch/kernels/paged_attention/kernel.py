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
import functools
from typing import Callable, Optional

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's route for each pool dtype: fp32 FMAs, or mma.sync in bf16
ROUTES = {torch.float32: "fp32", torch.bfloat16: "bf16"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "paged_attention_fwd": ([_I] + [_P] * 5 + [_I] * 8 + [_F, _P], _I),
    "paged_attention_capacity": ([_I] * 5 + [_P], _I),
    "paged_attention_smem": ([_I] * 3 + [_P], _I),
}
# csrc/paged_attention.cu's limits and the chunk of keys a ring stage holds
G_MAX = 16                     # query heads a kv head
D_MAX = 256                    # head dim
SPLITS_MAX = 8                 # blocks of a cluster (the portable size)
CHUNK = {4: 32, 2: 64}         # keys a stage, by element size
WAVES = 2.5                    # split plan, many pairs: waves of blocks
MIN_CHUNKS_PER_BLOCK = 3       # split plan, few pairs: one wave of such blocks
GRID_DIM_MAX = 65535           # B (grid z) and KH (grid x), as checked in C
KEYS_MAX = 1 << 30             # max_pages * page


def split_plan(B: int, KH: int, max_pages: int, page: int, elem: int,
               capacity: Callable[[int], int]):
    """(splits, chunks_per_split): ``splits`` blocks, one cluster, share a
    (sequence, kv head) and take its live chunks of keys in turn, so a block
    walks at most ``chunks_per_split`` (the widest table's share) and a
    shorter sequence less. ``capacity(s)`` is how many blocks in clusters of
    ``s`` the card runs at once. Measured on the H100 (PERF.md): with
    many (sequence, kv head) pairs, about WAVES waves of blocks even out
    ragged lengths; with few, one wave of blocks of at least
    MIN_CHUNKS_PER_BLOCK chunks each is fastest (a block that waits for a
    second wave costs a whole block's time)."""
    chunks = -(-max_pages * page // CHUNK[elem])
    pairs = max(B * KH, 1)
    top = max(1, min(SPLITS_MAX, chunks))
    if 2 * pairs > capacity(1):
        splits = int(WAVES * capacity(1) // pairs)
    else:
        splits = max([s for s in range(1, top + 1) if pairs * s <= capacity(s)],
                     default=1)
        splits = min(splits, -(-chunks // MIN_CHUNKS_PER_BLOCK))
    splits = max(1, min(splits, top))
    return splits, max(1, -(-chunks // splits))


@functools.lru_cache(maxsize=None)
def _capacity(device: int, dtype_code: int, G: int, D: int, splits: int) -> int:
    """Blocks in clusters of ``splits`` that the card runs at once for this
    geometry (the occupancy API, through the library)."""
    lib = _lib()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.paged_attention_capacity(dtype_code, G, 1, D, splits,
                                           ctypes.byref(n))
    _build.check(lib, err, "paged_attention_capacity")
    return n.value * splits


def _lib():
    return _build.load("paged_attention", _SIGNATURES)


def smem_bytes(dtype: torch.dtype, G: int, D: int) -> int:
    """Dynamic shared memory one block takes for a group of G query heads
    of D (the library's own count, the one its launch passes); raises past
    the kernel's limits."""
    lib = _lib()
    n = ctypes.c_int(0)
    _build.check(lib, lib.paged_attention_smem(_DTYPE_CODE[dtype], G, D,
                                               ctypes.byref(n)),
                 "paged_attention_smem")
    return n.value


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
    if G > G_MAX or D > D_MAX:
        raise ValueError(f"paged_attention kernel: a group of {G} query heads"
                         f" of {D} is past the kernel's limits ({G_MAX} heads"
                         f" of at most {D_MAX})")
    if B > GRID_DIM_MAX or KH > GRID_DIM_MAX:
        raise ValueError(f"paged_attention kernel: B ({B}) and KH ({KH}) "
                         f"must be at most {GRID_DIM_MAX}")
    if block_tables.shape[1] * page > KEYS_MAX:
        raise ValueError(f"paged_attention kernel: a table of "
                         f"{block_tables.shape[1]} pages of {page} is over "
                         f"{KEYS_MAX} keys")
    elem = kv_pages.element_size()
    if (D * elem) % 16 or kv_pages.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"paged_attention kernel: K/V rows must be whole "
                         f"16-byte chunks on a 16-byte boundary (D={D}, "
                         f"{elem}-byte elements)")


def paged_attention_kernel(q: torch.Tensor, kv_pages: torch.Tensor,
                           block_tables: torch.Tensor, lengths: torch.Tensor,
                           *, scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel, once. q: [B, H, D]; kv_pages: [P, page, 2,
    KH, D] of q's dtype; block_tables: [B, max_pages] int32; lengths: [B]
    int32; all contiguous on one CUDA device. Returns [B, H, D]."""
    check_kernel_inputs(q, kv_pages, block_tables, lengths)
    B, H, D = q.shape
    page, KH = kv_pages.shape[1], kv_pages.shape[3]
    max_pages = block_tables.shape[1]
    if scale is None:
        scale = D ** -0.5
    code, G = _DTYPE_CODE[q.dtype], H // KH
    device = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    splits, _ = split_plan(B, KH, max_pages, page, q.element_size(),
                           lambda s: _capacity(device, code, G, D, s))
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.paged_attention_fwd(
            code, q.data_ptr(), kv_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, KH, D, kv_pages.shape[0], page, max_pages, splits,
            float(scale), stream)
    _build.check(lib, err, "paged_attention_fwd")
    return out
