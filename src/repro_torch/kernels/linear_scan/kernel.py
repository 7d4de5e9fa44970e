"""Launcher of the hand-written CUDA chunked GLA scan (``csrc/linear_scan.cu``).

The kernel replaces the Pallas TPU kernel ``gla_scan_kernel``
(``repro/kernels/linear_scan/kernel.py``). The source note in the ``.cu`` file
says what bounds it on the H100 and how its design deals with that.
``ops.gla_scan`` is the wrapper that pads, dispatches and counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gla_scan_fwd": ([_I] + [_P] * 7 + [_I] * 8 + [_P], _I),
}
D_MAX = 128            # csrc/linear_scan.cu D_MAX (Dk and Dv)
CHUNK_MAX = 64         # csrc/linear_scan.cu L_MAX


def _lib():
    return _build.load("linear_scan", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dv_tile(rows: int, Dv: int, num_sms: int) -> int:
    """Width of the Dv tile of one block: the fewest tiles that give at
    least one block per SM over the (row, tile) grid, each tile a multiple
    of 4 columns wide (of 8 where Dv allows, for 16-byte bf16 loads)."""
    want = max(1, -(-num_sms // max(rows, 1)))
    step = 8 if Dv % 8 == 0 else 4
    tiles = min(want, max(1, Dv // step))
    tv = -(-Dv // tiles)
    return min(Dv, -(-tv // step) * step)


def check_kernel_inputs(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, chunk: int) -> None:
    """Raise on anything the CUDA kernel does not take."""
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"gla_scan kernel: {name} is on {t.device}, "
                             f"not a CUDA device")
        if t.device != r.device:
            raise ValueError("gla_scan kernel: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"gla_scan kernel: {name} must be contiguous")
        if t.dtype != r.dtype:
            raise TypeError(f"gla_scan kernel: r is {r.dtype} but {name} is "
                            f"{t.dtype}")
    if r.dtype not in _DTYPE_CODE:
        raise TypeError(f"gla_scan kernel: dtype {r.dtype} not supported "
                        f"(float32, bfloat16)")
    if r.dim() != 3 or v.dim() != 3 or u.dim() != 2:
        raise ValueError("gla_scan kernel: r, k, w, v must be [B, T, D] and "
                         "u [B, Dk]")
    B, T, Dk = r.shape
    if tuple(k.shape) != (B, T, Dk) or tuple(w.shape) != (B, T, Dk) \
            or tuple(v.shape[:2]) != (B, T) or tuple(u.shape) != (B, Dk):
        raise ValueError(f"gla_scan kernel: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)} disagree")
    Dv = v.shape[-1]
    if not (1 <= Dk <= D_MAX and 1 <= Dv <= D_MAX):
        raise ValueError(f"gla_scan kernel: Dk {Dk} and Dv {Dv} must lie in "
                         f"[1, {D_MAX}]")
    if not 1 <= chunk <= CHUNK_MAX or T % chunk:
        raise ValueError(f"gla_scan kernel: chunk {chunk} must lie in [1, "
                         f"{CHUNK_MAX}] and divide T ({T})")


def _vec_ok(t: torch.Tensor, *widths: int) -> int:
    """1 if ``t`` may be read in 16-byte pieces at rows and column offsets
    of these widths (in elements)."""
    elem = t.element_size()
    return int(t.data_ptr() % 16 == 0
               and all((n * elem) % 16 == 0 for n in widths))


def gla_scan_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel. r, k, w: [B, T, Dk]; v: [B, T, Dv]; u: [B, Dk];
    all contiguous CUDA tensors of one dtype (float32 or bfloat16), with T a
    multiple of ``chunk``. Returns (o [B, T, Dv] in v's dtype, S_T
    [B, Dk, Dv] in fp32)."""
    check_kernel_inputs(r, k, v, w, u, chunk)
    B, T, Dk = r.shape
    Dv = v.shape[-1]
    tv = dv_tile(B, Dv, _num_sms(r.device.index or 0))
    o = torch.empty((B, T, Dv), dtype=v.dtype, device=v.device)
    s_out = torch.empty((B, Dk, Dv), dtype=torch.float32, device=v.device)
    vec_rkw = min(_vec_ok(t, Dk) for t in (r, k, w))
    vec_v = _vec_ok(v, Dv, tv)
    lib = _lib()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = lib.gla_scan_fwd(
            _DTYPE_CODE[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
            w.data_ptr(), u.data_ptr(), o.data_ptr(), s_out.data_ptr(), B, T,
            Dk, Dv, chunk, tv, vec_rkw, vec_v, stream)
    _build.check(lib, err, "gla_scan_fwd")
    return o, s_out
