"""Launchers of the hand-written CUDA linear scans: the diagonal scan of
RG-LRU (``csrc/diag_scan.cu``) and the chunked GLA scan of RWKV6
(``csrc/linear_scan.cu``).

They replace the Pallas TPU kernels ``diag_scan_kernel`` and
``gla_scan_kernel`` (``repro/kernels/linear_scan/kernel.py``); the diagonal
scan's backward (``diag_scan_bwd_kernel``) has no TPU counterpart. The source
note in each ``.cu`` file says what bounds it on the H100 and how its design
deals with that. ``ops.diag_scan`` and ``ops.gla_scan`` are the wrappers
that dispatch and count launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gla_scan_fwd": ([_I] + [_P] * 7 + [_I] * 8 + [_P], _I),
    "gla_scan_fwd_mma": ([_P] * 7 + [_I] * 8 + [_P], _I),
    "gla_scan_mma_smem": ([_I] * 3, _I),
}
_DIAG_SIGNATURES = {
    "diag_scan_fwd": ([_I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P], _I),
    "diag_scan_plan": ([_I] * 4 + [_P] * 7, _I),
    "diag_scan_bwd": ([_I] + [_P] * 5 + [_I] + [_P] * 3 + [_I] * 3 + [_P],
                      _I),
    "diag_scan_bwd_plan": ([_I] * 4 + [_P] * 5, _I),
}
D_MAX = 128            # csrc/linear_scan.cu D_MAX (Dk and Dv)
CHUNK_MAX = 64         # csrc/linear_scan.cu L_MAX
GLA_ROUTES = ("mma", "fma")
# csrc/diag_scan.cu: the ring (T > 1) and the step (T = 1) kernels
DIAG_ROUTES = ("ring", "step")
RING_CHANNELS = 64     # RING_CH: channels a block, one a thread
RING_STAGES = 4
RING_STAGE_BYTES = 16384
STEP_CHANNELS = 8      # STEP_PER_THREAD
STEP_THREADS = 128
SMEM_MAX = 232448      # shared memory a block may use on the H100 (227 KB)


def _lib():
    return _build.load("linear_scan", _SIGNATURES)


# ---------------------------------------------------------------------------
# Diagonal scan (RG-LRU): h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------
def check_diag_inputs(a: torch.Tensor, b: torch.Tensor,
                      h0: Optional[torch.Tensor]) -> None:
    """Raise on anything the CUDA kernel does not take."""
    named = [("a", a), ("b", b)] + ([] if h0 is None else [("h0", h0)])
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"diag_scan kernel: {name} is on {t.device}, "
                             f"not a CUDA device")
        if t.device != a.device:
            raise ValueError("diag_scan kernel: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"diag_scan kernel: {name} must be contiguous")
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"diag_scan kernel: a is {a.dtype}, not float32 or "
                        f"bfloat16")
    if h0 is not None and not h0.is_floating_point():
        raise TypeError(f"diag_scan kernel: h0 is {h0.dtype}, not a float "
                        f"type")
    if b.dtype != a.dtype:
        raise TypeError(f"diag_scan kernel: a is {a.dtype} but b is "
                        f"{b.dtype}")
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"diag_scan kernel: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one [B, T, D] shape")
    B, T, D = a.shape
    if T < 1 or D < 1:
        raise ValueError(f"diag_scan kernel: T ({T}) and D ({D}) must be "
                         f">= 1")
    if h0 is not None and tuple(h0.shape) != (B, D):
        raise ValueError(f"diag_scan kernel: h0 {tuple(h0.shape)} is not "
                         f"[B, D] = {(B, D)}")


def diag_route(T: int) -> str:
    """The kernel a launch of T steps takes: ``"step"`` for T = 1 (every
    decode step), ``"ring"`` otherwise."""
    return "step" if T == 1 else "ring"


def diag_plan(B: int, T: int, D: int, dtype: torch.dtype) -> dict:
    """How ``csrc/diag_scan.cu`` runs a [B, T, D] call (``diag_scan_plan``
    computes the same in the library): its route, blocks, threads a block,
    channels a block (ring) or a thread (step), time steps a stage, stages,
    dynamic shared memory a block, and the bytes of one load of a or b by
    one thread (16 where rows are whole 16-byte pieces and the pointers
    aligned, as PyTorch's allocations are)."""
    elem = torch.empty((), dtype=dtype).element_size()
    if diag_route(T) == "step":
        per_block = STEP_THREADS * STEP_CHANNELS
        return dict(route="step", blocks=-(-B * D // per_block),
                    threads=STEP_THREADS, channels=STEP_CHANNELS, steps=1,
                    stages=0, smem_bytes=0, access_bytes=16)
    return dict(route="ring", blocks=-(-D // RING_CHANNELS) * B,
                threads=RING_CHANNELS, channels=RING_CHANNELS,
                steps=RING_STAGE_BYTES // (2 * RING_CHANNELS * elem),
                stages=RING_STAGES, smem_bytes=RING_STAGES * RING_STAGE_BYTES,
                access_bytes=16 if (D * elem) % 16 == 0 else elem)


def diag_plan_built(B: int, T: int, D: int, dtype: torch.dtype) -> dict:
    """``diag_plan``'s numbers as the built library gives them (needs
    ``nvcc``; no launch)."""
    out = [ctypes.c_int() for _ in range(7)]
    lib = _build.load("diag_scan", _DIAG_SIGNATURES)
    err = lib.diag_scan_plan(_DTYPE_CODE[dtype], B, T, D,
                             *map(ctypes.byref, out))
    _build.check(lib, err, "diag_scan_plan")
    keys = ("route", "blocks", "threads", "channels", "steps", "stages",
            "smem_bytes")
    plan = dict(zip(keys, (x.value for x in out)))
    plan["route"] = DIAG_ROUTES[plan["route"]]
    return plan


def diag_scan_kernel(a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel of ``diag_route(T)``. a, b: [B, T, D],
    contiguous CUDA tensors of one dtype (float32 or bfloat16), any T >= 1;
    h0: [B, D] or None (zeros), read in its own dtype where that is float32
    or bfloat16 (another float type is widened to fp32 first, exactly as the
    plain version reads it). Returns (h [B, T, D], h_T [B, D]), both in a's
    dtype."""
    check_diag_inputs(a, b, h0)
    B, T, D = a.shape
    if h0 is not None and h0.dtype not in _DTYPE_CODE:
        h0 = h0.float()
    h = torch.empty_like(a)
    hT = torch.empty((B, D), dtype=a.dtype, device=a.device)
    lib = _build.load("diag_scan", _DIAG_SIGNATURES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.diag_scan_fwd(
            _DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(),
            0 if h0 is None else _DTYPE_CODE[h0.dtype],
            h.data_ptr(), hT.data_ptr(), B, T, D, stream)
    _build.check(lib, err, "diag_scan_fwd")
    return h, hT


def diag_bwd_plan_built(B: int, T: int, D: int, dtype: torch.dtype) -> dict:
    """How ``csrc/diag_scan.cu`` runs the backward of a [B, T, D] call, as
    the built library's ``diag_scan_bwd_plan`` gives it (needs ``nvcc``; no
    launch): blocks, threads a block, time steps a stage, stages and
    dynamic shared memory a block. Every T takes the one ring kernel."""
    out = [ctypes.c_int() for _ in range(5)]
    lib = _build.load("diag_scan", _DIAG_SIGNATURES)
    err = lib.diag_scan_bwd_plan(_DTYPE_CODE[dtype], B, T, D,
                                 *map(ctypes.byref, out))
    _build.check(lib, err, "diag_scan_bwd_plan")
    keys = ("blocks", "threads", "steps", "stages", "smem_bytes")
    return dict(zip(keys, (x.value for x in out)))


def diag_scan_bwd_kernel(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor,
                         h0: Optional[torch.Tensor] = None,
                         gT: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Optional[torch.Tensor]]:
    """Launch the backward ring kernel of ``diag_scan_kernel``. a: its
    input; h: its output [B, T, D]; g: the cotangent of h; gT: that of
    h_T ([B, D], None for zeros); h0: the forward's h0 or None. a, h, g and
    gT are contiguous CUDA tensors of a's dtype (float32 or bfloat16), any
    T >= 1. Returns (da, db) in a's dtype and dh0 [B, D] in fp32 (None
    without h0)."""
    check_diag_inputs(a, g, h0)
    named = [("h", h)] + ([] if gT is None else [("gT", gT)])
    B, T, D = a.shape
    for name, t in named:
        if not t.is_cuda or t.device != a.device or not t.is_contiguous():
            raise ValueError(f"diag_scan_bwd kernel: {name} must be a "
                             f"contiguous tensor on {a.device}")
        if t.dtype != a.dtype:
            raise TypeError(f"diag_scan_bwd kernel: a is {a.dtype} but "
                            f"{name} is {t.dtype}")
    if tuple(h.shape) != (B, T, D) or (gT is not None
                                       and tuple(gT.shape) != (B, D)):
        raise ValueError(f"diag_scan_bwd kernel: h {tuple(h.shape)} or gT "
                         f"{None if gT is None else tuple(gT.shape)} does "
                         f"not fit a {tuple(a.shape)}")
    if h0 is not None and h0.dtype not in _DTYPE_CODE:
        h0 = h0.float()
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = (None if h0 is None else
           torch.empty((B, D), dtype=torch.float32, device=a.device))
    lib = _build.load("diag_scan", _DIAG_SIGNATURES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.diag_scan_bwd(
            _DTYPE_CODE[a.dtype], a.data_ptr(), h.data_ptr(), g.data_ptr(),
            None if gT is None else gT.data_ptr(),
            None if h0 is None else h0.data_ptr(),
            0 if h0 is None else _DTYPE_CODE[h0.dtype],
            da.data_ptr(), db.data_ptr(),
            None if dh0 is None else dh0.data_ptr(), B, T, D, stream)
    _build.check(lib, err, "diag_scan_bwd")
    return da, db, dh0


# ---------------------------------------------------------------------------
# Chunked GLA (the RWKV6 wkv core)
# ---------------------------------------------------------------------------


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


def gla_route(dtype: torch.dtype) -> str:
    """The kernel a launch takes: ``"mma"`` (the chunk products on bf16
    tensor cores, every operand split into two bf16 parts) for bf16 inputs
    of any width, ``"fma"`` (fp32 FMAs; GLA's fp32 tolerance rules out
    rounded operands) for fp32 inputs."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def _round(x: int, m: int) -> int:
    return -(-x // m) * m


def gla_mma_smem(chunk: int, Dk: int, tv: int) -> int:
    """Bytes of shared memory of one block of the ``"mma"`` route
    (``csrc/linear_scan.cu`` MmaLayout; ``gla_scan_mma_smem`` in the
    library): bf16 hi and lo planes of q_inter, q_intra, k_intra, A and S,
    one of v, with row strides that keep ldmatrix free of bank conflicts;
    S in fp32; the bonus and decay vectors and their partial sums; and one
    chunk's bf16 inputs as they arrive."""
    LP, DKp, TVp = _round(chunk, 16), _round(Dk, 16), _round(tv, 16)

    def plane(n):                  # an odd number of 16-byte units a row
        n = _round(n, 8)
        return n if n % 16 else n + 8
    LDK, LDL, LDV, LDS = plane(DKp), plane(LP), plane(TVp), TVp + 8
    planes = 6 * LP * LDK + 2 * LP * LDL + LP * LDV + 2 * DKp * LDV
    floats = DKp * LDS + LP + 2 * DKp + LP * DKp // 2 + LP * DKp // 8
    return _round(2 * planes + 4 * floats, 16) \
        + _round(2 * (3 * chunk * Dk + chunk * tv), 16)


def mma_dv_tile(rows: int, Dk: int, Dv: int, chunk: int,
                num_sms: int) -> int:
    """``dv_tile`` for the ``"mma"`` route, narrowed by 8 columns at a time
    until one block's shared memory fits the H100's 227 KB."""
    tv = dv_tile(rows, Dv, num_sms)
    while tv > 8 and gla_mma_smem(chunk, Dk, tv) > SMEM_MAX:
        tv -= 8
    return tv


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
    """Launch the CUDA kernel of ``gla_route(r.dtype)``. r, k, w: [B, T,
    Dk]; v: [B, T, Dv]; u: [B, Dk]; all contiguous CUDA tensors of one dtype
    (float32 or bfloat16), with T a multiple of ``chunk``. Returns (o
    [B, T, Dv] in v's dtype, S_T [B, Dk, Dv] in fp32)."""
    check_kernel_inputs(r, k, v, w, u, chunk)
    B, T, Dk = r.shape
    Dv = v.shape[-1]
    route = gla_route(r.dtype)
    sms = _num_sms(r.device.index or 0)
    tv = (mma_dv_tile(B, Dk, Dv, chunk, sms) if route == "mma"
          else dv_tile(B, Dv, sms))
    o = torch.empty((B, T, Dv), dtype=v.dtype, device=v.device)
    s_out = torch.empty((B, Dk, Dv), dtype=torch.float32, device=v.device)
    vec_rkw = min(_vec_ok(t, Dk) for t in (r, k, w))
    vec_v = _vec_ok(v, Dv, tv)
    lib = _lib()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), o.data_ptr(), s_out.data_ptr())
    sizes = (B, T, Dk, Dv, chunk, tv, vec_rkw, vec_v, stream)
    with torch.cuda.device(r.device):
        if route == "mma":
            err = lib.gla_scan_fwd_mma(*ptrs, *sizes)
        else:
            err = lib.gla_scan_fwd(_DTYPE_CODE[r.dtype], *ptrs, *sizes)
    _build.check(lib, err, f"gla_scan_fwd ({route})")
    return o, s_out
