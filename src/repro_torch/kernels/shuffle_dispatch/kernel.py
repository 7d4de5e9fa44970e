"""Launchers of the hand-written CUDA MoE shuffle kernels
(``csrc/shuffle_dispatch.cu``): ``dispatch_kernel`` and ``combine_kernel``.

They replace the Pallas TPU kernels of the same names
(``repro/kernels/shuffle_dispatch/kernel.py``). The source note in the
``.cu`` file says what bounds them on the H100 and how their design deals
with that. Dispatch has two routes, chosen by ``dispatch_route`` from the
number of pairs alone. ``ops.dispatch`` and ``ops.combine`` are the wrappers
that dispatch and count launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "shuffle_dispatch_fwd": ([_I] + [_P] * 4 + [_I] * 5 + [_P], _I),
    "shuffle_combine_fwd": ([_I, _I] + [_P] * 5 + [_I] * 5 + [_P], _I),
    "shuffle_dispatch_route": ([ctypes.c_longlong], _I),
}
# csrc/shuffle_dispatch.cu: a block walks the assignment for its rows, or
# (few pairs) each warp reads the pairs straight
DISPATCH_ROUTES = ("walk", "direct")
DIRECT_MAX_PAIRS = 64  # DIRECT_MAX_PAIRS


def _lib():
    return _build.load("shuffle_dispatch", _SIGNATURES)


def dispatch_route(pairs: int) -> str:
    """The kernel a dispatch of ``pairs`` = N * K pairs launches:
    ``"direct"`` for at most ``DIRECT_MAX_PAIRS`` (a decode step's few
    tokens: no walk, no barrier), ``"walk"`` otherwise (a prefill)."""
    return "direct" if pairs <= DIRECT_MAX_PAIRS else "walk"


def dispatch_route_built(pairs: int) -> str:
    """``dispatch_route`` as the built library computes it."""
    return DISPATCH_ROUTES[_lib().shuffle_dispatch_route(pairs)]


def check_assignment(what: str, device: torch.device, expert_id: torch.Tensor,
                     slot: torch.Tensor, gates=None) -> None:
    """Raise on assignments the kernels do not take: [N, K] int32, on
    ``device``, contiguous (gates: fp32 or bf16)."""
    named = [("expert_id", expert_id), ("slot", slot)]
    if gates is not None:
        named.append(("gates", gates))
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{what} kernel: {name} is on {t.device}, not "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel: {name} must be contiguous")
        if t.dim() != 2 or tuple(t.shape) != tuple(expert_id.shape):
            raise ValueError(f"{what} kernel: {name} {tuple(t.shape)} is not "
                             f"[N, K] = {tuple(expert_id.shape)}")
    for name, t in named[:2]:
        if t.dtype != torch.int32:
            raise TypeError(f"{what} kernel: {name} is {t.dtype}, not int32")
    if gates is not None and gates.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} kernel: gates are {gates.dtype}, not "
                        f"float32 or bfloat16")


def _check_data(what: str, name: str, t: torch.Tensor, dim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} kernel: {name} is on {t.device}, not a "
                         f"CUDA device")
    if not t.is_contiguous():
        raise ValueError(f"{what} kernel: {name} must be contiguous")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} kernel: {name} is {t.dtype}, not float32 "
                        f"or bfloat16")
    if t.dim() != dim:
        raise ValueError(f"{what} kernel: {name} must have {dim} dims, not "
                         f"{t.dim()}")


def dispatch_kernel(x: torch.Tensor, expert_id: torch.Tensor,
                    slot: torch.Tensor, num_experts: int,
                    capacity: int) -> torch.Tensor:
    """Launch the CUDA kernel of ``dispatch_route(N * K)``, once. x: [N, D]
    contiguous CUDA tensor (float32 or bfloat16); expert_id, slot: [N, K]
    contiguous int32 on x's device. Returns the buffers [E, C, D] in x's
    dtype."""
    _check_data("dispatch", "x", x, 2)
    check_assignment("dispatch", x.device, expert_id, slot)
    if expert_id.shape[0] != x.shape[0]:
        raise ValueError(f"dispatch kernel: x has {x.shape[0]} tokens, "
                         f"expert_id {expert_id.shape[0]}")
    if num_experts < 0 or capacity < 0:
        raise ValueError(f"dispatch kernel: num_experts {num_experts} and "
                         f"capacity {capacity} must be >= 0")
    N, D = x.shape
    K = expert_id.shape[1]
    out = torch.empty((num_experts, capacity, D), dtype=x.dtype,
                      device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.shuffle_dispatch_fwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), expert_id.data_ptr(),
            slot.data_ptr(), out.data_ptr(), N, K, num_experts, capacity, D,
            stream)
    _build.check(lib, err, "shuffle_dispatch_fwd")
    return out


def combine_kernel(y: torch.Tensor, expert_id: torch.Tensor,
                   slot: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. y: [E, C, D] contiguous CUDA tensor (float32
    or bfloat16); expert_id, slot: [N, K] contiguous int32 and gates [N, K]
    (float32 or bfloat16), on y's device. Returns [N, D] in y's dtype."""
    _check_data("combine", "y", y, 3)
    check_assignment("combine", y.device, expert_id, slot, gates)
    E, C, D = y.shape
    N, K = expert_id.shape
    out = torch.empty((N, D), dtype=y.dtype, device=y.device)
    lib = _lib()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        err = lib.shuffle_combine_fwd(
            _DTYPE_CODE[y.dtype], _DTYPE_CODE[gates.dtype], y.data_ptr(),
            expert_id.data_ptr(), slot.data_ptr(), gates.data_ptr(),
            out.data_ptr(), N, K, E, C, D, stream)
    _build.check(lib, err, "shuffle_combine_fwd")
    return out
