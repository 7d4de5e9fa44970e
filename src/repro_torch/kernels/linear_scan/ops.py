"""Public wrappers for the linear scans: ``diag_scan`` (RG-LRU) and
``gla_scan`` (the RWKV6 wkv core).

``diag_scan`` dispatches between the hand-written CUDA kernels
(``impl="kernel"``) and the sequential oracle (``impl="xla"``,
``ref.diag_scan_ref``). Kernel source note. The kernels
(``csrc/diag_scan.cu``, launched by ``kernel.diag_scan_kernel``) replace the
Pallas TPU kernel ``diag_scan_kernel`` in
``repro/kernels/linear_scan/kernel.py``. They move 3 elements per
multiply-add, so their floor on the H100 is memory: at the served prefill
shape ([4, 2100, 4096] bf16) 206 MB over 3.35 TB/s, 0.062 ms. The TPU
kernel walks T in chunks over a sequential grid axis with the state in
VMEM. On Hopper, ``kernel.diag_route`` picks one of two kernels by T alone:
the ``"ring"`` kernel (T > 1) gives each thread one channel to walk through
all of T, and streams a and b through a ring of shared-memory stages filled
by 16-byte ``cp.async`` copies three stages ahead, so each element of a and
b is read from device memory once and each of h written once; the
``"step"`` kernel (T = 1, every decode step) is one flat elementwise pass, 8
channels a thread, no shared memory. Both walk each channel in order and
round the multiply and the add apart, so they give the plain version's bits
for every T. h0 is read in its own dtype (fp32 or bf16). The kernels take
any T >= 1, so the wrapper skips the reference's padding of T to a chunk
multiple (the padded steps come after the last real one and change no
output); ``chunk`` only shapes the reference. ``impl="kernel"`` takes the
plain version only when the tensors lie on the CPU; on CUDA tensors it
launches a kernel or raises. ``diag_scan.launches`` counts kernel launches
and ``diag_scan.launches_by_route`` splits them by route.

Under grad (grad enabled and an input that requires it) ``impl="kernel"``
goes through ``_DiagScan``: the forward above, and a backward that is the
same recurrence run backwards in time (``ref.diag_scan_bwd_ref``), on the
CUDA backward kernel (``kernel.diag_scan_bwd_kernel``, counted by
``diag_scan.bwd_launches``) on CUDA tensors and the plain version on CPU
tensors. The reference takes this gradient by autodiff of its sequential
scan; the kernel has no TPU counterpart.

``gla_scan`` dispatches between the hand-written CUDA kernels
(``impl="kernel"``), the chunk-parallel plain-PyTorch path
(``impl="xla_chunked"``, the mirror of the reference's ``_gla_chunked_xla``:
a loop over chunks with products within) and the sequential oracle
(``impl="xla"``, ``ref.gla_scan_ref``). Kernel source note. The kernels
(``csrc/linear_scan.cu``, launched by ``kernel.gla_scan_kernel``) replace the
Pallas TPU kernel ``gla_scan_kernel`` in ``repro/kernels/linear_scan/kernel.py``.
At the served prefill shape (B·H = 128 rows, T = 512, Dk = Dv = 80, chunk
64, bf16 in) the chunk products are about 2.4 GFLOP, A and A v strictly
lower triangular: 0.035 ms in fp32 FMAs, a few microseconds on tensor cores,
against ~56 MB of traffic (0.017 ms). The TPU kernel carries the state in
VMEM scratch across a sequential grid axis; on Hopper blocks run in no
order, so one block per (row, Dv tile) keeps its fp32 state tile in shared
memory and walks the chunks itself, the Dv tiles sized to give every SM a
block (128 rows are under the 132 SMs). ``kernel.gla_route`` picks the
kernel by dtype alone: bf16 inputs take ``"mma"``, the four chunk products
on tensor cores (mma.sync, fp32 accumulation) with each fp32 operand split
into two bf16 parts (rounded once, to bf16 or TF32, they miss GLA's bf16
tolerance at the served shape), the next chunk staged by ``cp.async`` under
the current one's products; fp32 inputs keep ``"fma"``, fp32 FMAs from 4x4
register tiles (GLA's fp32 tolerance rules out rounded operands).

``impl="kernel"`` takes the plain version (``"xla_chunked"``, the function
the TPU kernel computes) only when the tensors lie on the CPU. On CUDA
tensors it pads T to a chunk multiple, launches a kernel or raises; it
never falls back. ``gla_scan.launches`` counts kernel launches and
``gla_scan.launches_by_route`` splits them by route.

Under grad ``impl="kernel"`` goes through ``_GLAScan``: the forward above
on the inputs cast to fp32, so always on the ``"fma"`` route, and a
backward in plain PyTorch that recomputes ``_gla_chunked`` under autograd
and takes its gradient, the mirror of ``jax.grad`` through the
reference's ``_gla_chunked_xla``. The ``"mma"`` route's 16-bit operands
serve within GLA's bf16 tolerance, but under training they are not
enough: at full-depth rwkv6-3b's trained params in bf16 compute its
forward moved a few layer params' gradients 5-8x their size, where the
chunked plain version moves them 0.3-1x (``tools/rwkv_gla_chunk.py
--trained``). The backward launches no GLA kernel; ``gla_scan.bwd_calls``
counts its calls. Serving (no grad) takes neither Function.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import local_only
from .kernel import (DIAG_ROUTES, GLA_ROUTES, diag_route,
                     diag_scan_bwd_kernel, diag_scan_kernel, gla_route,
                     gla_scan_kernel)
from .ref import diag_scan_bwd_ref, diag_scan_ref, gla_scan_ref


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def diag_scan(a: torch.Tensor, b: torch.Tensor,
              h0: Optional[torch.Tensor] = None, *, impl: str = "xla",
              chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t with the carry in fp32. a, b: [B, T, D];
    h0: [B, D] in any float type (zeros without it). Returns (h [B, T, D],
    h_T [B, D]) in a's dtype.

    impl: "kernel" (CUDA kernel; the oracle on CPU tensors) or "xla" (the
    sequential oracle). ``chunk`` is the reference's padding unit; neither
    path here needs it."""
    if impl == "kernel":
        if _needs_grad(a, b, h0):
            return _DiagScan.apply(a, b, h0)
        return _diag_fwd(a, b, h0)
    if impl == "xla":
        return diag_scan_ref(a, b, h0)
    raise ValueError(f"unknown impl {impl!r}")


diag_scan.launches = 0
diag_scan.launches_by_route = dict.fromkeys(DIAG_ROUTES, 0)
diag_scan.bwd_launches = 0


def _diag_fwd(a, b, h0):
    """The kernel on CUDA tensors (counted), the oracle on CPU tensors."""
    local_only(a, b, h0)
    if a.device.type == "cpu":
        return diag_scan_ref(a, b, h0)
    out = diag_scan_kernel(a.contiguous(), b.contiguous(),
                           None if h0 is None else h0.contiguous())
    diag_scan.launches += 1
    diag_scan.launches_by_route[diag_route(a.shape[1])] += 1
    return out


class _DiagScan(torch.autograd.Function):
    """``diag_scan`` under grad. Saves a, h0 and the forward's h (h_{t-1}
    is h shifted by one, h0 in front); the backward walks T from the end
    with the carry in fp32 and gives da and db in a's dtype and dh0 in
    h0's."""

    @staticmethod
    def forward(ctx, a, b, h0):
        ctx.set_materialize_grads(False)
        h, hT = _diag_fwd(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        ctx.b_dtype = b.dtype
        return h, hT

    @staticmethod
    def backward(ctx, g, gT):
        a, h0, h = ctx.saved_tensors
        if g is None and gT is None:
            return None, None, None
        if g is None:
            g = torch.zeros_like(h)
        if a.device.type == "cpu":
            acc = torch.float64 if a.dtype == torch.float64 else torch.float32
            first = (torch.zeros_like(h[:, 0], dtype=acc) if h0 is None
                     else h0.to(acc))
            h_prev = torch.cat([first[:, None], h[:, :-1].to(acc)], dim=1)
            da, db, dh0 = diag_scan_bwd_ref(a, h_prev, g, gT)
        else:
            da, db, dh0 = diag_scan_bwd_kernel(
                a.contiguous(), h, g.contiguous(), h0,
                None if gT is None else gT.contiguous())
            diag_scan.bwd_launches += 1
        dh0 = None if h0 is None or dh0 is None else dh0.to(h0.dtype)
        return da, db.to(ctx.b_dtype), dh0


def _pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros after the last token: log-decay 0 is no decay, k = 0 no update."""
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def gla_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, *, impl: str = "xla",
             chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 wkv core from a zero state. w = LOG decays. r, k, w: [B, T, Dk];
    v: [B, T, Dv]; u: [B, Dk]. Returns (o [B, T, Dv] in v's dtype, S_T
    [B, Dk, Dv] in fp32).

    impl: "kernel" (CUDA kernel; "xla_chunked" on CPU tensors),
    "xla_chunked" (chunked plain PyTorch) or "xla" (sequential oracle).
    """
    if impl == "kernel":
        if _needs_grad(r, k, v, w, u):
            return _GLAScan.apply(r, k, v, w, u, chunk)
        return _gla_fwd(r, k, v, w, u, chunk)
    if impl == "xla":
        return gla_scan_ref(r, k, v, w, u)
    if impl == "xla_chunked":
        return _gla_chunked(r, k, v, w, u, chunk=chunk)
    raise ValueError(f"unknown impl {impl!r}")


gla_scan.launches = 0
gla_scan.launches_by_route = dict.fromkeys(GLA_ROUTES, 0)
gla_scan.bwd_calls = 0


def _gla_fwd(r, k, v, w, u, chunk):
    """The kernel on CUDA tensors (T padded to a chunk multiple; counted),
    ``_gla_chunked`` on CPU tensors."""
    local_only(r, k, v, w, u)
    if r.device.type == "cpu":
        return _gla_chunked(r, k, v, w, u, chunk=chunk)
    T = r.shape[1]
    c = min(chunk, T)
    pad = (-T) % c
    o, S = gla_scan_kernel(*(_pad_time(x, pad).contiguous()
                             for x in (r, k, v, w)),
                           u.contiguous(), chunk=c)
    gla_scan.launches += 1
    gla_scan.launches_by_route[gla_route(r.dtype)] += 1
    return (o[:, :T] if pad else o), S


class _GLAScan(torch.autograd.Function):
    """``gla_scan`` under grad: the forward of ``_gla_fwd`` on fp32 casts of
    the inputs (the ``"fma"`` route; o back in v's dtype); the backward
    recomputes ``_gla_chunked`` from the saved r, k, v, w and u under
    autograd and takes its gradient for the cotangents of o and (where it
    has one) S_T."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        o, S = _gla_fwd(*(x.float() for x in (r, k, v, w, u)), chunk)
        return o.to(v.dtype), S

    @staticmethod
    def backward(ctx, go, gS):
        gla_scan.bwd_calls += 1
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            o, S = _gla_chunked(*inputs, chunk=ctx.chunk)
        outs = [(y, gy) for y, gy in ((o, go), (S, gS)) if gy is not None]
        wanted = [t for t in inputs if t.requires_grad]
        if not outs or not wanted:
            return (None,) * 6
        got = iter(torch.autograd.grad([y for y, _ in outs],
                                       wanted, [gy for _, gy in outs],
                                       allow_unused=True))
        return tuple(next(got) if t.requires_grad else None
                     for t in inputs) + (None,)


def _gla_chunked(r, k, v, w, u, *, chunk: int = 64):
    """Chunk-parallel GLA in plain PyTorch, fp32 throughout: the same
    telescoped factorisation as the kernel, chunk by chunk,

        q_inter = r e^{c - w},  q_intra = r e^{c - w - c_L},
        k_intra = k e^{c_L - c},  c = cumsum(w) within the chunk,

    o = q_inter S + tril(q_intra k_intra^T, -1) v + (Σ r u k) v and
    S <- e^{c_L} S + k_intra^T v."""
    B, T, Dk = r.shape
    Dv, out_dtype = v.shape[-1], v.dtype
    c = min(chunk, T)
    pad = (-T) % c
    r, k, v, w = (_pad_time(x, pad).float() for x in (r, k, v, w))
    uf = u.float()
    strict = torch.tril(torch.ones(c, c, dtype=torch.bool, device=r.device),
                        diagonal=-1)
    S = torch.zeros((B, Dk, Dv), dtype=torch.float32, device=r.device)
    outs = []
    for s in range(0, r.shape[1], c):
        rc, kc, vc, wc = (x[:, s:s + c] for x in (r, k, v, w))
        cum = torch.cumsum(wc, dim=1)
        ex_cum = cum - wc
        c_last = cum[:, -1:, :]
        q_inter = rc * torch.exp(ex_cum)
        q_intra = rc * torch.exp(ex_cum - c_last)
        k_intra = kc * torch.exp(c_last - cum)
        o = torch.einsum("blk,bkv->blv", q_inter, S)
        A = torch.einsum("bik,bjk->bij", q_intra, k_intra)
        A = torch.where(strict, A, torch.zeros((), device=A.device))
        bonus = torch.einsum("blk,bk,blk->bl", rc, uf, kc)
        o = o + torch.einsum("bij,bjv->biv", A, vc) + bonus[..., None] * vc
        S = torch.exp(c_last).transpose(1, 2) * S + torch.einsum(
            "blk,blv->bkv", k_intra, vc)
        outs.append(o)
    o = torch.cat(outs, dim=1)[:, :T]
    return o.to(out_dtype), S
