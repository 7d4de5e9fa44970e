"""Public wrapper for flash attention.

Dispatches between the hand-written CUDA kernels (``impl="kernel"``), a
chunked plain-PyTorch path (``impl="xla"``, the mirror of the reference's
``lax.scan`` online softmax over kv blocks) and the naive oracle
(``impl="naive"``). GQA as the reference does it.

Kernel source note. The kernels (``csrc/flash_attention.cu``, launched by
``kernel.flash_attention_kernel``) replace the Pallas TPU kernel
``flash_attention_kernel`` in ``repro/kernels/flash_attention/kernel.py``.
What bounds them on the H100 at the served prefills (bf16, causal): memory
at qwen3-0.6b's (B=4, H=16, KH=8, T=512, D=128; ~25 MB over 3.35 TB/s, 7.5
us) and at grok-1-314b's (H=48 over KH=8; ~55 MB, 16 us); the 0.145 TFLOP
of products at the bf16 tensor-core rate at recurrentgemma-9b's (B=4, H=16,
KH=1, T=2100, D=256, window 2048; 0.146 ms); memory again at
deepseek-v2-lite-16b's MLA heads (B=4, H=KH=16, T=512, D=192, Dv=128; ~42
MB, 12.5 us). Only the tensor cores reach the floor at recurrentgemma's:
the fp32 FMA rate alone puts one of ~2.2 ms there. So bf16 inputs with
D % 8 == 0 and Dv % 8 == 0 take the ``"wgmma"`` route: both products on
``wgmma`` (P rounded to bf16 for P·V, as the reference's ``p_bf16``),
tiles staged by TMA through a two-stage ring of mbarriers, a producer
warpgroup and two consumer warpgroups of 64 query rows that take turns on
the tensor cores
(``setmaxnreg`` gives them 240 registers), the online softmax in registers
under the products, fully masked tiles skipped and the element-wise mask
only on edge tiles; persistent, heaviest q tiles first.
fp32 inputs (3e-5 rules out TF32) and head dims that are no multiple of 8
take the ``"scalar"`` route: fp32 FMAs over 64x64 tiles in shared memory.
``kernel.kernel_route`` picks the route from dtype and head dims alone.

``impl="kernel"`` takes the plain version (``ref.attention_ref``) only when
the tensors lie on the CPU. On CUDA tensors it launches a kernel or raises;
it never falls back. It passes the tensors unpadded: the kernels mask Tq,
Tk and kv_len themselves, so ``block_q`` / ``block_k`` only shape the
``"xla"`` path.
``flash_attention.launches`` counts kernel launches,
``flash_attention.launches_by_route`` splits them by route and
``flash_attention.lse_launches`` counts those that also wrote the rows'
log-sum-exp (the training path's forwards) and
``flash_attention.noncausal_launches`` those without the causal mask (the
enc-dec's encoder). Each call is the program span ``pangea.flash``
(``repro_torch.trace``).

``"kernel"`` and ``"xla"`` differ on a row with no live key inside a block
that is not skipped (a causal row before the first key, ``q_offset < 0``):
``"kernel"`` gives 0, as the reference's ``attention_ref`` does (both CUDA
routes zero masked probabilities), while ``"xla"`` mirrors the reference's
Pallas kernel and chunked path, which leave them unzeroed, so that every
visited key counts exp(-1e30 - (-1e30)) = 1 and the row is the mean of V.
No served path has such a row.

Gradients. When grad is enabled and q, k or v requires it, ``"kernel"``
and ``"xla"`` run through ``_FlashAttention``, the port of the reference's
custom VJP of its chunked path (``_chunked_attention``, ``ops.py:117-191``).
Its forward is the CUDA kernel with the rows' lse written (``"kernel"``;
the plain version with lse on CPU tensors) or the chunked mirror, whose
running max m and sum l give lse = m + log l (``"xla"``). Its backward is
one plain-PyTorch mirror of the reference's ``_chunked_attention_bwd``, for
both: per kv chunk it recomputes the scores, takes the probabilities from
the saved lse, p = exp(s - lse), and accumulates dq, dk and dv with
delta = sum(dout * out) and
ds = p (dp - delta) scale, folding the query-head groups back into their kv
heads. It launches no kernel: the reference computes it in XLA, outside
any Pallas kernel, so it is the counterpart of no TPU kernel. ``"naive"``
stays plain autograd through the oracle.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ... import trace
from .. import local_only
from .kernel import ROUTES, flash_attention_kernel, kernel_route
from .ref import attention_ref


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    impl: str = "xla", block_q: int = 128,
                    block_k: int = 128, p_bf16: bool = False) -> torch.Tensor:
    """q [B,H,Tq,D], k [B,KH,Tk,D], v [B,KH,Tk,Dv] -> [B,H,Tq,Dv]; Dv may
    differ from D (MLA) on every impl. ``scale`` defaults to D^-0.5.

    impl: "kernel" (CUDA kernel; its plain version on CPU tensors), "xla"
    (chunked online softmax in plain PyTorch), "naive" (reference; O(T^2)
    memory). ``block_q`` / ``block_k`` shape only the "xla" path (its kv
    chunks are ``block_k``); the kernels choose their own tiles and the CPU
    plain version is unblocked, as the reference's signature keeps both.
    ``p_bf16``: cast softmax weights to
    bf16 for the PV product ("xla" only, as in the reference; the "wgmma"
    kernel route always does).
    """
    with trace.span("pangea.flash"):
        if impl == "naive":
            return attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, q_offset=q_offset)
        if impl not in ("kernel", "xla"):
            raise ValueError(f"unknown impl {impl!r}")
        if scale is None:
            scale = q.shape[-1] ** -0.5
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashAttention.apply(q, k, v, impl, causal, window,
                                         scale, q_offset, block_k, p_bf16)
        if impl == "kernel":
            return _kernel_fwd(q, k, v, causal, window, scale, q_offset,
                               False)
        out, _, _ = _attn_fwd_core(q, k, v, causal, window, scale, q_offset,
                                   block_k, p_bf16)
        return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention.lse_launches = 0
flash_attention.noncausal_launches = 0


def _kernel_fwd(q, k, v, causal, window, scale, q_offset, return_lse):
    """``impl="kernel"``: the CUDA kernel on CUDA tensors (counted), its
    plain version on CPU tensors. Returns out, or (out, lse)."""
    local_only(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset,
                             return_lse=return_lse)
    res = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                 scale=scale, q_offset=q_offset,
                                 kv_len=k.shape[2], return_lse=return_lse)
    flash_attention.launches += 1
    flash_attention.launches_by_route[
        kernel_route(q.dtype, q.shape[-1], v.shape[-1])] += 1
    flash_attention.lse_launches += int(return_lse)
    flash_attention.noncausal_launches += int(not causal)
    return res


class _FlashAttention(torch.autograd.Function):
    """Attention with the reference's flash-style custom VJP: the forward
    keeps each row's softmax statistics, the backward recomputes per-chunk
    scores from them instead of saving [Tq, Tk] probabilities. ``impl``:
    ``"kernel"`` (the CUDA kernel with its lse output) or ``"xla"`` (the
    chunked mirror, lse = m + log l from its running max and sum)."""

    @staticmethod
    def forward(ctx, q, k, v, impl, causal, window, scale, q_offset, block_k,
                p_bf16):
        if impl == "kernel":
            out, lse = _kernel_fwd(q, k, v, causal, window, scale, q_offset,
                                   True)
        else:
            out, m, l = _attn_fwd_core(q, k, v, causal, window, scale,
                                       q_offset, block_k, p_bf16)
            lse = (m + torch.log(l))[..., 0]      # l is clamped above 0
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale, q_offset, block_k, p_bf16)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _attn_bwd_core(q, k, v, out, dout, lse, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def _attn_bwd_core(q, k, v, out, dout, lse, causal, window, scale, q_offset,
                   block_k, p_bf16=False):
    """The plain-PyTorch mirror of the reference's ``_chunked_attention_bwd``
    (``repro/kernels/flash_attention/ops.py:142-188``), in fp32, chunk by
    chunk over kv blocks of ``block_k``: p = exp(s - lse) from the saved
    rows' lse ``[B, H, Tq]``, masked scores filled with -1e30 as in the
    reference, delta = sum(dout *
    out), ds = p (dp - delta) scale, and the GQA groups folded back into kv
    heads. Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    B, H, Tq, D = q.shape
    _, KH, Tk, _ = k.shape
    Dv = v.shape[-1]
    group = H // KH
    bk = min(block_k, Tk)
    kp = _pad_to(k, 2, bk)
    vp = _pad_to(v, 2, bk)
    nk = kp.shape[2] // bk
    qf = q.float()
    do = dout.float()
    # delta_i = sum_d dout_i * out_i  (flash-attn bwd identity)
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for ki in range(nk):
        kbr = kp[:, :, ki * bk:(ki + 1) * bk].float().repeat_interleave(
            group, dim=1)
        vbr = vp[:, :, ki * bk:(ki + 1) * bk].float().repeat_interleave(
            group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kbr) * scale
        mask = _chunk_mask(Tq, Tk, bk, ki, q_offset, causal, window, q.device)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        p = torch.exp(s - lse[..., None])             # true softmax weights
        if p_bf16:
            p = p.to(torch.bfloat16).float()
        dv_c = torch.einsum("bhqk,bhqd->bhkd", p, do)
        dp = torch.einsum("bhqd,bhkd->bhqk", do, vbr)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kbr)
        dk_c = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
        # fold GQA groups back into kv heads
        dks.append(dk_c.reshape(B, KH, group, bk, D).sum(dim=2))
        dvs.append(dv_c.reshape(B, KH, group, bk, Dv).sum(dim=2))
    dk = torch.cat(dks, dim=2)[:, :, :Tk]
    dv = torch.cat(dvs, dim=2)[:, :, :Tk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _chunk_mask(Tq, Tk, bk, ki, q_offset, causal, window, device):
    q_pos = q_offset + torch.arange(Tq, device=device)
    k_pos = ki * bk + torch.arange(bk, device=device)
    mask = (k_pos < Tk)[None, :].expand(Tq, bk)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask  # [Tq, bk]


def _attn_fwd_core(q, k, v, causal, window, scale, q_offset, block_k,
                   p_bf16=False):
    """Online-softmax attention as a loop over kv chunks, in fp32; the
    plain-PyTorch mirror of the reference's ``_attn_fwd_core``. Supports
    Dv != Dk. Returns (out, m, l)."""
    B, H, Tq, D = q.shape
    _, KH, Tk, _ = k.shape
    Dv = v.shape[-1]
    group = H // KH
    bk = min(block_k, Tk)
    kp = _pad_to(k, 2, bk)
    vp = _pad_to(v, 2, bk)
    nk = kp.shape[2] // bk
    qf = q.float()

    m = torch.full((B, H, Tq, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tq, Dv), dtype=torch.float32, device=q.device)
    for ki in range(nk):
        kb = kp[:, :, ki * bk:(ki + 1) * bk].float()
        vb = vp[:, :, ki * bk:(ki + 1) * bk].float()
        kb = kb.repeat_interleave(group, dim=1)
        vb = vb.repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        mask = _chunk_mask(Tq, Tk, bk, ki, q_offset, causal, window, q.device)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if p_bf16:
            p = p.to(torch.bfloat16).float()
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    l = l.clamp_min(1e-20)
    out = (acc / l).to(q.dtype)
    return out, m, l
