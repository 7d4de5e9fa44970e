"""Public wrapper for flash attention.

Dispatches between the hand-written CUDA kernel (``impl="kernel"``), a
chunked plain-PyTorch path (``impl="xla"``, the mirror of the reference's
``lax.scan`` online softmax over kv blocks) and the naive oracle
(``impl="naive"``). Handles padding to block multiples and GQA as the
reference does.

Kernel source note. The kernel (``csrc/flash_attention.cu``, launched by
``kernel.flash_attention_kernel``) replaces the Pallas TPU kernel
``flash_attention_kernel`` in ``repro/kernels/flash_attention/kernel.py``.
At the slice's prefill shapes its floor on the H100 is memory (q, k, v and
out once over 3.35 TB/s; ~25 MB at B=4, H=16, T=512, D=128 in bf16), but
this first version computes with scalar fp32 FMAs out of shared memory, so
it is bound by shared-memory loads and FMA throughput. Its design keeps the
online-softmax state in registers, stages one 64-key tile of k and v in
shared memory per step and skips masked tiles through the loop bounds;
tensor-core tiles are later work.

``impl="kernel"`` takes the plain version (``ref.attention_ref``, on the
unpadded inputs) only when the tensors lie on the CPU. On CUDA tensors it
pads, launches the kernel or raises; it never falls back.
``flash_attention.launches`` counts kernel launches.

The custom VJP of the reference's chunked path waits for the training slice:
this port is forward only.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .kernel import flash_attention_kernel
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
    """q [B,H,Tq,D], k/v [B,KH,Tk,D] -> [B,H,Tq,D].

    impl: "kernel" (CUDA kernel; its plain version on CPU tensors), "xla"
    (chunked online softmax in plain PyTorch), "naive" (reference; O(T^2)
    memory). ``p_bf16``: cast softmax weights to bf16 for the PV product
    ("xla" only, as in the reference).
    """
    if impl == "naive" or (impl == "kernel" and q.device.type == "cpu"):
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset)
    if impl == "kernel":
        Tq, Tk = q.shape[2], k.shape[2]
        bq, bk = min(block_q, Tq), min(block_k, Tk)
        out = flash_attention_kernel(
            _pad_to(q, 2, bq), _pad_to(k, 2, bk), _pad_to(v, 2, bk),
            causal=causal, window=window, scale=scale, q_offset=q_offset,
            kv_len=Tk)
        flash_attention.launches += 1
        return out[:, :, :Tq]
    if impl == "xla":
        if scale is None:
            scale = q.shape[-1] ** -0.5
        out, _, _ = _attn_fwd_core(q, k, v, causal, window, scale, q_offset,
                                   block_k, p_bf16)
        return out
    raise ValueError(f"unknown impl {impl!r}")


flash_attention.launches = 0


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
