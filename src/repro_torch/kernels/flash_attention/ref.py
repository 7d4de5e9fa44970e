"""Plain PyTorch oracle for flash attention (causal / sliding-window / GQA).

GQA groups query heads per kv head (einsum batch dim) rather than repeating
k/v, as the JAX reference does."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None,
                  q_offset: int = 0, return_lse: bool = False
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Naive softmax attention.

    q: [B, H, Tq, D]; k, v: [B, KH, Tk, D] with H % KH == 0 (GQA).
    ``window``: sliding-window size (keys within ``window`` positions before
    the query, inclusive). ``q_offset``: global position of q[..., 0, :]
    relative to k (decode: Tk - Tq). ``return_lse``: also return each
    row's log-sum-exp of the scaled scores over its live keys, [B, H, Tq]
    in fp32, +inf for a row with no live key (whose output is 0), as the
    CUDA kernels write it.
    """
    B, H, Tq, D = q.shape
    KH, Tk = k.shape[1], k.shape[2]
    G = H // KH
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, KH, G, Tq, D).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * scale
    q_pos = torch.arange(Tq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.exp(s - s.amax(dim=-1, keepdim=True)))
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    denom = p.sum(dim=-1, keepdim=True)
    o = o / denom.clamp_min(1e-20)
    Dv = v.shape[-1]
    o = o.reshape(B, H, Tq, Dv).to(q.dtype)
    if not return_lse:
        return o
    denom = denom[..., 0]
    lse = torch.where(denom > 0, s.amax(dim=-1) + torch.log(denom),
                      torch.full_like(denom, float("inf")))
    return o, lse.reshape(B, H, Tq)
