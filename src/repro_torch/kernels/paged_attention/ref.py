"""Plain PyTorch oracle for paged decode attention."""
from __future__ import annotations

import torch


def paged_attention_ref(q: torch.Tensor, kv_pages: torch.Tensor,
                        block_tables: torch.Tensor, lengths: torch.Tensor,
                        scale=None) -> torch.Tensor:
    """q: [B, H, D]; kv_pages: [P, page, 2, KH, D];
    block_tables: [B, max_pages] int (physical page ids, -1 absent);
    lengths: [B] int. Returns [B, H, D].

    At length 0 every score is masked and the result is the mean of V over
    the table's pages, as in the JAX reference (the kernel gives 0 there)."""
    B, H, D = q.shape
    P, page, _, KH, _ = kv_pages.shape
    block_tables = torch.as_tensor(block_tables, device=q.device)
    lengths = torch.as_tensor(lengths, device=q.device)
    max_pages = block_tables.shape[1]
    group = H // KH
    if scale is None:
        scale = D ** -0.5
    # gather each sequence's pages -> [B, max_pages, page, 2, KH, D]
    safe = block_tables.clamp_min(0).long()
    gathered = kv_pages[safe]
    k = gathered[..., 0, :, :].reshape(B, max_pages * page, KH, D)
    v = gathered[..., 1, :, :].reshape(B, max_pages * page, KH, D)
    kk = k.repeat_interleave(group, dim=2)   # [B, T, H, D]
    vv = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kk.float()) * scale
    pos = torch.arange(max_pages * page, device=q.device)[None, :]
    mask = pos < lengths[:, None]
    s = torch.where(mask[:, None, :], s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bht,bthd->bhd", p, vv.float())
    return (o / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)).to(q.dtype)
