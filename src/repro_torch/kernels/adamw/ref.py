"""Plain PyTorch AdamW update of one leaf, as the JAX package's
``optim/adamw.py`` computes it."""
from __future__ import annotations

import torch


def adamw_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, t: torch.Tensor, lr: float, b1: float,
              b2: float, eps: float, weight_decay: float):
    """One leaf's new (param, m, v) at step ``t`` (an fp32 tensor), each a
    new tensor in its input's dtype; the arithmetic in fp32. Weight decay
    only where the leaf has rank >= 2."""
    gf = g.float()
    mf = b1 * m.float() + (1 - b1) * gf
    vf = b2 * v.float() + (1 - b2) * gf * gf
    update = (mf / (1.0 - b1 ** t)) / (torch.sqrt(vf / (1.0 - b2 ** t)) + eps)
    if p.dim() >= 2:  # decay matrices only (standard practice)
        update = update + weight_decay * p.float()
    newp = p.float() - lr * update
    return newp.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)
