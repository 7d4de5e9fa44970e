"""Public wrapper for AdamW's update of one leaf, in place.

Kernel source note. The kernel (``csrc/adamw.cu``, launched by
``kernel.adamw_kernel``) replaces no TPU kernel: the JAX package's
``optim/adamw.py`` writes the update as jnp ops, which XLA fuses into one
pass a leaf. In eager PyTorch the same ops (``ref.adamw_ref``) are some 20
full-size launches a leaf, each writing an fp32 temporary that the next
reads back, then three copies into the state. The update reads p, g, m and
v once and writes p, m and v once: 28 bytes a parameter in fp32, so its
floor on the H100 is memory. The kernel is that one pass: one launch a
leaf, a grid-stride loop with 16-byte loads and evict-first stores, every
intermediate in fp32 registers, each op rounded apart in the plain
version's order, so it gives the plain version's bits on the card. Its
routes (``kernel.kernel_route``) depend on the tensors' alignment alone.

``adamw`` takes the plain version only when the tensors lie off the card:
on the CPU, or on ``meta`` (the dry-run's step, which holds no data). On
CUDA tensors it launches the kernel or raises; it never falls back. A
DTensor leaf is updated through its local shards, its gradient first
redistributed to the param's placements. ``adamw.launches`` counts kernel
launches and ``adamw.launches_by_route`` splits them by route.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import DTensor

from .kernel import ROUTES, adamw_kernel
from .ref import adamw_ref


def bias_corrections(t: torch.Tensor, b1: float, b2: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1 - b1**t, 1 - b2**t) on t's device, by the plain version's own
    ops: computed once a step for every leaf's launch."""
    return 1.0 - b1 ** t, 1.0 - b2 ** t


def adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
          v: torch.Tensor, t: torch.Tensor,
          bias: Tuple[torch.Tensor, torch.Tensor], *, lr: float, b1: float,
          b2: float, eps: float, weight_decay: float) -> None:
    """One AdamW step of one leaf at step ``t`` (an fp32 tensor): p, m and
    v take ``ref.adamw_ref``'s values in place. ``bias``: the step's
    ``bias_corrections(t, b1, b2)``, which the kernel reads."""
    if not p.is_cuda:
        for old, new in zip((p, m, v), adamw_ref(p, g, m, v, t, lr, b1, b2,
                                                 eps, weight_decay)):
            old.copy_(new)
        return
    if isinstance(p, DTensor):
        if g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        p, g, m, v = (x.to_local() for x in (p, g, m, v))
    route = adamw_kernel(p, g, m, v, *bias, lr=lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay)
    adamw.launches += 1
    adamw.launches_by_route[route] += 1


adamw.launches = 0
adamw.launches_by_route = dict.fromkeys(ROUTES, 0)
