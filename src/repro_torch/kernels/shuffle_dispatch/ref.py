"""Plain PyTorch oracle for MoE shuffle dispatch/combine (dense one-hot
einsum), the mirror of the JAX package's ``shuffle_dispatch/ref.py``."""
from __future__ import annotations

import torch


def _mask(expert_id: torch.Tensor, slot: torch.Tensor, num_experts: int,
          capacity: int) -> torch.Tensor:
    """[T, K] assignments -> dense dispatch mask [T, E, C] in fp32. A pair
    with expert_id < 0 or outside [0, E), or slot outside [0, C), adds
    nothing; pairs that share an (e, c) add up."""
    return _gated_mask(expert_id, slot, None, num_experts, capacity)


def _gated_mask(expert_id, slot, gates, num_experts: int, capacity: int):
    """Σ_k over the valid pairs of onehot(e) x onehot(c) (x gate), fp32."""
    dev = expert_id.device
    eo = expert_id[..., None] == torch.arange(num_experts, device=dev)
    so = slot[..., None] == torch.arange(capacity, device=dev)
    valid = (expert_id >= 0) & (slot >= 0) & (slot < capacity)
    m = (eo[:, :, :, None] & so[:, :, None, :]
         & valid[:, :, None, None]).float()               # [T, K, E, C]
    if gates is not None:
        m = m * gates.float()[:, :, None, None]
    return m.sum(dim=1)


def dispatch_ref(x: torch.Tensor, expert_id: torch.Tensor, slot: torch.Tensor,
                 num_experts: int, capacity: int) -> torch.Tensor:
    """x: [T, D] -> expert buffers [E, C, D] in x's dtype (fp32 sums)."""
    m = _mask(expert_id, slot, num_experts, capacity)
    return torch.einsum("tec,td->ecd", m, x.float()).to(x.dtype)


def combine_ref(y: torch.Tensor, expert_id: torch.Tensor, slot: torch.Tensor,
                gates: torch.Tensor) -> torch.Tensor:
    """y: [E, C, D] expert outputs -> [T, D] gated combine in y's dtype
    (fp32 sums)."""
    E, C, _ = y.shape
    mg = _gated_mask(expert_id, slot, gates, E, C)        # [T, E, C]
    return torch.einsum("tec,ecd->td", mg, y.float()).to(y.dtype)
