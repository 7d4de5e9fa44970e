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


def pair_rows(expert_id, slot, num_experts: int, capacity: int):
    """Each pair's flat row e * C + c (clamped into range) and whether the
    pair is kept: 0 <= e < E and 0 <= c < C."""
    valid = ((expert_id >= 0) & (expert_id < num_experts) & (slot >= 0)
             & (slot < capacity))
    rows = (expert_id.long().clamp(0, max(num_experts - 1, 0)) * capacity
            + slot.long().clamp(0, max(capacity - 1, 0)))
    return rows, valid


def dispatch_bwd_ref(dbuf: torch.Tensor, expert_id: torch.Tensor,
                     slot: torch.Tensor) -> torch.Tensor:
    """The gradient of ``dispatch_ref`` for the cotangent ``dbuf`` [E, C, D]:
    dx[t] = Σ_k dbuf[e_tk, c_tk] over token t's kept pairs (fp32 sums in k
    order), [T, D] in dbuf's dtype; a dropped pair adds nothing. It is
    ``combine_ref`` with unit gates."""
    E, C, D = dbuf.shape
    rows, valid = pair_rows(expert_id, slot, E, C)
    g = dbuf.reshape(E * C, D).float()[rows.reshape(-1)].reshape(
        *rows.shape, D)
    g = torch.where(valid[..., None], g, torch.zeros((), device=g.device))
    dx = g[:, 0]
    for k in range(1, g.shape[1]):
        dx = dx + g[:, k]
    return dx.to(dbuf.dtype)


def combine_bwd_ref(dout: torch.Tensor, y: torch.Tensor,
                    expert_id: torch.Tensor, slot: torch.Tensor,
                    gates: torch.Tensor):
    """The gradients of ``combine_ref`` for the cotangent ``dout`` [T, D]:
    dy[e, c] = Σ over the kept pairs (t, k) on row (e, c) of gate_tk *
    dout[t], [E, C, D] in y's dtype (repeated rows sum); dgates[t, k] =
    dout[t] · y[e_tk, c_tk], 0 for a dropped pair, [T, K] in gates' dtype.
    Both in fp32."""
    E, C, D = y.shape
    rows, valid = pair_rows(expert_id, slot, E, C)
    df = dout.float()
    tok, k = torch.nonzero(valid, as_tuple=True)
    dy = torch.zeros((E * C, D), dtype=torch.float32, device=y.device)
    dy.index_add_(0, rows[tok, k], gates.float()[tok, k, None] * df[tok])
    yr = y.reshape(E * C, D).float()[rows.reshape(-1)].reshape(*rows.shape, D)
    dg = torch.where(valid, (yr * df[:, None, :]).sum(-1),
                     torch.zeros((), device=y.device))
    return dy.reshape(E, C, D).to(y.dtype), dg.to(gates.dtype)
