"""Expert-parallel MoE without a dense dispatch mask, at world size 1.

The reference (``repro/models/moe_shardmap.py``) runs this path inside
``shard_map`` over a "model" mesh axis: each shard gathers its experts'
tokens by a sort (no dense [B, T, E, C] mask), runs its experts, scatters
the gated outputs back and sums the shards with one ``psum``. Without a
mesh it takes its single-device branch, ``_local_moe``; that branch is what
this module ports, so the ``psum`` is the identity, and it gathers and
scatters through the shuffle kernels (``dispatch`` / ``combine``).
``_dispatch_indices`` is the reference's sort-based index form of the same
grouping. The mesh branch waits for the sharding layer.

Selected with ``moe_strategy="expert_parallel_shardmap"``. Capacity is
counted over all B*T tokens of the call (not per batch row), and the aux
loss from every routed pair, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.shuffle_dispatch.ops import combine, compute_slots, dispatch
from . import blocks


def moe_shardmap_init(gen: torch.Generator, cfg: ArchConfig,
                      lead: Tuple[int, ...] = (), dtype=None):
    """Same parameter structure as ``blocks.moe_init`` (the reference's
    differs only in its sharding axes)."""
    return blocks.moe_init(gen, cfg, lead=lead, dtype=dtype)


def _dispatch_indices(eid_flat: torch.Tensor, E: int, C: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (token·K) expert assignments -> per-expert index matrix.

    Returns (idx [E, C] into the flat assignment array, valid [E, C]).
    Stable grouping: tokens keep arrival order within an expert."""
    N = eid_flat.shape[0]
    ar = torch.arange(N, device=eid_flat.device)
    order = torch.argsort(eid_flat.long() * (N + 1) + ar)
    counts = torch.bincount(torch.clamp_min(eid_flat.long(), 0), minlength=E)
    offsets = torch.cumsum(counts, 0) - counts            # exclusive
    cols = torch.arange(C, device=eid_flat.device)
    pos = offsets[:, None] + cols[None, :]                # [E, C]
    valid = cols[None, :] < counts[:, None]
    idx = order[torch.clamp(pos, 0, N - 1)]
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


def _capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Capacity over the call's tokens (one data shard at world size 1)."""
    E, K = cfg.n_experts, cfg.top_k
    return max(4, -(-int(n_tokens * K * cfg.capacity_factor / E) // 4) * 4)


def moe_shardmap_apply(p, x, *, cfg: ArchConfig, mesh=None):
    """Drop-in replacement for ``blocks.moe_apply`` (same (y, aux)
    contract), at world size 1."""
    if mesh is not None:
        raise NotImplementedError("moe_shardmap_apply: the mesh branch is "
                                  "not ported; pass mesh=None")
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, max(B * T, 1))
    h = blocks.apply_norm(cfg, p.get("norm"), x)
    probs, gates, eid = blocks.moe_route(p["w_router"], h, K)
    gates = gates.to(h.dtype)
    density = torch.zeros(E, dtype=torch.float32, device=x.device)
    density.index_add_(0, eid.reshape(-1),
                       torch.ones(eid.numel(), device=x.device))
    density = density / (B * T * K)
    aux = ((density * probs.mean(dim=(0, 1))).sum() * E).float()
    return _local_moe(p, x, h, eid, gates, cfg, C), aux


def _local_moe(p, x, h, eid, gates, cfg: ArchConfig, C: int):
    """Single-device dispatch with the reference's semantics (one capacity
    over all B*T tokens, arrival order within an expert) through the
    shuffle kernels: the slots of ``compute_slots`` over the flat [B*T, K]
    ids are the positions ``_dispatch_indices`` gives."""
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    flat_eid = eid.reshape(B * T, K)
    slot = compute_slots(flat_eid, E, C)
    buf = dispatch(h.reshape(-1, d), flat_eid, slot, E, C, impl="kernel")
    out = blocks._experts(p, buf[None])[0]                # [E, C, d]
    y = combine(out, flat_eid, slot, gates.reshape(-1, K), B * T,
                impl="kernel")
    y = y.reshape(B, T, d).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + blocks.shared_experts(p["shared"], h)
    return x + y
