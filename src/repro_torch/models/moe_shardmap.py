"""Expert-parallel MoE without a dense dispatch mask.

The reference (``repro/models/moe_shardmap.py``) runs this path inside
``shard_map`` over a "model" mesh axis: each shard gathers its experts'
tokens by a sort (no dense [B, T, E, C] mask), runs its experts, scatters
the gated outputs back and sums the shards with one ``psum``. Without a
mesh it takes its single-device branch, ``_local_moe``. Both branches are
ported, and both gather and scatter through the shuffle kernels
(``dispatch`` / ``combine``): the slots of ``compute_slots`` over the flat
ids are the positions ``_dispatch_indices`` (the reference's sort-based
index form of the same grouping) gives.

The mesh branch (a mesh with a "model" axis, from ``mesh=`` or the active
``sharding.use_rules``) runs under ``local_map``: the tokens sharded over
the data axes ("pod", "data") and whole on every "model" shard, the expert
weights split over "model" on their experts dim. Each shard counts the
slots of its tokens over all E experts, shifts the ids by -shard * E_loc so
that dispatch and combine drop the other shards' pairs, runs its E_loc
experts, and returns a partial sum that one all-reduce over "model"
completes, as the reference's ``psum``. Under grad, each shard's
gradients of the tokens and gates are partial sums over "model" (its own
experts) and those of the expert weights partial sums over the data axes
(its own tokens); autograd runs dispatch and combine as each other's
backward.

Selected with ``moe_strategy="expert_parallel_shardmap"``. Capacity is
counted over the tokens of one data shard (all B*T tokens without a mesh),
and the aux loss from every routed pair, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from ..configs.base import ArchConfig
from ..kernels.shuffle_dispatch.ops import combine, compute_slots, dispatch
from ..sharding import (coordinate, get_mesh, local_call, mesh_axis_names,
                        mesh_sizes, use_rules)
from . import blocks


def moe_shardmap_init(gen: torch.Generator, cfg: ArchConfig,
                      lead: Tuple[int, ...] = (), dtype=None):
    """Same parameter structure as ``blocks.moe_init`` (the reference's
    differs only in its sharding axes)."""
    return blocks.moe_init(gen, cfg, lead=lead, dtype=dtype)


def moe_shardmap_axes(cfg: ArchConfig):
    """``blocks.moe_axes`` with the expert weights sharded on "experts"
    alone: each "model" shard holds whole experts."""
    a = blocks.moe_axes(cfg)
    for w in ("w1", "w3", "w2"):
        a[w] = ("experts",) + (None,) * (len(a[w]) - 1)
    return a


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
    """Capacity over the tokens one shard dispatches (all of the call's
    tokens without a mesh)."""
    E, K = cfg.n_experts, cfg.top_k
    return max(4, -(-int(n_tokens * K * cfg.capacity_factor / E) // 4) * 4)


def moe_shardmap_apply(p, x, *, cfg: ArchConfig, mesh=None):
    """Drop-in replacement for ``blocks.moe_apply`` (same (y, aux)
    contract). ``mesh``: a ``DeviceMesh`` with a "model" axis (default: the
    active rules' mesh) takes the expert-parallel branch; without one the
    single-device branch runs."""
    mesh = mesh if mesh is not None else get_mesh()
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    sizes = mesh_sizes(mesh) if mesh is not None else {}
    dp_size = sizes.get("pod", 1) * sizes.get("data", 1)
    C = _capacity(cfg, max(B * T // dp_size, 1))
    h = blocks.apply_norm(cfg, p.get("norm"), x)
    probs, gates, eid = blocks.moe_route(p["w_router"], h, K)
    gates = gates.to(h.dtype)
    # each expert's routed pairs (exact counts; the same under a mesh)
    hits = eid[..., None] == torch.arange(E, device=x.device)
    density = hits.sum(dim=(0, 1, 2)).float() / (B * T * K)
    aux = ((density * probs.mean(dim=(0, 1))).sum() * E).float()
    if "model" not in sizes:
        return _local_moe(p, x, h, eid, gates, cfg, C), aux
    if get_mesh() is not mesh:
        with use_rules({}, mesh):
            return _mesh_moe(p, x, h, eid, gates, cfg, C, mesh), aux
    return _mesh_moe(p, x, h, eid, gates, cfg, C, mesh), aux


def _mesh_moe(p, x, h, eid, gates, cfg: ArchConfig, C: int, mesh):
    """The expert-parallel branch: ``local_map`` over the data-sharded
    tokens and the experts split over "model", one dispatch and one
    combine launch a shard, then the all-reduce over "model"."""
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    names = mesh_axis_names(mesh)
    n_model = mesh_sizes(mesh)["model"]
    if E % n_model:
        raise ValueError(f"{E} experts do not split over {n_model} shards")
    E_loc = E // n_model
    dp = [n for n in names if n in ("pod", "data")]
    tok = tuple(Shard(0) if n in dp else Replicate() for n in names)
    wts = tuple(Shard(0) if n == "model" else Replicate() for n in names)
    part = tuple(Partial() if n == "model" else pl
                 for n, pl in zip(names, tok))
    # gradients: each "model" shard's dh and dgates cover its own experts,
    # each data rank's dW its own tokens; both are partial sums
    wgrad = tuple(Partial() if n in dp else pl
                  for n, pl in zip(names, wts))
    shard = coordinate("model")

    def local(hf, eidf, gatesf, w1, w3, w2):
        # slots over all E experts (the reference's global grouping), then
        # ids shifted so that the kernels keep this shard's experts only
        slot = compute_slots(eidf, E, C)
        mine = eidf - shard * E_loc
        buf = dispatch(hf, mine, slot, E_loc, C, impl="kernel")
        out = blocks._experts({"w1": w1, "w3": w3, "w2": w2}, buf[None])[0]
        return combine(out, mine, slot, gatesf, hf.shape[0], impl="kernel")

    y = local_call(local, (h.reshape(B * T, d), eid.reshape(B * T, K),
                           gates.reshape(B * T, K), p["w1"], p["w3"],
                           p["w2"]),
                   (tok, tok, tok, wts, wts, wts), part,
                   (part, tok, part, wgrad, wgrad, wgrad))
    y = y.redistribute(mesh, tok).reshape(B, T, d).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + blocks.shared_experts(p["shared"], h)
    return x + y


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
