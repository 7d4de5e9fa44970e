"""AdamW with a configurable moment dtype (bf16 moments for the largest
archs), written by hand as the JAX package's ``optim/adamw.py``.

``torch.optim.AdamW`` is not a port of it: it decays every param, where
the reference decays only the leaves of rank >= 2. The update is
functional: it returns new tensors and changes none it was given, so that
an asynchronous checkpoint of a state never sees the next step's values.
Moments are kept in ``opt_state_dtype``; the arithmetic runs in fp32.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.lm import torch_dtype, tree_map

Pytree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 scalar, on the params' device
    m: Pytree
    v: Pytree


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def adamw_init(params: Pytree, dtype: str = "float32") -> AdamWState:
    dt = torch_dtype(dtype)
    first = _leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(params: Pytree, grads: Pytree, state: AdamWState, *,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step with bias correction; weight decay only on leaves of
    rank >= 2 (matrices), as the reference's. Returns (params, state), both
    new."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        gf = g.float()
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
        if p.dim() >= 2:  # decay matrices only (standard practice)
            update = update + weight_decay * p.float()
        newp = p.float() - lr * update
        return newp.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    out = [upd(p, g, m, v) for p, g, m, v in
           zip(_leaves(params), _leaves(grads), _leaves(state.m),
               _leaves(state.v))]
    new_p = _unflatten_like(params, [o[0] for o in out])
    new_m = _unflatten_like(params, [o[1] for o in out])
    new_v = _unflatten_like(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, m=new_m, v=new_v)
