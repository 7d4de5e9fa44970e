"""AdamW with a configurable moment dtype (bf16 moments for the largest
archs), written by hand as the JAX package's ``optim/adamw.py``.

``torch.optim.AdamW`` is not a port of it: it decays every param, where
the reference decays only the leaves of rank >= 2. ``adamw_update`` is
functional, as the reference's: it returns new tensors and changes none
it was given. ``adamw_apply``, the train step's update, writes the same
values into the state's own tensors and frees each gradient as it goes,
as the reference's ``run_training`` donates the state to its jitted step
(``donate_argnums=(0,)``): a 3 B-param fp32 state is 37 GB and its
gradients 12 GB, so old state, gradients and new state do not fit one
card together. Moments are kept in ``opt_state_dtype``; the arithmetic
runs in fp32. A leaf's arithmetic is ``kernels.adamw``'s: ``adamw_update``
runs its plain version (``adamw_ref``), ``adamw_apply`` its wrapper, which
on the card is one launch of a hand-written CUDA kernel a leaf with the
plain version's bits.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..kernels.adamw import adamw, adamw_ref, bias_corrections
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
    # zeros_like: a DTensor param gets moments of its own placements
    zeros = lambda p: torch.zeros_like(p, dtype=dt)
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
    out = [adamw_ref(p, g, m, v, t, lr, b1, b2, eps, weight_decay)
           for p, g, m, v in zip(_leaves(params), _leaves(grads),
                                 _leaves(state.m), _leaves(state.v))]
    new_p = _unflatten_like(params, [o[0] for o in out])
    new_m = _unflatten_like(params, [o[1] for o in out])
    new_v = _unflatten_like(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, m=new_m, v=new_v)


@torch.no_grad()
def adamw_apply(params: Pytree, grads: list, state: AdamWState, *,
                lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                eps: float = 1e-8, weight_decay: float = 0.1):
    """``adamw_update`` in place: the new params and moments (the same
    values, bit for bit) are written into ``params``' and ``state``'s own
    tensors, which are returned with the new step. ``grads`` is a list of
    leaves in the params' leaf order; each entry is set to None once its
    leaf is updated, so that the gradients are freed as the update goes.
    Each leaf is one call of ``kernels.adamw.adamw`` (on the card one
    kernel launch), the bias corrections computed once for all of them."""
    step = state.step + 1
    t = step.float()
    bias = bias_corrections(t, b1, b2)
    for i, (p, m, v) in enumerate(zip(_leaves(params), _leaves(state.m),
                                      _leaves(state.v))):
        g, grads[i] = grads[i], None
        adamw(p, g, m, v, t, bias, lr=lr, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
        del g
    return params, AdamWState(step=step, m=state.m, v=state.v)
