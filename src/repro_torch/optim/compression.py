"""Gradient compression for the cross-pod all-reduce, as the JAX package's
``optim/compression.py``: per-tensor int8 quantisation with error feedback
(the residual is carried to the next step, so the compression is unbiased
over time). The reference's ``pmean`` over a mesh axis is an averaging
``all_reduce`` over a ``torch.distributed`` process group here.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from .adamw import _leaves, _unflatten_like

Pytree = Any


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 tensor, fp32 scale)."""
    amax = g.abs().max().float()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_allreduce(grads: Pytree, group=None,
                         error: Optional[Pytree] = None
                         ) -> Tuple[Pytree, Pytree]:
    """The mean over ``group`` of int8-quantised grads, with error feedback.

    ``group=None`` (the reference's ``axis_name=None``) quantises and
    dequantises locally; a process group (``torch.distributed``) averages
    the dequantised grads with one ``all_reduce`` a leaf. Returns (averaged
    grads, new error residuals).
    """
    flat_g = _leaves(grads)
    flat_e = ([torch.zeros_like(g, dtype=torch.float32) for g in flat_g]
              if error is None else _leaves(error))
    outs, errs = [], []
    for g, e in zip(flat_g, flat_e):
        corrected = g.float() + e
        q, scale = compress_int8(corrected)
        deq = decompress_int8(q, scale)
        errs.append(corrected - deq)
        if group is not None:
            dist.all_reduce(deq, group=group)
            deq = deq / dist.get_world_size(group)
        outs.append(deq.to(g.dtype))
    return _unflatten_like(grads, outs), _unflatten_like(grads, errs)
