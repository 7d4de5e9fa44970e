"""Public wrappers for MoE shuffle dispatch/combine, slot assignment, and
the host-side dispatch plan.

``dispatch`` and ``combine`` dispatch between the hand-written CUDA kernels
(``impl="kernel"``) and the plain PyTorch oracle (``impl="xla"``,
``ref.dispatch_ref`` / ``ref.combine_ref``, the dense one-hot einsum).

Kernel source note. The kernels (``csrc/shuffle_dispatch.cu``, launched by
``kernel.dispatch_kernel`` and ``kernel.combine_kernel``) replace the Pallas
TPU kernels ``dispatch_kernel`` and ``combine_kernel`` in
``repro/kernels/shuffle_dispatch/kernel.py``. Both move rows and add a few
of them, so their floor on the H100 is memory: at grok-1-314b's prefill
(2048 tokens, top-2, 32 buffers of 160 rows of 6144, bf16) dispatch moves
88 MB (0.026 ms at 3.35 TB/s) and combine 75 MB (0.023 ms); at its decode
(4 tokens) one launch sets the time. The TPU kernels turn both into one-hot
mask products on the MXU; on Hopper they are gathers that sum in registers.
Dispatch is output-stationary and has two routes (``kernel.dispatch_route``,
by the number of pairs). ``walk`` (a prefill): one block of 1024 threads an
SM, each owning an equal run of at most 64 (expert, slot) rows over the whole
width (39 at grok's prefill); its threads read the assignment once with
16-byte loads, and one block-wide scan lists the hits on its rows in token
order in shared memory. A row with at most one listed pair (every row under
served routing) is then a copy of that x row or zeros, each lane keeping 8
16-byte loads in flight; any other row is summed by a warp in fp32
registers, walking its hits in order. Hits past the list's 1024 entries are
found again, in order, by the warp of their row. ``direct`` (at most 64
pairs, a decode step): no walk and no barrier; each warp reads the pairs
straight and adds its row's hits. Either way repeated slots sum in token
order, the bits do not depend on scheduling, and no atomics touch the data.
Combine: a thread takes a 16-byte piece of a token's row, reads the token's
ids and gates for up to four pairs at once (two at grok's top-2), issues
those rows' loads together and sums gate * row in fp32 in k order.

``impl="kernel"`` takes the plain version only when the tensors lie on the
CPU. On CUDA tensors it launches the kernel or raises; it never falls back.
``dispatch.launches`` and ``combine.launches`` count kernel launches, and
``dispatch.launches_by_route`` splits dispatch's by route. Each call of
``dispatch`` and ``combine`` is the program span ``pangea.dispatch`` or
``pangea.combine`` (``repro_torch.trace``).

Training. Under grad (an input that requires it) ``impl="kernel"`` goes
through ``_Dispatch`` and ``_Combine``, whose backwards are launches of each
other's kernels; no backward kernel of its own exists, as the reference
differentiates its einsum. Dispatch's gradient dx[t] = Σ_k dbuf[e_tk, c_tk]
is one combine launch with unit gates (``dispatch.bwd_launches``; fp32
sums in k order, as the forward's). Combine's dy[e, c] = Σ gate_tk *
dout[t] over the pairs on row (e, c) is one dispatch launch of the
gate-weighted rows, [N * K, D] with one pair a row (``combine.bwd_launches``;
at deepseek-v2-lite-16b's training shape 24576 rows, so the ``walk``
route); its dgates[t, k] = dout[t] · y[e_tk, c_tk] is a plain gather and
batched row dot in fp32 (``combine.bwd_calls`` counts the backward's
calls). Both kernel launches count in ``launches`` too. On CPU tensors the
backwards are ``ref.dispatch_bwd_ref`` and ``ref.combine_bwd_ref``. With
grad off the wrappers take the forward path alone, the same launches and
bits as serving.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ... import trace
from .. import local_only
from .kernel import (DISPATCH_ROUTES, combine_kernel, dispatch_kernel,
                     dispatch_route)
from .ref import (combine_bwd_ref, combine_ref, dispatch_bwd_ref,
                  dispatch_ref, pair_rows)


def host_dispatch_plan(partition_ids: np.ndarray, num_partitions: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side slot assignment for node-to-node shuffle transfers — the CPU
    analogue of :func:`compute_slots`: one stable pass groups a batch by
    destination partition. Returns ``(order, counts, offsets)`` such that
    ``batch[order][offsets[p]:offsets[p+1]]`` is partition ``p``'s contiguous
    slice."""
    partition_ids = np.asarray(partition_ids)
    order = np.argsort(partition_ids, kind="stable")
    counts = np.bincount(partition_ids, minlength=num_partitions)
    offsets = np.empty(len(counts) + 1, np.int64)
    offsets[0] = 0
    np.cumsum(counts, out=offsets[1:])
    return order, counts, offsets


def compute_slots(expert_id: torch.Tensor, num_experts: int,
                  capacity: int) -> torch.Tensor:
    """Position of each (token, k) within its expert's capacity buffer: the
    exclusive count of earlier pairs (token-major) with the same expert.

    Pairs beyond capacity get slot >= capacity (dropped downstream) — the
    'virtual shuffle buffer is full' case; a negative expert id gets -1.
    expert_id: [..., T, K] -> slots [..., T, K] int32, counted on its own
    for each index of the leading dims (a batch of rows)."""
    T, K = expert_id.shape[-2:]
    flat = expert_id.reshape(-1, T * K).long()                # priority order
    experts = torch.arange(num_experts, device=flat.device)
    # [rows, E, T*K], so that the count runs along the inner dim
    onehot = (experts[None, :, None] == flat[:, None, :]).int()
    pos = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot
    slot = torch.gather(pos, 1,
                        flat.clamp(0, num_experts - 1)[:, None, :])[:, 0]
    slot = torch.where(flat >= 0, slot, torch.full_like(slot, -1))
    return slot.reshape(expert_id.shape)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def dispatch(x: torch.Tensor, expert_id: torch.Tensor, slot: torch.Tensor,
             num_experts: int, capacity: int, *,
             impl: str = "xla") -> torch.Tensor:
    """x: [N, D]; expert_id, slot: [N, K] -> buffers [E, C, D] in x's dtype,
    row (e, c) the fp32 sum of x over the pairs with expert e and slot c.

    impl: "kernel" (CUDA kernel; the oracle on CPU tensors; under grad
    through ``_Dispatch``) or "xla" (the dense one-hot oracle)."""
    with trace.span("pangea.dispatch"):
        if impl == "kernel":
            if _needs_grad(x):
                return _Dispatch.apply(x, expert_id, slot, num_experts,
                                       capacity)
            return _dispatch_fwd(x, expert_id, slot, num_experts, capacity)
        if impl == "xla":
            return dispatch_ref(x, expert_id, slot, num_experts, capacity)
        raise ValueError(f"unknown impl {impl!r}")


dispatch.launches = 0
dispatch.launches_by_route = dict.fromkeys(DISPATCH_ROUTES, 0)
dispatch.bwd_calls = 0
dispatch.bwd_launches = 0


def _dispatch_fwd(x, expert_id, slot, num_experts, capacity):
    """The dispatch kernel on CUDA tensors (counted), the oracle on CPU
    tensors."""
    local_only(x, expert_id, slot)
    if x.device.type == "cpu":
        return dispatch_ref(x, expert_id, slot, num_experts, capacity)
    out = dispatch_kernel(x.contiguous(), expert_id.int().contiguous(),
                          slot.int().contiguous(), num_experts, capacity)
    dispatch.launches += 1
    dispatch.launches_by_route[dispatch_route(expert_id.numel())] += 1
    return out


def combine(y: torch.Tensor, expert_id: torch.Tensor, slot: torch.Tensor,
            gates: torch.Tensor, num_tokens: int, *,
            impl: str = "xla") -> torch.Tensor:
    """y: [E, C, D]; expert_id, slot, gates: [N, K] -> [N, D] in y's dtype,
    token t the fp32 sum of gate * y[expert, slot] over its valid pairs.
    ``num_tokens`` (N) is the reference's argument; it must equal
    expert_id.shape[0].

    impl: "kernel" (CUDA kernel; the oracle on CPU tensors; under grad
    through ``_Combine``) or "xla" (the dense one-hot oracle)."""
    if num_tokens != expert_id.shape[0]:
        raise ValueError(f"combine: num_tokens {num_tokens} but expert_id "
                         f"has {expert_id.shape[0]} rows")
    with trace.span("pangea.combine"):
        if impl == "kernel":
            if _needs_grad(y, gates):
                return _Combine.apply(y, expert_id, slot, gates)
            return _combine_fwd(y, expert_id, slot, gates)
        if impl == "xla":
            return combine_ref(y, expert_id, slot, gates)
        raise ValueError(f"unknown impl {impl!r}")


combine.launches = 0
combine.bwd_calls = 0
combine.bwd_launches = 0


def _combine_fwd(y, expert_id, slot, gates):
    """The combine kernel on CUDA tensors (counted), the oracle on CPU
    tensors."""
    local_only(y, expert_id, slot, gates)
    if y.device.type == "cpu":
        return combine_ref(y, expert_id, slot, gates)
    out = combine_kernel(y.contiguous(), expert_id.int().contiguous(),
                         slot.int().contiguous(), gates.contiguous())
    combine.launches += 1
    return out


class _Dispatch(torch.autograd.Function):
    """``dispatch`` under grad. dx[t] = Σ_k dbuf[e_tk, c_tk] over the kept
    pairs: combine with unit gates, one combine launch on CUDA tensors
    (``dispatch.bwd_launches``), ``dispatch_bwd_ref`` on CPU tensors."""

    @staticmethod
    def forward(ctx, x, expert_id, slot, num_experts, capacity):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(expert_id, slot)
        return _dispatch_fwd(x, expert_id, slot, num_experts, capacity)

    @staticmethod
    def backward(ctx, dbuf):
        if dbuf is None:
            return (None,) * 5
        expert_id, slot = ctx.saved_tensors
        dispatch.bwd_calls += 1
        if dbuf.device.type == "cpu":
            dx = dispatch_bwd_ref(dbuf, expert_id, slot)
        else:
            ones = torch.ones(expert_id.shape, dtype=torch.float32,
                              device=dbuf.device)
            dx = _combine_fwd(dbuf, expert_id, slot, ones)
            dispatch.bwd_launches += 1
        return dx, None, None, None, None


class _Combine(torch.autograd.Function):
    """``combine`` under grad. dy is the dispatch of the gate-weighted rows
    gate_tk * dout[t], [N * K, D] in y's dtype with one pair a row: one
    dispatch launch on CUDA tensors (``combine.bwd_launches``). dgates[t, k]
    = dout[t] · y[e_tk, c_tk] (0 for a dropped pair) is a plain gather and
    row dot in fp32. ``combine.bwd_calls`` counts the backward's calls; on
    CPU tensors both come from ``combine_bwd_ref``."""

    @staticmethod
    def forward(ctx, y, expert_id, slot, gates):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(y, expert_id, slot, gates)
        return _combine_fwd(y, expert_id, slot, gates)

    @staticmethod
    def backward(ctx, dout):
        if dout is None:
            return (None,) * 4
        y, expert_id, slot, gates = ctx.saved_tensors
        need_y, need_g = ctx.needs_input_grad[0], ctx.needs_input_grad[3]
        combine.bwd_calls += 1
        if dout.device.type == "cpu":
            dy, dgates = combine_bwd_ref(dout, y, expert_id, slot, gates)
            return (dy if need_y else None), None, None, \
                (dgates if need_g else None)
        dy = dgates = None
        E, C, D = y.shape
        N, K = expert_id.shape
        if need_y:
            rows = (dout[:, None, :] * gates[..., None]).to(y.dtype)
            dy = _dispatch_fwd(rows.reshape(N * K, D),
                               expert_id.reshape(N * K, 1),
                               slot.reshape(N * K, 1), E, C)
            combine.bwd_launches += 1
        if need_g:
            dgates = combine_dgates(dout, y, expert_id, slot).to(gates.dtype)
        return dy, None, None, dgates


def combine_dgates(dout, y, expert_id, slot):
    """dgates[t, k] = dout[t] · y[e_tk, c_tk] in fp32, 0 for a dropped pair
    (id outside [0, E) or slot outside [0, C)): a gather of the pairs'
    rows and one batched product."""
    E, C, D = y.shape
    rows, valid = pair_rows(expert_id, slot, E, C)
    yr = y.reshape(E * C, D).index_select(0, rows.reshape(-1)).reshape(
        *rows.shape, D)
    dg = torch.bmm(yr.float(), dout.float()[:, :, None])[..., 0]
    return torch.where(valid, dg, torch.zeros((), device=dg.device))
