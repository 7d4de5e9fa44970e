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
``dispatch.launches_by_route`` splits dispatch's by route.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .kernel import (DISPATCH_ROUTES, combine_kernel, dispatch_kernel,
                     dispatch_route)
from .ref import combine_ref, dispatch_ref


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


def dispatch(x: torch.Tensor, expert_id: torch.Tensor, slot: torch.Tensor,
             num_experts: int, capacity: int, *,
             impl: str = "xla") -> torch.Tensor:
    """x: [N, D]; expert_id, slot: [N, K] -> buffers [E, C, D] in x's dtype,
    row (e, c) the fp32 sum of x over the pairs with expert e and slot c.

    impl: "kernel" (CUDA kernel; the oracle on CPU tensors) or "xla" (the
    dense one-hot oracle)."""
    if impl == "kernel":
        if x.device.type == "cpu":
            return dispatch_ref(x, expert_id, slot, num_experts, capacity)
        out = dispatch_kernel(x.contiguous(), expert_id.int().contiguous(),
                              slot.int().contiguous(), num_experts, capacity)
        dispatch.launches += 1
        dispatch.launches_by_route[dispatch_route(expert_id.numel())] += 1
        return out
    if impl == "xla":
        return dispatch_ref(x, expert_id, slot, num_experts, capacity)
    raise ValueError(f"unknown impl {impl!r}")


dispatch.launches = 0
dispatch.launches_by_route = dict.fromkeys(DISPATCH_ROUTES, 0)


def combine(y: torch.Tensor, expert_id: torch.Tensor, slot: torch.Tensor,
            gates: torch.Tensor, num_tokens: int, *,
            impl: str = "xla") -> torch.Tensor:
    """y: [E, C, D]; expert_id, slot, gates: [N, K] -> [N, D] in y's dtype,
    token t the fp32 sum of gate * y[expert, slot] over its valid pairs.
    ``num_tokens`` (N) is the reference's argument; it must equal
    expert_id.shape[0].

    impl: "kernel" (CUDA kernel; the oracle on CPU tensors) or "xla" (the
    dense one-hot oracle)."""
    if num_tokens != expert_id.shape[0]:
        raise ValueError(f"combine: num_tokens {num_tokens} but expert_id "
                         f"has {expert_id.shape[0]} rows")
    if impl == "kernel":
        if y.device.type == "cpu":
            return combine_ref(y, expert_id, slot, gates)
        out = combine_kernel(y.contiguous(), expert_id.int().contiguous(),
                             slot.int().contiguous(), gates.contiguous())
        combine.launches += 1
        return out
    if impl == "xla":
        return combine_ref(y, expert_id, slot, gates)
    raise ValueError(f"unknown impl {impl!r}")


combine.launches = 0
