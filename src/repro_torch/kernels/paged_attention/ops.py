"""Public wrapper for paged decode attention over the KV page pool.

Kernel source note. The kernel (``csrc/paged_attention.cu``, launched by
``kernel.paged_attention_kernel``) replaces the Pallas TPU kernel
``paged_attention_kernel`` in ``repro/kernels/paged_attention/kernel.py``.
Decode attention is bound by memory on the H100: it reads every live K/V
byte of the pool once and does 4 G flops per K/V element pair, so its floor
is the live K/V bytes over 3.35 TB/s. The design reads pages in place
through the block table (no gather into a dense buffer) and makes one launch
a call: a thread-block cluster of up to 8 blocks shares a (sequence, kv
head), its blocks take that sequence's live keys in turn, and they merge
their softmax statistics through distributed shared memory at the end
(``kernel.split_plan`` sizes the cluster from how many the card runs at
once). Each block streams its K and V rows through a 3-stage ring in
shared memory, filled by the copy engine (TMA boxes of a page's rows) or,
where a box cannot hold a row, by 16-byte ``cp.async`` copies; a bf16 pool
is scored and summed on tensor cores (``mma.sync``), an fp32 pool in fp32
FMAs with a lane a key. The ``.cu`` header has the details.

``impl="kernel"`` takes the plain version (``ref.paged_attention_ref``) only
when the tensors lie on the CPU. On CUDA tensors it launches the kernel or
raises; it never falls back. ``paged_attention.launches`` counts kernel
launches, and ``paged_attention.launches_by_route`` splits them by the
pool's dtype (``kernel.ROUTES``: fp32, bf16). The contract holds for
lengths >= 1: at length 0 the kernel gives 0 and the plain version a mean
over page 0, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import ROUTES, paged_attention_kernel
from .ref import paged_attention_ref


def paged_attention(q: torch.Tensor, kv_pages: torch.Tensor, block_tables,
                    lengths, *, scale: Optional[float] = None,
                    impl: str = "xla") -> torch.Tensor:
    """Decode attention over a paged KV pool. ``block_tables`` and
    ``lengths`` may be numpy arrays or tensors; they go to q's device as
    int32.

    impl: "kernel" (CUDA kernel; its plain version on CPU tensors) or "xla"
    (gather-based plain PyTorch).
    """
    block_tables = torch.as_tensor(block_tables, dtype=torch.int32,
                                   device=q.device).contiguous()
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=q.device).contiguous()
    if impl == "kernel":
        if q.device.type == "cpu":
            return paged_attention_ref(q, kv_pages, block_tables, lengths,
                                       scale=scale)
        out = paged_attention_kernel(q, kv_pages, block_tables, lengths,
                                     scale=scale)
        paged_attention.launches += 1
        paged_attention.launches_by_route[ROUTES[q.dtype]] += 1
        return out
    if impl == "xla":
        return paged_attention_ref(q, kv_pages, block_tables, lengths,
                                   scale=scale)
    raise ValueError(f"unknown impl {impl!r}")


paged_attention.launches = 0
paged_attention.launches_by_route = dict.fromkeys(ROUTES.values(), 0)
