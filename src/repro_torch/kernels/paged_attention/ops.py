"""Public wrapper for paged decode attention over the KV page pool.

Kernel source note. The kernel (``csrc/paged_attention.cu``, launched by
``kernel.paged_attention_kernel``) replaces the Pallas TPU kernel
``paged_attention_kernel`` in ``repro/kernels/paged_attention/kernel.py``.
Decode attention is bound by memory on the H100: it reads every live K/V
byte of the pool once and does 4 flops per K/V element pair, so its floor is
the live K/V bytes over 3.35 TB/s. The design reads pages in place through
the block table (no gather into a dense buffer) and keeps the memory system
busy by splitting each sequence's pages (flash-decoding): a block takes a
run of table entries of one (sequence, kv head), computes the G query heads
that share that kv head (each K/V byte is read once for all of them) and
writes a partial (m, l, acc); a second kernel, ``paged_combine_kernel``,
merges the splits. ``kernel.split_plan`` sizes the split to about two
blocks per SM. Each page's K and V rows are staged in shared memory with
16-byte ``cp.async`` copies, double-buffered only when a split holds more
than one page. The ``.cu`` header has the details.

``impl="kernel"`` takes the plain version (``ref.paged_attention_ref``) only
when the tensors lie on the CPU. On CUDA tensors it launches the kernel or
raises; it never falls back. ``paged_attention.launches`` counts kernel
launches. The contract holds for lengths >= 1: at length 0 the kernel gives
0 and the plain version a mean over page 0, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import paged_attention_kernel
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
        return out
    if impl == "xla":
        return paged_attention_ref(q, kv_pages, block_tables, lengths,
                                   scale=scale)
    raise ValueError(f"unknown impl {impl!r}")


paged_attention.launches = 0
