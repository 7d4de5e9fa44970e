"""The yardstick: the card's published peaks and the work a kernel call
needs, counted from its shapes.

Peaks: one NVIDIA H100 SXM (data sheet, dense): 3.35 TB/s of HBM, 989
TFLOP/s in bf16 and fp16, 67 TFLOP/s in fp32 outside the tensor cores.
They assume the card's full 700 W; each run prints the power limit it had.

A call's bound is the larger of its bytes over the bandwidth and its
operations over the peak of its type. Bytes count each input read once and
each output written once, whatever the kernel reads again; for the shuffle
kernels only the rows that this routing selects count. A kernel's share of
its roofline is the sum of its calls' bounds over the sum of their device
times.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
BF16_PEAK = PEAK_FLOPS["bfloat16"]


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def live_pairs(Tq: int, Tk: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs a row of heads attends: query i sees keys
    0..i + q_offset under the causal mask, all Tk without it."""
    if not causal:
        return Tq * Tk
    return int(np.clip(np.arange(Tq) + q_offset + 1, 0, Tk).sum())


def flash_work(q: Sequence[int], k: Sequence[int], v: Sequence[int],
               elem: int, causal: bool, q_offset: int = 0,
               lse: bool = False) -> Tuple[int, int]:
    """(bytes, flops) of attention over q [B, H, Tq, D], k [B, KH, Tk, D],
    v [B, KH, Tk, Dv]: q, k, v read once, the output [B, H, Tq, Dv] (and
    with ``lse`` the rows' fp32 log-sum-exp) written once; 2 D + 2 Dv
    flops a live pair and head."""
    B, H, Tq, D = q
    Dv = v[-1]
    nbytes = (B * H * Tq * D + k[0] * k[1] * k[2] * D
              + v[0] * v[1] * v[2] * Dv + B * H * Tq * Dv) * elem
    if lse:
        nbytes += B * H * Tq * 4
    flops = 2 * (D + Dv) * B * H * live_pairs(Tq, k[2], causal, q_offset)
    return nbytes, flops


def dispatch_work(N: int, K: int, R: int, C: int, D: int, elem: int,
                  kept_pairs: int, kept_tokens: int) -> Tuple[int, int]:
    """(bytes, flops) of dispatching N tokens' K pairs into R buffers of C
    rows of D: the tokens with a kept pair read once, every buffer row
    written, the ids and slots (int32) read; an add a kept pair and
    column."""
    nbytes = (kept_tokens + R * C) * D * elem + 2 * N * K * 4
    return nbytes, kept_pairs * D


def combine_work(N: int, K: int, D: int, elem: int,
                 kept_pairs: int) -> Tuple[int, int]:
    """(bytes, flops) of combining the kept pairs' buffer rows into N
    tokens of D: each kept row read once, the output written, ids, slots
    and gates read; a multiply and an add a kept pair and column."""
    nbytes = (kept_pairs + N) * D * elem + 2 * N * K * 4 + N * K * elem
    return nbytes, 2 * kept_pairs * D
