"""What the metric readers under ``perfbench/metrics`` share: the tail of
a sample, the model's FLOPs from the configuration's reference, and the
trace's shares. Each returns None where its run has nothing to read."""
from __future__ import annotations

import math
from typing import List, Optional

from . import yardstick


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the sample at or below it."""
    v = sorted(values)
    return v[max(math.ceil(q / 100 * len(v)), 1) - 1]


def records(run, kind: str) -> Optional[list]:
    """The window's records read on the host clock: all of an untraced
    run, the first (untraced) half of a traced one."""
    recs = [r for r in run.records if not r.get("traced", False)]
    return recs if run.kind == kind and recs else None


def traced(run) -> list:
    """The records of the traced half of the window."""
    return [r for r in run.records if r.get("traced", True)]


def prefill_flops(run, L: int) -> float:
    """Model FLOPs of a prompt of L real tokens."""
    ref = run.reference
    return (2 * ref.matmul_params(run.conf) * L
            + ref.attn_pair_flops(run.conf) * L * (L + 1) / 2)


def decode_flops(run, rec) -> float:
    """Model FLOPs of a batch's decode steps: every row, every step, at
    its position's context."""
    ref = run.reference
    n = len(rec["prompt_lens"])
    ctx = sum(rec["plen"] + s + 1 for s in range(rec["steps"]))
    return n * (2 * ref.matmul_params(run.conf) * rec["steps"]
                + ref.attn_pair_flops(run.conf) * ctx)


def train_flops(run, rec) -> float:
    """Model FLOPs of a step: three times the forward's (its backward
    twice over), recomputation not counted."""
    B, T = rec["batch"]
    ref = run.reference
    return 3 * B * (2 * ref.matmul_params(run.conf) * T
                    + ref.attn_pair_flops(run.conf) * T * (T + 1) / 2)


def mfu(flops: float, seconds: float) -> float:
    return 100.0 * flops / seconds / yardstick.BF16_PEAK


def roofline(run, kind: str, rng: str) -> Optional[float]:
    """A kernel's share of its roofline, in %: its calls' bound seconds
    over their device seconds in range ``rng`` of the trace."""
    if run.kind != kind or run.trace is None:
        return None
    work = run.trace.work.get(rng)
    device_s = run.trace.range_s.get(rng, 0.0)
    if not work or not work[3] or device_s <= 0:
        return None
    return 100.0 * work[2] / device_s


def range_ms_per(run, kind: str, rng: str) -> Optional[float]:
    """Device milliseconds of range ``rng`` a record of the window."""
    if run.kind != kind or run.trace is None or rng not in run.trace.range_s:
        return None
    return 1e3 * run.trace.range_s[rng] / len(traced(run))


def idle_share(run, kind: str) -> Optional[float]:
    if run.kind != kind or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
