"""The port's own spans (``repro_torch.trace``, named ``pangea.*``) in a
traced window: device seconds by span and by train-step phase, the
remat recompute, launch calls inside the step, and idle gaps named by the
span open where they begin.

While the profiler records and the port's spans are on, each span is a
``record_function`` range on the thread that opened it, so it lies on the
trace's clock beside the kernels it launched. ``reduce_spans`` reads them
from the same events as ``tracing.reduce``:

- a kernel (or memcpy, memset) belongs to the innermost ``pangea.*`` span
  open on its launching thread at its launch; where that thread has none
  open (autograd's device thread running the backward), to the innermost
  one open at that moment on the thread that opened ``pangea.step``;
- a ``pangea.layer`` that opens while a ``pangea.step.backward`` is open
  is the remat recompute, kept apart as ``pangea.layer.recompute``;
- the phases ``pangea.step.*`` are inclusive: a kernel under a layer, or a
  kernel entry's span, inside the forward counts toward
  ``pangea.step.forward`` too;
- launch calls (``cudaLaunchKernel``, ``cuLaunchKernel``,
  ``cudaMemcpyAsync``, ``cudaMemsetAsync``, their ``Ex`` forms too) are
  counted where they start inside a ``pangea.step``, on any thread;
- an idle gap of the device is named by the innermost ``pangea.*`` span
  open at its start on the thread that launches the kernel ending it, with
  the same fallback to the step's thread; where no ``pangea.*`` span is
  open, by the innermost harness span (``train.*``, ``serve.*``) as
  ``tracing.reduce`` names it, else ``harness``.

The per-layer readers ``perfbench/metrics/{fwd,bwd,recompute}_ms.train``
and ``launches.train`` read a ``Spans`` from ``run.trace.spans``, and
``step_host_ms.train`` the records' ``step_host_s`` (the host seconds of
each step's ``pangea.step``); a run without them reads nothing.
"""
from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from . import readers, tracing

STEP, BWD, LAYER = "pangea.step", "pangea.step.backward", "pangea.layer"
RECOMPUTE = "pangea.layer.recompute"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
            "cudaMemsetAsync")
# ranges the harness and the port open; on the device side they are
# annotations, not work
_RANGES = tracing._SPANS + ("pangea.",)


@dataclass
class Spans:
    """What the port's spans showed in a traced window (seconds)."""
    steps: int                                # pangea.step ranges
    device_s: Dict[str, float]                # by innermost span
    phase_s: Dict[str, float]                 # by step phase, inclusive
    recompute_s: float                        # inside recompute layers
    launches: int                             # launch calls in the steps
    unattributed_s: float                     # kernels with no launch seen
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _stacks(ranges):
    """Nested (start, end, name) ranges of one thread -> sorted disjoint
    (start, end, stack) pieces, each with the names open over it, outermost
    first."""
    out, stack, t = [], [], 0

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end = stack[-1][0]
            if t < end:
                out.append((t, end, tuple(n for _, n in stack)))
                t = end
            stack.pop()

    for s, e, n in sorted(ranges, key=lambda r: (r[0], -r[1])):
        close_until(s)
        if stack and t < s:
            out.append((t, s, tuple(n for _, n in stack)))
        stack.append((e, n))
        t = s
    close_until(float("inf"))
    return out


class _Open:
    """The stack of spans open at a moment, on one thread."""

    def __init__(self, ranges):
        self.segs = _stacks(ranges)
        self.starts = [s for s, _, _ in self.segs]

    def at(self, t) -> Tuple[str, ...]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1]:
            return self.segs[i][2]
        return ()


def _inside(intervals, t) -> bool:
    """``t`` inside one of the sorted, disjoint-started ``intervals``."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and t < intervals[i][1]


def reduce_spans(events) -> Spans:
    """The trace of one window -> ``Spans`` (see the module's docstring).
    ``events``: the profiler's events, as ``tracing.reduce`` takes them."""
    cpu = torch.autograd.DeviceType.CPU
    window, spans, host, device, launch_at = None, [], [], [], {}
    launch_calls = []
    for e in events:
        name, s, d = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() != cpu:
            if not name.startswith(_RANGES):
                device.append((s, d, e.correlation_id()))
            continue
        if name == "pb.window":
            window = (s, s + d)
        elif name.startswith("pangea."):
            spans.append((s, s + d, name, e.start_thread_id()))
        elif name.startswith(("serve.", "train.")):
            host.append((s, s + d, name))
        elif name.startswith("cu") and e.correlation_id():
            launch_at[e.correlation_id()] = (s, e.start_thread_id())
            if name.startswith(LAUNCHES):
                launch_calls.append(s)
    if window is None:
        raise RuntimeError("the trace has no pb.window range")
    steps = sorted((s, e) for s, e, n, _ in spans if n == STEP)
    bwds = sorted((s, e) for s, e, n, _ in spans if n == BWD)
    step_thread = next((t for _, _, n, t in spans if n == STEP), None)
    by_thread = collections.defaultdict(list)
    for s, e, n, t in spans:
        if n == LAYER and _inside(bwds, s):
            n = RECOMPUTE
        by_thread[t].append((s, e, n))
    open_on = {t: _Open(r) for t, r in by_thread.items()}
    none = _Open([])
    on_step = open_on.get(step_thread, none)

    def stack(tid, t) -> Tuple[str, ...]:
        return open_on.get(tid, none).at(t) or on_step.at(t)

    device_s = collections.defaultdict(float)
    phase_s = collections.defaultdict(float)
    recompute = unattributed = 0.0
    kernels = []                                 # (start, end, launch tid)
    for s, d, corr in device:
        launch = launch_at.get(corr)
        kernels.append((s, s + d, launch[1] if launch else None))
        if launch is None:
            unattributed += d * 1e-9
            continue
        st = stack(launch[1], launch[0])
        if st:
            device_s[st[-1]] += d * 1e-9
            recompute += d * 1e-9 if RECOMPUTE in st else 0.0
        # the step, and the phase open in it, on the step's thread
        on = on_step.at(launch[0])
        phases = [n for n in on if n.startswith(STEP + ".")]
        for n in ([STEP] if STEP in on else []) + phases[-1:]:
            phase_s[n] += d * 1e-9
    return Spans(
        steps=sum(window[0] <= s and e <= window[1] for s, e in steps),
        device_s=dict(device_s), phase_s=dict(phase_s),
        recompute_s=recompute,
        launches=sum(_inside(steps, t) for t in launch_calls),
        unattributed_s=unattributed,
        idle_gaps=_idle_gaps(window, kernels, stack, _Open(host)))


def _idle_gaps(window, kernels, stack, host) -> List[Tuple[str, float]]:
    """Idle seconds of the window by the span that names each gap."""
    w0, w1 = window
    idle = collections.defaultdict(float)
    cur = w0
    for s, e, tid in sorted(kernels):
        s, e = max(s, w0), min(e, w1)
        if e <= cur:
            continue
        if s > cur:
            idle[_gap_name(cur, tid, stack, host)] += (s - cur) * 1e-9
        cur = e
    if cur < w1:
        idle[_gap_name(cur, None, stack, host)] += (w1 - cur) * 1e-9
    return sorted(idle.items(), key=lambda kv: -kv[1])


def _gap_name(t, tid, stack, host) -> str:
    st = stack(tid, t)
    if st:
        return st[-1]
    outer = host.at(t)
    return outer[-1] if outer else "harness"


# -- what the readers share ---------------------------------------------------
def of(run) -> Optional[Spans]:
    """The traced window's ``Spans`` of a training run, or None where it
    has none or they hold no step (the port's spans were off)."""
    if run.kind != "train" or run.trace is None:
        return None
    s = getattr(run.trace, "spans", None)
    return s if s is not None and s.steps else None


def ms_per_step(run, seconds: Optional[float]) -> Optional[float]:
    """Milliseconds a step of the traced half."""
    if seconds is None:
        return None
    return 1e3 * seconds / len(readers.traced(run))
