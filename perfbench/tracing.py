"""The traced run: ranges the harness opens around the port's calls, the
profiler over the measured window, and the reduction of its trace.

With ``--trace 0`` nothing here runs: ``Tracer(False)`` opens no range and
patches nothing. With ``--trace 1`` the profiler records the second half
of the window only (``runners.measure``), so that the first half's
records, read on the host clock, run with nothing recording ops; while it
records, the harness

- opens host spans around its own calls into the port (``span``): a
  serving batch, its prefill, each decode step; a training step's data and
  its step. Idle gaps of the device are charged to the innermost span open
  when they begin;
- wraps the port's public op entries, ``flash_attention``, ``dispatch`` and
  ``combine`` as the model blocks call them, and the optimizer's
  ``adamw_apply``, in a range named ``pb.<op>.<phase>`` each, and counts
  each call's work from its shapes (``yardstick``). The device time of a
  range is that of the kernels launched while it is open, so any
  implementation behind the entry is read against the same work;
- reads the device time of attention's backward from autograd's
  ``_FlashAttentionBackward`` nodes.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from . import yardstick

ATTN_BWD = "pb.attn_bwd"


@dataclass
class Summary:
    """What a traced window showed."""
    window_s: float
    busy_s: float
    range_s: Dict[str, float]                 # device seconds a range
    work: Dict[str, List[float]]              # [bytes, flops, bound_s, calls]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.phase = "none"
        self._prof = None
        self._undo: List = []
        self._pending: List = []
        self.work: Dict[str, List[float]] = collections.defaultdict(
            lambda: [0.0, 0.0, 0.0, 0])

    # -- host spans -----------------------------------------------------------
    @property
    def active(self) -> bool:
        """The profiler is recording."""
        return self._prof is not None

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    # -- op entries -----------------------------------------------------------
    def _add(self, name: str, nbytes: float, flops: float):
        w = self.work[name]
        w[0] += nbytes
        w[1] += flops
        w[2] += yardstick.bound_s(nbytes, flops)
        w[3] += 1

    def instrument(self):
        """Wrap the port's op entries (traced runs only)."""
        if not self.enabled:
            return
        from repro_torch.models import blocks
        from repro_torch.optim import train_state
        tracer = self
        flash, dispatch, combine = (blocks.flash_attention, blocks.dispatch,
                                    blocks.combine)
        adamw = train_state.adamw_apply

        def flash_entry(q, k, v, **kw):
            name = f"pb.flash.{tracer.phase}"
            lse = torch.is_grad_enabled() and q.requires_grad
            tracer._add(name, *yardstick.flash_work(
                q.shape, k.shape, v.shape, q.element_size(),
                kw.get("causal", True), kw.get("q_offset", 0), lse))
            with torch.profiler.record_function(name):
                return flash(q, k, v, **kw)

        def dispatch_entry(x, expert_id, slot, num_experts, capacity, **kw):
            name = f"pb.shuffle.{tracer.phase}"
            with torch.profiler.record_function(name):
                out = dispatch(x, expert_id, slot, num_experts, capacity,
                               **kw)
            keep = (slot >= 0) & (slot < capacity)
            tracer._pending.append(
                ("dispatch", name, tuple(expert_id.shape), num_experts,
                 capacity, x.shape[-1], x.element_size(), keep.sum(),
                 keep.any(dim=1).sum()))
            return out

        def combine_entry(y, expert_id, slot, gates, num_tokens, **kw):
            name = f"pb.shuffle.{tracer.phase}"
            with torch.profiler.record_function(name):
                out = combine(y, expert_id, slot, gates, num_tokens, **kw)
            keep = (slot >= 0) & (slot < y.shape[1])
            tracer._pending.append(
                ("combine", name, tuple(expert_id.shape), y.shape[0],
                 y.shape[1], y.shape[-1], y.element_size(), keep.sum(),
                 None))
            return out

        def adamw_entry(*a, **kw):
            with torch.profiler.record_function("pb.adamw"):
                return adamw(*a, **kw)

        for mod, attr, fn in ((blocks, "flash_attention", flash_entry),
                              (blocks, "dispatch", dispatch_entry),
                              (blocks, "combine", combine_entry),
                              (train_state, "adamw_apply", adamw_entry)):
            self._undo.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, fn)

    def uninstrument(self):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()
        for kind, name, (N, K), R, C, D, elem, pairs, tokens in self._pending:
            if kind == "dispatch":
                self._add(name, *yardstick.dispatch_work(
                    N, K, R, C, D, elem, int(pairs), int(tokens)))
            else:
                self._add(name, *yardstick.combine_work(N, K, D, elem,
                                                        int(pairs)))
        self._pending.clear()

    # -- the profiler ---------------------------------------------------------
    def start(self):
        if not self.enabled:
            return
        self.instrument()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._window = torch.profiler.record_function("pb.window")
        self._window.__enter__()

    def stop(self) -> Optional[Summary]:
        if not self.active:
            return None
        self._window.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._prof.stop()
        self.uninstrument()
        events = self._prof.profiler.kineto_results.events()
        t1 = time.perf_counter()
        self._prof = None
        summary = reduce(events, dict(self.work))
        print(f"perfbench: trace of {len(events)} events: stop "
              f"{t1 - t0:.3f} s, reduce {time.perf_counter() - t1:.3f} s",
              file=sys.stderr)
        return summary


def _segments(ranges):
    """Nested (start, end, name) ranges of one thread -> sorted disjoint
    (start, end, name) pieces, each named by its innermost open range."""
    out, stack, t = [], [], 0

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, name = stack.pop()
            if t < end:
                out.append((t, end, name))
                t = end

    for s, e, n in sorted(ranges, key=lambda r: (r[0], -r[1])):
        close_until(s)
        if stack and t < s:
            out.append((t, s, stack[-1][1]))
        stack.append((e, n))
        t = s
    close_until(float("inf"))
    return out


class _Lookup:
    def __init__(self, segs):
        self.segs = segs
        self.starts = [s for s, _, _ in segs]

    def at(self, t) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1]:
            return self.segs[i][2]
        return None


def _is_attn_bwd(name: str) -> bool:
    return (name.startswith("autograd::engine::evaluate_function")
            and "_FlashAttentionBackward" in name)


_SPANS = ("pb.", "serve.", "train.")


def reduce(events, work: Dict[str, List[float]]) -> Summary:
    """The trace of one window -> busy seconds, device seconds by range and
    by kernel name, idle gaps by the host span open where they begin.

    A kernel belongs to the innermost range open on the thread that
    launched it when it was launched (the launch's runtime event carries
    the kernel's correlation id). A kernel whose launch the trace lacks
    belongs to the innermost range's device-side annotation around it."""
    window = None
    kernel_ranges = collections.defaultdict(list)   # thread -> ranges
    host_ranges, gpu_ranges = [], []
    launches = {}                                    # correlation -> (t, thread)
    device = []
    cpu = torch.autograd.DeviceType.CPU
    for e in events:
        name = e.name()
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() != cpu:
            if name.startswith(_SPANS):
                if name.startswith("pb.") and name != "pb.window":
                    gpu_ranges.append((s, s + d, name))
            else:
                device.append((s, d, name, e.correlation_id()))
            continue
        tid = e.start_thread_id()
        if name == "pb.window":
            window = (s, s + d)
        elif name.startswith("pb."):
            kernel_ranges[tid].append((s, s + d, name))
        elif _is_attn_bwd(name):
            kernel_ranges[tid].append((s, s + d, ATTN_BWD))
        elif name.startswith(("serve.", "train.")):
            host_ranges.append((s, s + d, name))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = (s, tid)
    if window is None:
        raise RuntimeError("the trace has no pb.window range")
    by_thread = {t: _Lookup(_segments(r)) for t, r in kernel_ranges.items()}
    on_device = _Lookup(_segments(gpu_ranges))
    range_s = collections.defaultdict(float)
    by_name = collections.defaultdict(float)
    intervals = []
    for s, d, name, corr in device:
        intervals.append((s, s + d))
        by_name[name] += d * 1e-9
        launch = launches.get(corr)
        if launch is not None:
            look = by_thread.get(launch[1])
            r = look.at(launch[0]) if look else None
        else:
            r = on_device.at(s)
        if r is not None:
            range_s[r] += d * 1e-9
    w0, w1 = window
    intervals.sort()
    busy, gaps, cur = 0, [], w0
    for s, e in intervals:
        s, e = max(s, w0), min(e, w1)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
        busy += e - max(s, cur)
        cur = e
    if cur < w1:
        gaps.append((cur, w1))
    look = _Lookup(_segments(host_ranges))
    idle = collections.defaultdict(float)
    for s, e in gaps:
        idle[look.at(s) or "harness"] += (e - s) * 1e-9
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]
    return Summary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                   range_s=dict(range_s), work=work,
                   device_ops=[(n[:96], s) for n, s in top(by_name)],
                   idle_gaps=top(idle))
