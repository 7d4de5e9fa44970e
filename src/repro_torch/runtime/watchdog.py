"""Fault-tolerance runtime: host heartbeats, straggler detection, collective
watchdog. On a real cluster the heartbeat transport is the coordinator
(a distributed runtime); here hosts are simulated processes/threads — the policy
logic (what to do when) is what this module owns and what the tests cover.

Copy of the JAX package's ``runtime/watchdog.py``; nothing changes.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from ..core.sanitizer import tracked_lock


class HostMonitor:
    """Heartbeat table. A host missing ``timeout`` seconds is declared dead;
    registered callbacks receive the failure set (runtime drives elastic
    remesh + replica recovery from there)."""

    def __init__(self, hosts: List[int], timeout: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self._last: Dict[int, float] = {h: clock() for h in hosts}
        self._dead: Set[int] = set()
        self._callbacks: List[Callable[[Set[int]], None]] = []
        self._lock = tracked_lock("watchdog")

    def heartbeat(self, host: int) -> None:
        with self._lock:
            if host not in self._dead:
                self._last[host] = self.clock()

    def on_failure(self, cb: Callable[[Set[int]], None]) -> None:
        self._callbacks.append(cb)

    def check(self) -> Set[int]:
        """Returns newly dead hosts (and fires callbacks)."""
        now = self.clock()
        newly: Set[int] = set()
        with self._lock:
            for h, t in self._last.items():
                if h not in self._dead and now - t > self.timeout:
                    newly.add(h)
            self._dead |= newly
        if newly:
            for cb in self._callbacks:
                cb(set(newly))
        return newly

    @property
    def alive(self) -> List[int]:
        return sorted(h for h in self._last if h not in self._dead)

    @property
    def dead(self) -> Set[int]:
        return set(self._dead)


class StepTimer:
    """Per-host step-time EWMA; hosts slower than mean + k·std are
    stragglers. The data pipeline re-dispatches a straggler's pending pages
    to its backup (paper-style backup tasks, at page granularity)."""

    def __init__(self, hosts: List[int], alpha: float = 0.2, k: float = 3.0,
                 min_samples: int = 5):
        self.alpha = alpha
        self.k = k
        self.min_samples = min_samples
        self.ewma: Dict[int, float] = {h: 0.0 for h in hosts}
        self.count: Dict[int, int] = {h: 0 for h in hosts}

    def record(self, host: int, step_time: float) -> None:
        c = self.count.get(host, 0)
        self.ewma[host] = (step_time if c == 0
                           else (1 - self.alpha) * self.ewma[host]
                           + self.alpha * step_time)
        self.count[host] = c + 1

    @contextlib.contextmanager
    def time(self, host: int,
             clock: Callable[[], float] = time.perf_counter):
        """Time a block of work on ``host`` and record it as one step — how
        the cluster map phase feeds the straggler detector."""
        t0 = clock()
        try:
            yield
        finally:
            self.record(host, clock() - t0)

    def stragglers(self, min_samples: Optional[int] = None) -> List[int]:
        """Robust detection: median + k * 1.4826 * MAD (a lone extreme host
        can't inflate the threshold the way it inflates a stddev), with a
        20%-of-median floor so benign jitter never triggers. ``min_samples``
        overrides the instance default — one-shot phases (a single map pass
        per host) pass 1, long-running pipelines keep the warmup guard."""
        need = self.min_samples if min_samples is None else min_samples
        ready = [h for h, c in self.count.items() if c >= need]
        if len(ready) < 2:
            return []
        vals = sorted(self.ewma[h] for h in ready)
        med = vals[len(vals) // 2]
        mad = sorted(abs(v - med) for v in vals)[len(vals) // 2]
        thr = med + max(self.k * 1.4826 * mad, 0.2 * med) + 1e-12
        return [h for h in ready if self.ewma[h] > thr]


class CollectiveWatchdog:
    """Context manager that bounds how long a collective may take; on
    timeout it invokes ``on_timeout`` (abort + checkpoint-restart on a real
    cluster). Used around blocking cross-host operations."""

    def __init__(self, timeout: float, on_timeout: Callable[[], None]):
        self.timeout = timeout
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self.fired = False

    def __enter__(self):
        def fire():
            self.fired = True
            self.on_timeout()
        self._timer = threading.Timer(self.timeout, fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer:
            self._timer.cancel()
        return False
