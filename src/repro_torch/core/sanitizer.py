"""Runtime lock-order / blocking-while-holding sanitizer.

The static half of ``pangea-check`` (``tools/pangea_check``) proves lexical
invariants; this module is the dynamic half.  Every lock in the data plane is
constructed through :func:`tracked_lock` / :func:`tracked_rlock` /
:func:`tracked_condition` (rule R4 forbids bare ``threading.Lock()`` anywhere
else), which makes the concurrency surface *observable*:

* **Lock-order graph** — under ``PANGEA_SANITIZE=1`` every acquire records a
  ``held -> acquired`` edge at *name* granularity (one name per lock class,
  e.g. ``"buffer_pool"``), so two code paths that nest the same two lock
  classes in opposite orders show up as a cycle in
  ``sanitizer_report()["cycles"]`` — a potential deadlock — even when the
  test run never actually deadlocked.  Acquiring two *different instances*
  of the same name while one is held is a self-cycle and reported too
  (reentrant re-acquires of one RLock instance are not edges).
* **Blocking-while-holding** — the repo's real blocking primitives
  (``os.fsync`` in the page log, socket send/recv in the RPC layer, future
  waits) are instrumented with :func:`blocking_region`; entering one while
  any tracked lock is held is recorded.  Waiting on a condition variable's
  *own* lock is the one sanctioned blocking-under-lock pattern — the wait
  releases the lock — so :class:`TrackedCondition` suspends its lock's hold
  frame for the duration of the wait.
* **Hold times** — per lock name, the longest observed hold (with the
  acquire site), so "who serializes the data plane" is a measurement.

Everything is a no-op unless sanitizing is enabled (``PANGEA_SANITIZE=1`` in
the environment, or :func:`enable` from a test); the disabled fast path is a
single module-global boolean check per acquire.

This file is the only module allowed to construct bare ``threading`` locks
(it is the bottom of the tower — its own registry lock cannot be tracked by
itself).

Copy of the JAX package's ``core/sanitizer.py``. The lint (R4) exempts that
path only, so here every raw primitive is made on one line of one helper,
``_raw_primitive``, under one waiver; nothing else changes.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager
from threading import Condition, Lock, RLock
from typing import Dict, List, Optional, Set, Tuple


def _raw_primitive(reentrant: bool = False, under=None):
    """A raw ``threading`` primitive: a condition over the raw lock
    ``under`` when one is given, else an ``RLock`` or a ``Lock``."""
    # pangea: allow(R4): the port's tower bottom, as repro/core/sanitizer.py
    return Condition(under) if under else RLock() if reentrant else Lock()


# the sanitizer's own state lock: the one primitive the tracked tower is
# built on
_STATE_LOCK = _raw_primitive()

_ENABLED = os.environ.get("PANGEA_SANITIZE", "") not in ("", "0")

_TLS = threading.local()

# (held_name, acquired_name) -> first observed "file:line" site
_edges: Dict[Tuple[str, str], str] = {}
# op -> list of {"op", "held", "site"} events (bounded)
_blocking_events: List[Dict[str, object]] = []
# name -> (max_hold_seconds, acquire site)
_hold_times: Dict[str, Tuple[float, str]] = {}
_acquires: Dict[str, int] = {}

_MAX_EVENTS = 256


def enable(flag: bool = True) -> None:
    """Turn sanitizing on/off at runtime (tests use this instead of the
    ``PANGEA_SANITIZE`` environment variable)."""
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    """Clear every recorded edge/event/hold — each test asserts its own
    deltas, never another test's residue."""
    with _STATE_LOCK:
        _edges.clear()
        _blocking_events.clear()
        _hold_times.clear()
        _acquires.clear()


def _caller_site(skip_self: bool = True) -> str:
    """``file:line`` of the nearest frame outside this module."""
    f = sys._getframe(1)
    me = __file__
    while f is not None and skip_self and f.f_code.co_filename == me:
        f = f.f_back
    if f is None:  # pragma: no cover - interpreter teardown
        return "?"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


class _Frame:
    __slots__ = ("lock", "name", "t0", "site", "depth")

    def __init__(self, lock, name: str, t0: float, site: str):
        self.lock = lock
        self.name = name
        self.t0 = t0
        self.site = site
        self.depth = 1


def _held_stack() -> List[_Frame]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def held_lock_names() -> List[str]:
    """Names of the tracked locks the calling thread currently holds."""
    return [f.name for f in _held_stack()]


def _note_attempt(lock, reentrant: bool) -> None:
    """Record order edges from every held lock to the one being acquired.
    Called *before* the real acquire so blocked attempts still contribute
    their intended order."""
    stack = _held_stack()
    if not stack:
        return
    if reentrant and any(fr.lock is lock for fr in stack):
        return  # same-instance RLock re-acquire: not an ordering event
    site = _caller_site()
    with _STATE_LOCK:
        for fr in stack:
            if fr.lock is lock:
                continue
            _edges.setdefault((fr.name, lock.name), site)


def _push_hold(lock) -> None:
    stack = _held_stack()
    if isinstance(lock, TrackedRLock):
        for fr in stack:
            if fr.lock is lock:
                fr.depth += 1
                return
    stack.append(_Frame(lock, lock.name, time.monotonic(), _caller_site()))
    with _STATE_LOCK:
        _acquires[lock.name] = _acquires.get(lock.name, 0) + 1


def _pop_hold(lock) -> None:
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        fr = stack[i]
        if fr.lock is lock:
            fr.depth -= 1
            if fr.depth == 0:
                stack.pop(i)
                dt = time.monotonic() - fr.t0
                with _STATE_LOCK:
                    best = _hold_times.get(fr.name)
                    if best is None or dt > best[0]:
                        _hold_times[fr.name] = (dt, fr.site)
            return
    # releasing a lock this thread never tracked (enable() flipped mid-hold)


class TrackedLock:
    """``threading.Lock`` with sanitizer bookkeeping. Drop-in: ``acquire`` /
    ``release`` / context manager / ``locked``."""

    _reentrant = False

    def __init__(self, name: str, _raw=None):
        self.name = name
        self._raw = _raw if _raw is not None else _raw_primitive()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _ENABLED:
            return self._raw.acquire(blocking, timeout)
        _note_attempt(self, self._reentrant)
        got = self._raw.acquire(blocking, timeout)
        if got:
            _push_hold(self)
        return got

    def release(self) -> None:
        if _ENABLED:
            _pop_hold(self)
        self._raw.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r}>"


class TrackedRLock(TrackedLock):
    """Reentrant tracked lock: same-instance re-acquires bump a depth count
    instead of recording order edges or new hold frames."""

    _reentrant = True

    def __init__(self, name: str):
        super().__init__(name, _raw=_raw_primitive(reentrant=True))


class TrackedCondition:
    """Condition variable over a tracked lock.

    ``wait``/``wait_for`` *suspend* the lock's hold frame for the duration —
    waiting on your own condition releases the lock, which is exactly why it
    is the sanctioned exception to the no-blocking-under-lock rule (R3) —
    then restore it on wakeup, so lock-order and hold-time accounting stay
    truthful across waits.
    """

    def __init__(self, name: str, lock: Optional[TrackedLock] = None):
        self.name = name
        self.lock = lock if lock is not None else TrackedRLock(f"{name}.lock")
        self._cond = _raw_primitive(under=self.lock._raw)

    # -- lock interface ------------------------------------------------------
    def acquire(self, *args, **kwargs) -> bool:
        return self.lock.acquire(*args, **kwargs)

    def release(self) -> None:
        self.lock.release()

    def __enter__(self) -> "TrackedCondition":
        self.lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.lock.release()

    # -- waiting -------------------------------------------------------------
    def _suspend(self) -> Optional[_Frame]:
        if not _ENABLED:
            return None
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].lock is self.lock:
                return stack.pop(i)
        return None

    def _resume(self, frame: Optional[_Frame]) -> None:
        if frame is not None:
            frame.t0 = time.monotonic()   # a fresh hold starts at wakeup
            _held_stack().append(frame)

    def wait(self, timeout: Optional[float] = None) -> bool:
        frame = self._suspend()
        try:
            # own lock's frame is suspended; anything still held is a
            # genuine blocking-while-holding
            note_blocking(f"cond.wait({self.name})")
            return self._cond.wait(timeout)
        finally:
            self._resume(frame)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        frame = self._suspend()
        try:
            note_blocking(f"cond.wait({self.name})")
            return self._cond.wait_for(predicate, timeout)
        finally:
            self._resume(frame)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


def tracked_lock(name: str) -> TrackedLock:
    """The only sanctioned way to make a mutex (R4): a named, sanitized
    ``threading.Lock``."""
    return TrackedLock(name)


def tracked_rlock(name: str) -> TrackedRLock:
    return TrackedRLock(name)


def tracked_condition(name: str,
                      lock: Optional[TrackedLock] = None) -> TrackedCondition:
    return TrackedCondition(name, lock)


# -- blocking-while-holding ---------------------------------------------------
@contextmanager
def blocking_region(op: str, allow: Tuple[str, ...] = ()):
    """Mark a genuinely blocking primitive (fsync, socket round-trip, future
    wait).  Entered while the thread holds any tracked lock not named in
    ``allow``, the event is recorded — the runtime analogue of static rule
    R3.  ``allow`` names locks whose holding is the *point* (e.g. page-log
    compaction excludes writers for the whole rewrite)."""
    if _ENABLED:
        held = [n for n in held_lock_names() if n not in allow]
        if held:
            with _STATE_LOCK:
                if len(_blocking_events) < _MAX_EVENTS:
                    _blocking_events.append(
                        {"op": op, "held": held, "site": _caller_site()})
    yield


def note_blocking(op: str, allow: Tuple[str, ...] = ()) -> None:
    """Point-event form of :func:`blocking_region`."""
    with blocking_region(op, allow):
        pass


# -- reporting ----------------------------------------------------------------
def _find_cycles(edges: Set[Tuple[str, str]]) -> List[List[str]]:
    """Cycles in the lock-order graph (each reported once, rotated so the
    lexically smallest name leads).  Self-loops (same lock name nested
    across instances) count."""
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles: Set[Tuple[str, ...]] = set()

    def dfs(node: str, path: List[str], on_path: Set[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_path:
                cyc = path[path.index(nxt):]
                k = cyc.index(min(cyc))
                cycles.add(tuple(cyc[k:] + cyc[:k]))
                continue
            path.append(nxt)
            on_path.add(nxt)
            dfs(nxt, path, on_path)
            on_path.discard(nxt)
            path.pop()

    for start in sorted(graph):
        dfs(start, [start], {start})
    return [list(c) for c in sorted(cycles)]


def sanitizer_report() -> Dict[str, object]:
    """Everything the run observed: order edges, deadlock cycles, blocking
    while holding, longest holds.  ``violations`` is the headline count the
    CI gate (and the negative-path tests) assert on."""
    with _STATE_LOCK:
        edges = dict(_edges)
        events = [dict(e) for e in _blocking_events]
        holds = dict(_hold_times)
        acquires = dict(_acquires)
    cycles = _find_cycles(set(edges))
    longest = sorted(((name, round(dt, 6), site)
                      for name, (dt, site) in holds.items()),
                     key=lambda t: -t[1])
    return {
        "enabled": _ENABLED,
        "acquires": acquires,
        "edges": sorted((a, b, site) for (a, b), site in edges.items()),
        "cycles": cycles,
        "blocking_while_holding": events,
        "longest_holds": longest[:10],
        "violations": len(cycles) + len(events),
    }


def assert_clean(context: str = "") -> None:
    """Raise if the run recorded any violation — the CI-side gate."""
    report = sanitizer_report()
    if report["violations"]:
        raise AssertionError(
            f"sanitizer found {report['violations']} violation(s)"
            f"{' in ' + context if context else ''}: "
            f"cycles={report['cycles']} "
            f"blocking={report['blocking_while_holding']}")
