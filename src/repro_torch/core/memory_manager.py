"""Per-node memory authority — eviction policy promoted out of the pool.

The paper's §6 data-aware eviction was a ``BufferPool`` internal, which meant
only the pool's own allocation path could see or react to memory pressure.
The ``MemoryManager`` owns everything pressure-related for one node:

* the ``PagingSystem`` (Eq. 1 / Algorithm 1 victim selection) and the
  ``SpillStore`` the victims land in;
* pressure accounting — resident / pinned / spilled / reserved bytes with
  high-water marks, so "how close to the cliff did this workload get" is a
  first-class, assertable number (the streaming-remesh driver budget and the
  reducer pull staging both run through ``reserve``);
* the backpressure API — ``reserve(nbytes)`` for staging buffers that live
  *outside* the arena (driver-side chunks in flight, pull staging), and
  ``under_pressure()`` / ``pressure_score()`` for callers that should slow
  down or place work elsewhere. The cluster scheduler reads the score through
  the statistics DB and penalizes nodes that are already spilling;
* admission control — ``try_reserve(nbytes, urgency=...)`` and the
  ``AdmissionController``: the pressure signal becomes a *grant*. In-flight
  staging is capped at a watermark-derived budget, writers block (with
  timeout) instead of stampeding a pressured node, and refusals are counted
  so schedulers can re-route refused work instead of pushing pages at a node
  that is already spilling.

``BufferPool`` delegates to it (``pool.paging`` / ``pool.spill`` /
``pool.stats`` are views into the manager), and ``StorageNode`` exposes it to
the runtime as ``node.memory``.

Copy of the JAX package's ``core/memory_manager.py``. One change: ``close``
closes the page log after releasing the manager's lock, since closing may
fsync the log's tail.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Set

from .attributes import DurabilityType
from .pagelog import PageLog
from .paging import PagingSystem
from .sanitizer import tracked_condition, tracked_rlock

# smallest staging budget a node will advertise: tiny pools (unit tests,
# smoke configs) must still admit a page-sized chunk or nothing ever moves
STAGING_CAP_FLOOR = 256 << 10


def derive_staging_cap(capacity: int, watermark: float) -> int:
    """The in-flight staging budget the pressure watermark implies: the
    headroom the watermark leaves free is what out-of-arena staging may
    occupy at once, floored so small pools still admit one chunk."""
    return max(min(capacity, STAGING_CAP_FLOOR),
               int((1.0 - watermark) * capacity))


class SpillStore:
    """Secondary storage for evicted pages. In-memory by default; set
    ``directory`` to spill to real files (used by the I/O benchmarks).
    Tracks every page id it holds so ``clear()`` can delete them all when the
    owning node goes away (leak fix: spill files used to outlive their
    pool)."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        self._mem: Dict[int, bytes] = {}
        self._held: Set[int] = set()
        self.bytes_written = 0
        self.bytes_read = 0
        self.write_ops = 0
        self.read_ops = 0
        if directory:
            os.makedirs(directory, exist_ok=True)

    def _path(self, page_id: int) -> str:
        return os.path.join(self.directory, f"page_{page_id}.bin")

    def write(self, page_id: int, data: bytes) -> None:
        self.bytes_written += len(data)
        self.write_ops += 1
        self._held.add(page_id)
        if self.directory:
            with open(self._path(page_id), "wb") as f:
                f.write(data)
        else:
            self._mem[page_id] = bytes(data)

    def read(self, page_id: int) -> bytes:
        self.read_ops += 1
        if self.directory:
            with open(self._path(page_id), "rb") as f:
                data = f.read()
        else:
            data = self._mem[page_id]
        self.bytes_read += len(data)
        return data

    def delete(self, page_id: int) -> None:
        self._held.discard(page_id)
        if self.directory:
            try:
                os.remove(self._path(page_id))
            except FileNotFoundError:
                pass
        else:
            self._mem.pop(page_id, None)

    def held_page_ids(self) -> Set[int]:
        return set(self._held)

    def clear(self) -> None:
        """Delete every page image this store holds."""
        for pid in list(self._held):
            self.delete(pid)


class MemoryReservation:
    """A ``reserve()``/``try_reserve()`` grant: bytes staged outside the arena
    but charged to this node. Context-managed so staging buffers can't leak
    accounting. Release is idempotent *under the manager's lock* — two racing
    releasers (a worker's ``finally`` and an engine-side cleanup) must not
    decrement twice and silently drive ``reserved_bytes`` negative."""

    def __init__(self, manager: "MemoryManager", nbytes: int):
        self.manager = manager
        self.nbytes = nbytes
        self._released = False

    def release(self) -> None:
        with self.manager._lock:
            if self._released:
                return
            self._released = True
            self.manager._release(self.nbytes)

    def __enter__(self) -> "MemoryReservation":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class AdmissionController:
    """Turns one node's pressure signal into an admission decision.

    Two distinct questions, both derived from the watermark:

    * **staging admission** (``try_reserve`` via the manager) — may a writer
      put another ``nbytes`` of out-of-arena staging in flight right now?
      Granted while ``reserved_bytes`` stays under ``cap`` (a node with no
      staging in flight always admits one chunk, however large, so oversized
      single requests can't starve). Writers wait on the node's condition
      variable and are woken by releases.
    * **placement admission** (``admit_placement``) — would ``nbytes`` of new
      work *landing* on this node fit under the pressure watermark given
      what is already resident and staged? The cluster scheduler probes this
      with a deadline before pinning a reducer here and re-routes the
      partition when the node refuses past it.

    ``refused`` / ``throttled`` / ``forced`` count what the loop actually did
    and are published through ``pressure_report`` (and from there into the
    statistics DB alongside the pressure score).
    """

    #: bound on how long a waiting ask (``normal`` or ``required``) parks
    #: when the caller gave no timeout — an unbounded wait could deadlock a
    #: caller whose own earlier reservation is what holds the cap, and for
    #: "required" it would make the promised forced grant unreachable
    DEFAULT_WAIT_TIMEOUT_S = 1.0

    def __init__(self, manager: "MemoryManager", cap: Optional[int] = None):
        self.manager = manager
        self.cap = (derive_staging_cap(manager.capacity,
                                       manager.pressure_watermark)
                    if cap is None else cap)
        self._cv = tracked_condition("memman.cv", manager._lock)
        self.refused = 0      # asks denied past their deadline
        self.throttled = 0    # asks that waited before being granted
        self.forced = 0       # urgency="required" grants past the deadline
        self.waiting = 0      # asks currently parked on the condition var
        self._listeners: List = []   # notify hooks (event-name callbacks)

    # -- event hooks (deflaked tests, serving-tier schedulers) ---------------
    def add_notify_listener(self, fn) -> None:
        """Register ``fn(event)`` called on admission state changes:
        ``"waiting"`` when an ask parks on the condition variable and
        ``"release"`` whenever headroom appears (reservation released, pages
        freed, durable handoff). Callbacks run under the manager lock and
        must be non-blocking (set an ``Event``, bump a counter — no manager
        calls)."""
        with self._cv:
            self._listeners.append(fn)

    def remove_notify_listener(self, fn) -> None:
        with self._cv:
            self._listeners.remove(fn)

    def _fire(self, event: str) -> None:
        for fn in list(self._listeners):
            fn(event)

    def wait_until(self, predicate, timeout: float = 5.0) -> bool:
        """Park on the node's condition variable until ``predicate()`` holds
        (checked under the manager lock on every admission event) — the
        event-driven replacement for wall-clock polling loops in tests."""
        with self._cv:
            return self._cv.wait_for(predicate, timeout=timeout)

    # both predicates assume the manager's lock is held
    def _staging_headroom(self, nbytes: int) -> bool:
        m = self.manager
        return (m.reserved_bytes == 0
                or m.reserved_bytes + nbytes <= self.cap)

    def _placement_headroom(self, nbytes: int) -> bool:
        m = self.manager
        occupied = m.resident_bytes + m.reserved_bytes
        return occupied + nbytes <= m.pressure_watermark * m.capacity

    def _notify(self) -> None:
        self._cv.notify_all()
        self._fire("release")

    def try_reserve(self, nbytes: int, *, urgency: str = "normal",
                    timeout: Optional[float] = None
                    ) -> Optional[MemoryReservation]:
        """Staging admission with blocking-with-timeout waits.

        * ``urgency="low"`` — never waits; refused immediately without
          headroom (opportunistic stagers, e.g. prefetchers).
        * ``urgency="normal"`` — waits up to ``timeout`` for headroom, then
          is refused (callers re-route or retry elsewhere).
        * ``urgency="required"`` — waits up to ``timeout``, then is granted
          anyway (correctness paths that must not drop data; the monolithic
          pool spills rather than loses records). Counted as ``forced``.
        """
        if urgency not in ("low", "normal", "required"):
            raise ValueError(f"unknown urgency {urgency!r}")
        if timeout is None and urgency != "low":
            # bounded by default: waiting forever could deadlock a caller
            # whose own earlier reservation holds the cap, and for
            # "required" it would make the promised forced grant unreachable
            timeout = self.DEFAULT_WAIT_TIMEOUT_S
        m = self.manager
        with self._cv:
            if not self._staging_headroom(nbytes):
                granted = False
                if urgency != "low" and timeout > 0:
                    self.waiting += 1
                    # wake wait_until() watchers of `waiting` (they re-check
                    # their predicate and re-park; peers see no headroom change)
                    self._cv.notify_all()
                    self._fire("waiting")
                    try:
                        granted = self._cv.wait_for(
                            lambda: self._staging_headroom(nbytes),
                            timeout=timeout)
                    finally:
                        self.waiting -= 1
                        self._cv.notify_all()
                if granted:
                    self.throttled += 1
                else:
                    if urgency != "required":
                        self.refused += 1
                        return None
                    self.forced += 1
            m.reserved_bytes += nbytes
            m.reserved_hwm = max(m.reserved_hwm, m.reserved_bytes)
        return MemoryReservation(m, nbytes)

    def admit_placement(self, nbytes: int,
                        deadline_s: Optional[float] = 0.0,
                        count: bool = True) -> bool:
        """Placement admission: True when ``nbytes`` of landing work fits
        under the watermark, waiting up to ``deadline_s`` for headroom to
        appear. A refusal past the deadline is counted — the scheduler's cue
        to re-place the work on the next-best candidate. ``count=False``
        marks a cheap re-probe of a node that already refused this planning
        pass, so probe declines don't inflate the ``refused`` counter."""
        with self._cv:
            if self._placement_headroom(nbytes):
                return True
            if deadline_s and self._cv.wait_for(
                    lambda: self._placement_headroom(nbytes),
                    timeout=deadline_s):
                self.throttled += 1
                return True
            if count:
                self.refused += 1
            return False


class MemoryManager:
    """Owns one node's eviction policy, spill store, and pressure accounting.

    All byte counters are *logical* page bytes (what callers asked for, not
    TLSF-rounded block sizes); ``BufferPool`` drives them through the
    ``note_*`` hooks under its own lock, and external stagers charge
    themselves via ``reserve``.
    """

    def __init__(self, capacity: int, spill_store: Optional[SpillStore] = None,
                 policy: str = "data-aware",
                 pressure_watermark: float = 0.85,
                 admission_cap: Optional[int] = None,
                 pagelog: Optional[PageLog] = None):
        self.capacity = capacity
        self.spill = spill_store or SpillStore()
        # the durable tier beneath the scratch spill store: write-through
        # sets page against it instead, and it survives node death
        self.pagelog = pagelog
        self.paging = PagingSystem(policy)
        self.pressure_watermark = pressure_watermark
        self._lock = tracked_rlock("memman")
        self.admission = AdmissionController(self, admission_cap)
        # live counters
        self.resident_bytes = 0
        self.pinned_bytes = 0
        # bytes paged OUT: spilled AND not resident (a write-through
        # durability copy of a resident page is not pressure)
        self.spilled_bytes = 0
        # bytes whose only live copy is the durable page log. NOT pressure:
        # the log is long-lived data's home tier, not an eviction overflow —
        # a node serving a larger-than-RAM set from its log must keep
        # attracting placement, which ``spilled_bytes`` would repel
        self.durable_bytes = 0
        self.reserved_bytes = 0    # out-of-arena staging charged via reserve()
        # high-water marks
        self.resident_hwm = 0
        self.pinned_hwm = 0
        self.reserved_hwm = 0
        self.stats: Dict[str, int] = {"evictions": 0, "spill_bytes": 0,
                                      "fetch_bytes": 0, "alloc_retries": 0,
                                      "log_bytes": 0, "log_fetch_bytes": 0}

    @property
    def policy(self) -> str:
        return self.paging.policy

    # -- accounting hooks (called by BufferPool) ------------------------------
    def note_alloc(self, nbytes: int) -> None:
        with self._lock:
            self.resident_bytes += nbytes
            self.resident_hwm = max(self.resident_hwm, self.resident_bytes)

    def note_free(self, nbytes: int) -> None:
        with self._lock:
            self.resident_bytes -= nbytes
            # freed residency is admission headroom: wake placement probes
            # and throttled writers now instead of letting them sleep out
            # their full deadline against a predicate that already holds
            self.admission._notify()

    def note_pinned(self, nbytes: int) -> None:
        """A page's pin count went 0 -> 1: its bytes are now unevictable."""
        with self._lock:
            self.pinned_bytes += nbytes
            self.pinned_hwm = max(self.pinned_hwm, self.pinned_bytes)

    def note_unpinned(self, nbytes: int) -> None:
        """A page's pin count went 1 -> 0."""
        with self._lock:
            self.pinned_bytes -= nbytes

    def note_spilled(self, nbytes: int) -> None:
        """Bytes written to the spill store (durability copies included)."""
        with self._lock:
            self.stats["spill_bytes"] += nbytes

    def note_paged_out(self, nbytes: int) -> None:
        """A page left residency with its backing copy on "disk"."""
        with self._lock:
            self.spilled_bytes += nbytes

    def note_paged_in(self, nbytes: int) -> None:
        """A paged-out page was faulted back into the arena."""
        with self._lock:
            self.spilled_bytes -= nbytes

    def note_fetched(self, nbytes: int) -> None:
        with self._lock:
            self.stats["fetch_bytes"] += nbytes

    def discard_spilled(self, page_id: int, nbytes: int,
                        paged_out: bool) -> None:
        """Delete a page's spill image (set dropped or lifetime ended);
        ``paged_out`` says whether those bytes were counted as pressure
        (non-resident) or were just a durability copy of a resident page."""
        with self._lock:
            self.spill.delete(page_id)
            if paged_out:
                self.spilled_bytes -= nbytes

    # -- durable tier (page log) ----------------------------------------------
    def durable_route(self, ls) -> bool:
        """Whether a set's persisted images belong in the page log instead of
        the scratch spill store: write-through durability (long-lived user
        data, paper §4) on a node that has a durable tier configured."""
        return (self.pagelog is not None
                and ls.attrs.durability == DurabilityType.WRITE_THROUGH)

    def pagelog_write(self, set_name: str, page, data: bytes) -> None:
        """Persist one page image into the durable log, keyed
        ``(set, page.log_seq)``; first write allocates the set's next
        sequence number, rewrites supersede in place (append-only)."""
        # The log runs under its own lock (and fsyncs outside it); holding
        # the manager lock across disk I/O would stall every accounting hook
        # behind an appender.  Same-page write races are excluded upstream:
        # the buffer pool runs its log writes one at a time, in the order it
        # queued them, so a page's second image lands after its first and
        # reuses the seq the first one recorded here.
        entry = self.pagelog.append(
            set_name, data, seq=page.log_seq if page.log_seq >= 0 else None)
        with self._lock:
            page.log_seq = entry.seq
            page.durable = True
            self.stats["log_bytes"] += len(data)

    def pagelog_read(self, set_name: str, seq: int) -> bytes:
        data = self.pagelog.read(set_name, seq)
        with self._lock:
            self.stats["log_fetch_bytes"] += len(data)
        return data

    def note_durable_out(self, nbytes: int) -> None:
        """A page's only live copy is now the durable log (evicted clean, or
        adopted non-resident at warm start)."""
        with self._lock:
            self.durable_bytes += nbytes

    def note_durable_in(self, nbytes: int) -> None:
        """A log-backed page was faulted back into the arena."""
        with self._lock:
            self.durable_bytes -= nbytes
            self.admission._notify()

    def discard_durable(self, nbytes: int, paged_out: bool) -> None:
        """Account a dropped durable page; the log itself is append-only, so
        the set-level tombstone (``PageLog.drop_set``) is the actual cut."""
        with self._lock:
            if paged_out:
                self.durable_bytes -= nbytes

    # -- backpressure / admission ---------------------------------------------
    def reserve(self, nbytes: int) -> MemoryReservation:
        """Charge ``nbytes`` of out-of-arena staging to this node. Always
        grants (the monolithic pool spills rather than refuses) but moves the
        pressure signal, which is what schedulers and stagers key off.
        Paced writers use ``try_reserve`` instead and respect the grant."""
        with self._lock:
            self.reserved_bytes += nbytes
            self.reserved_hwm = max(self.reserved_hwm, self.reserved_bytes)
        return MemoryReservation(self, nbytes)

    def try_reserve(self, nbytes: int, *, urgency: str = "normal",
                    timeout: Optional[float] = None
                    ) -> Optional[MemoryReservation]:
        """Admission-controlled staging grant — see ``AdmissionController``.
        Returns None when the node refuses past the timeout (the caller
        should back off or route elsewhere); ``urgency="required"`` never
        returns None."""
        return self.admission.try_reserve(nbytes, urgency=urgency,
                                          timeout=timeout)

    def _release(self, nbytes: int) -> None:
        with self._lock:
            self.reserved_bytes -= nbytes
            if self.reserved_bytes < 0:
                # explicit raise, not `assert`: accounting corruption must
                # stay loud under `python -O` too
                raise AssertionError(
                    f"reserved_bytes went negative ({self.reserved_bytes}) "
                    f"— a reservation was released more bytes than it "
                    f"charged")
            self.admission._notify()

    def reset_reserved_hwm(self) -> int:
        """Start a fresh reservation high-water window (returns the old
        mark). Callers that assert a staging bound — e.g. the streaming
        remesh's O(page) driver guarantee — reset first so the measurement
        is theirs, not some earlier stager's."""
        with self._lock:
            old = self.reserved_hwm
            self.reserved_hwm = self.reserved_bytes
            return old

    def under_pressure(self) -> bool:
        """True when the node is past its watermark (arena residency plus
        out-of-arena reservations), or is carrying more paged-out bytes than
        its remaining watermark headroom could fault back — i.e. new work
        placed here will likely page.

        Paged-out bytes alone are NOT pressure (bugfix): after a burst
        is consumed and dropped, a node may hold cold data on disk while its
        arena sits nearly empty. Those bytes fault back on demand into free
        space, so the node should attract placement again — the old
        ``spilled_bytes > 0`` check repelled it indefinitely. Durability
        copies of resident pages were never counted here (they are images,
        not page-outs) and still are not."""
        with self._lock:
            occupied = self.resident_bytes + self.reserved_bytes
            wm = self.pressure_watermark * self.capacity
            return occupied >= wm or occupied + self.spilled_bytes > wm

    def pressure_score(self) -> float:
        """Scalar pressure in [0, 1] for placement penalties: how far past
        the watermark the node sits, counting only the paged-out bytes that
        could NOT fault back under the watermark (cold on-disk residue with
        free headroom above it scores zero — see ``under_pressure``)."""
        with self._lock:
            occupied = self.resident_bytes + self.reserved_bytes
            wm = self.pressure_watermark * self.capacity
            over = max(0.0, occupied - wm) / max(1.0, self.capacity - wm)
            spill_over = max(0.0, occupied + self.spilled_bytes - wm) \
                / max(1, self.capacity)
            return min(1.0, max(over, spill_over))

    def pressure_report(self) -> Dict[str, float]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "resident": self.resident_bytes,
                "pinned": self.pinned_bytes,
                "spilled": self.spilled_bytes,
                "durable": self.durable_bytes,
                "reserved": self.reserved_bytes,
                "resident_hwm": self.resident_hwm,
                "pinned_hwm": self.pinned_hwm,
                "reserved_hwm": self.reserved_hwm,
                "under_pressure": self.under_pressure(),
                "pressure_score": self.pressure_score(),
                "admission_cap": self.admission.cap,
                "refused": self.admission.refused,
                "throttled": self.admission.throttled,
                "forced": self.admission.forced,
                "waiting": self.admission.waiting,
                **self.stats,
                **(
                    {
                        "pagelog_bytes": self.pagelog.file_bytes(),
                        "pagelog_amplification": self.pagelog.amplification(),
                        "pagelog_generation": self.pagelog.generation,
                        "pagelog_compactions": self.pagelog.compactions,
                    }
                    if self.pagelog is not None else {}
                ),
            }

    def close(self) -> None:
        """Tear the node's SCRATCH storage down with it: every spill image
        this manager wrote is deleted, so killed/replaced nodes don't leak
        spill files. The durable page log is deliberately NOT wiped — its
        files surviving the process is the entire point of the tier; only
        its handles are closed. (A cold restart that really lost the disk is
        modeled by ``Cluster.revive_node(warm=False)``, which removes the
        log directory before reopening.)"""
        with self._lock:
            self.spill.clear()
            self.spilled_bytes = 0
            self.durable_bytes = 0
        if self.pagelog is not None:
            self.pagelog.close()
