"""The unified buffer pool — paper §5.

One pool manages *all* data (user data, job data, shuffle data, hash data, KV
pages, dataset staging) in a single shared arena, the monolithic alternative to
per-layer caches. Pages are allocated from the arena by a TLSF allocator
(paper §5); callers receive zero-copy numpy views (the mmap shared-memory
analogue). Pin/unpin with reference counting.

Everything pressure-related — the data-aware ``PagingSystem``
(paper §6), the ``SpillStore``, resident/pinned/spilled accounting with
high-water marks, and the ``reserve``/``under_pressure`` backpressure API —
is owned by the per-node ``MemoryManager`` (``core/memory_manager.py``); the
pool is the arena + page mechanics and delegates policy to its manager
(``pool.memory``). ``pool.paging`` / ``pool.spill`` / ``pool.stats`` remain
as views into the manager for existing callers.

Copy of the JAX package's ``core/buffer_pool.py``; nothing changes.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from .attributes import AttributeSet, DurabilityType, Lifetime
from .locality_set import LocalitySet, Page
from .memory_manager import MemoryManager, SpillStore
from .paging import PagingSystem
from .sanitizer import tracked_rlock
from .tlsf import TLSF

__all__ = ["BufferPool", "PoolExhaustedError", "SpillStore", "MemoryManager"]


class PoolExhaustedError(MemoryError):
    """Raised when an allocation cannot be satisfied even after eviction
    (every resident page is pinned)."""


class BufferPool:
    """Monolithic pool over a single arena (paper §5).

    ``capacity`` bytes of "RAM"; everything beyond that spills through the
    data-aware paging system to the memory manager's spill store.
    """

    def __init__(self, capacity: int, spill_store: Optional[SpillStore] = None,
                 policy: str = "data-aware",
                 memory: Optional[MemoryManager] = None,
                 pressure_watermark: float = 0.85,
                 pagelog=None):
        self.capacity = capacity
        self.arena = np.zeros(capacity, dtype=np.uint8)
        self.tlsf = TLSF(capacity)
        self.memory = memory or MemoryManager(
            capacity, spill_store, policy,
            pressure_watermark=pressure_watermark, pagelog=pagelog)
        self.clock = 1  # logical time (paper: AccessRecency integers)
        self._pages: Dict[int, Page] = {}
        self._next_page_id = 0
        self._lock = tracked_rlock("buffer_pool")

    # -- delegation views (the earlier public surface) -----------------------------
    @property
    def spill(self) -> SpillStore:
        return self.memory.spill

    @property
    def paging(self) -> PagingSystem:
        return self.memory.paging

    @property
    def stats(self) -> Dict[str, int]:
        return self.memory.stats

    # -- locality-set lifecycle -------------------------------------------------
    def create_set(self, name: str, page_size: int,
                   attrs: Optional[AttributeSet] = None) -> LocalitySet:
        with self._lock:
            if name in self.paging.sets:
                raise ValueError(f"locality set {name!r} already exists")
            ls = LocalitySet(name, page_size, attrs)
            self.paging.register(ls, self.clock)
            return ls

    def get_set(self, name: str) -> LocalitySet:
        return self.paging.sets[name]

    def rename_set(self, ls: LocalitySet, new_name: str) -> LocalitySet:
        """Re-key a locality set (streaming remesh writes a shard under a
        staging name, then renames it into place once the old shard's pages
        are gone). Page ids are pool-global, so spill images carry over."""
        with self._lock:
            if new_name == ls.name:
                return ls
            if new_name in self.paging.sets:
                raise ValueError(f"locality set {new_name!r} already exists")
            self.paging.unregister(ls.name)
            old_name = ls.name
            ls.name = new_name
            for page in ls.pages.values():
                page.set_name = new_name
            if (self.memory.pagelog is not None
                    and any(p.durable for p in ls.pages.values())):
                # re-key the durable images too (O(1) rename record): replay
                # must find them under the name the catalog will ask for
                self.memory.pagelog.rename_set(old_name, new_name)
            self.paging.register(ls, self.clock)
            return ls

    def drop_set(self, ls: LocalitySet) -> None:
        """Free every page (lifetime over, data discarded) — including any
        spill images, which otherwise leak in the spill store."""
        with self._lock:
            any_durable = False
            for page in list(ls.pages.values()):
                if page.pinned:  # dropped out from under a holder
                    self.memory.note_unpinned(page.size)
                    page.pin_count = 0
                paged_out = page.spilled and not page.resident
                if page.resident:
                    self.tlsf.free(page.offset)
                    self.memory.note_free(page.size)
                    page.offset = None
                if page.spilled:
                    if page.durable:
                        any_durable = True
                        self.memory.discard_durable(page.size, paged_out)
                    else:
                        self.memory.discard_spilled(page.page_id, page.size,
                                                    paged_out)
                    page.spilled = False
                self._pages.pop(page.page_id, None)
            ls.pages.clear()
            self.paging.unregister(ls.name)
            if any_durable:
                # one set-level tombstone cuts every log entry (append-only
                # log: per-page deletes don't exist); replay will not
                # resurrect the dropped set
                self.memory.pagelog.drop_set(ls.name)

    # -- warm start from the durable tier -----------------------------------------
    def adopt_durable_set(self, name: str, page_size: int,
                          attrs: Optional[AttributeSet] = None) -> LocalitySet:
        """Re-register a set whose page images live in the durable log (the
        warm-start path): every live log entry becomes a non-resident page
        that faults back in on first pin. No bytes are read here — adoption
        is O(index), which is what makes a warm restart cheap."""
        with self._lock:
            log = self.memory.pagelog
            if log is None:
                raise ValueError("pool has no durable page log to adopt from")
            entries = log.entries_for(name)
            if not entries:
                raise KeyError(f"page log holds no entries for {name!r}")
            if attrs is None:
                attrs = AttributeSet(durability=DurabilityType.WRITE_THROUGH)
            ls = self.create_set(name, page_size, attrs)
            for e in entries:
                page = Page(page_id=self._next_page_id, set_name=name,
                            size=e.length, offset=None, pin_count=0,
                            dirty=False, spilled=True,
                            last_access=self._tick(),
                            durable=True, log_seq=e.seq)
                self._next_page_id += 1
                ls.pages[page.page_id] = page
                self._pages[page.page_id] = page
                self.memory.note_durable_out(e.length)
            return ls

    def warm_start(self, page_size: int,
                   attrs_factory=None) -> List[str]:
        """Adopt every set the durable log replayed (standalone-pool warm
        restart, e.g. a pool-backed checkpoint store; the cluster path
        adopts per shard after epoch fencing instead). Returns the adopted
        set names."""
        adopted: List[str] = []
        log = self.memory.pagelog
        if log is None:
            return adopted
        for name in log.set_names():
            if name in self.paging.sets:
                continue
            attrs = attrs_factory() if attrs_factory is not None else None
            self.adopt_durable_set(name, page_size, attrs)
            adopted.append(name)
        return adopted

    # -- page operations ----------------------------------------------------------
    def _tick(self) -> int:
        self.clock += 1
        return self.clock

    def new_page(self, ls: LocalitySet, size: Optional[int] = None) -> Page:
        """Allocate (and pin) a fresh page in ``ls``."""
        with self._lock:
            size = size or ls.page_size
            offset = self._alloc_with_eviction(size)
            page = Page(page_id=self._next_page_id, set_name=ls.name, size=size,
                        offset=offset, pin_count=1, dirty=True,
                        last_access=self._tick())
            self.memory.note_alloc(size)
            self.memory.note_pinned(size)
            self._next_page_id += 1
            ls.pages[page.page_id] = page
            self._pages[page.page_id] = page
            return page

    def view(self, page: Page) -> np.ndarray:
        """Zero-copy numpy view of a resident page (the shared-memory interface)."""
        if not page.resident:
            raise ValueError(f"page {page.page_id} is not resident")
        return self.arena[page.offset:page.offset + page.size]

    def pin(self, page: Page) -> np.ndarray:
        """Pin a page, fetching it from the spill store if necessary; returns
        the page view. Increments the reference count (paper §5)."""
        with self._lock:
            ls = self.get_set(page.set_name)
            if not page.resident:
                offset = self._alloc_with_eviction(page.size)
                page.offset = offset
                self.memory.note_alloc(page.size)
                if page.spilled:
                    raw = (self.memory.pagelog_read(ls.name, page.log_seq)
                           if page.durable
                           else self.spill.read(page.page_id))
                    data = np.frombuffer(raw, dtype=np.uint8)
                    self.arena[offset:offset + page.size] = data
                    ls.stats["fetch_bytes"] += page.size
                    self.memory.note_fetched(page.size)
                    if page.durable:
                        self.memory.note_durable_in(page.size)
                    else:
                        self.memory.note_paged_in(page.size)
                page.dirty = False
            if page.pin_count == 0:
                self.memory.note_pinned(page.size)
            page.pin_count += 1
            page.last_access = self._tick()
            return self.view(page)

    def unpin(self, page: Page, dirty: bool = False) -> None:
        with self._lock:
            if page.pin_count <= 0:
                raise ValueError(f"unpin of unpinned page {page.page_id}")
            page.pin_count -= 1
            if page.pin_count == 0:
                self.memory.note_unpinned(page.size)
            page.dirty = page.dirty or dirty
            ls = self.get_set(page.set_name)
            # write-through: persist immediately once written (paper §4)
            if (page.dirty and ls.attrs.durability == DurabilityType.WRITE_THROUGH):
                self._spill_page(ls, page)
                page.dirty = False
                page.spilled = True

    # -- eviction (Algorithm 1 driver) ---------------------------------------------
    def _alloc_with_eviction(self, size: int) -> int:
        offset = self.tlsf.alloc(size)
        while offset is None:
            self.stats["alloc_retries"] += 1
            picked = self.memory.paging.pick_victims(self.clock)
            if picked is None:
                raise PoolExhaustedError(
                    f"cannot allocate {size}B: all resident pages pinned "
                    f"(free={self.tlsf.free_bytes}B of {self.capacity}B)")
            ls, victims = picked
            # evict incrementally — "one or more" (paper Alg. 1), stopping as
            # soon as the allocation fits; evicting the whole candidate list
            # would defeat MRU's working-prefix retention on sequential scans
            for page in victims:
                self._evict_page(ls, page)
                offset = self.tlsf.alloc(size)
                if offset is not None:
                    return offset
            offset = self.tlsf.alloc(size)
        return offset

    def _spill_page(self, ls: LocalitySet, page: Page) -> None:
        data = self.arena[page.offset:page.offset + page.size].tobytes()
        if self.memory.durable_route(ls):
            # write-through sets persist into the durable page log, the tier
            # below scratch spill: the image survives node death and a
            # restarted node warm-starts from it
            self.memory.pagelog_write(ls.name, page, data)
        else:
            self.spill.write(page.page_id, data)
        page.spilled = True
        ls.stats["spill_bytes"] += page.size
        self.memory.note_spilled(page.size)

    def _evict_page(self, ls: LocalitySet, page: Page) -> None:
        assert page.resident and not page.pinned
        if ls.needs_spill_on_evict(page):
            self._spill_page(ls, page)
        page.dirty = False
        self.tlsf.free(page.offset)
        self.memory.note_free(page.size)
        page.offset = None
        ls.stats["evictions"] += 1
        self.stats["evictions"] += 1
        if ls.attrs.lifetime == Lifetime.ENDED:
            # data will never be read again; drop any spill image too (it
            # was a copy of a resident page, so it never counted as paged out)
            if page.spilled and not page.durable:
                self.memory.discard_spilled(page.page_id, page.size,
                                            paged_out=False)
                page.spilled = False
        elif page.spilled:
            if page.durable:
                # only copy is the durable log — its home tier, not pressure
                self.memory.note_durable_out(page.size)
            else:
                # the page's only live copy is now on "disk": that is pressure
                self.memory.note_paged_out(page.size)

    # -- iteration helper (sequential-read service uses this) ----------------------
    def iter_pages(self, ls: LocalitySet) -> Iterator[Page]:
        for pid in sorted(ls.pages):
            yield ls.pages[pid]

    # -- accounting ------------------------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        return self.tlsf.allocated_bytes

    def memory_report(self) -> Dict[str, Dict[str, int]]:
        rep: Dict[str, Dict[str, int]] = {}
        for name, ls in self.paging.sets.items():
            resident = sum(p.size for p in ls.pages.values() if p.resident)
            spilled = sum(p.size for p in ls.pages.values() if p.spilled and not p.resident)
            rep[name] = {"resident": resident, "spilled": spilled,
                         **ls.stats}
        return rep
