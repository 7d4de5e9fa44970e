"""Locality sets — paper §3.2.

A Pangea locality set is a set of equal-sized pages associated with one dataset
that an application uses in a uniform way. Pages may live in the buffer pool,
in the spill store ("disk"), or both. Attribute updates (operation / lifetime)
drive the paging system's dynamic priority (paper §6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .attributes import (
    AttributeSet,
    CurrentOperation,
    DurabilityType,
    EvictionStrategy,
    Lifetime,
    ReadingPattern,
    WritingPattern,
)


@dataclass
class Page:
    """Buffer-pool page metadata. ``offset`` is None when not resident."""

    page_id: int
    set_name: str
    size: int
    offset: Optional[int] = None        # arena offset when resident
    pin_count: int = 0                  # reference counting (paper §5)
    dirty: bool = False
    spilled: bool = False               # has an image in the spill store
    last_access: int = 0                # logical clock of last pin
    durable: bool = False               # backing image lives in the page log
    log_seq: int = -1                   # page-log sequence within its set

    @property
    def resident(self) -> bool:
        return self.offset is not None

    @property
    def pinned(self) -> bool:
        return self.pin_count > 0


class LocalitySet:
    """Pages + attributes + per-set eviction strategy (paper §3.2, §6)."""

    def __init__(self, name: str, page_size: int, attrs: Optional[AttributeSet] = None):
        self.name = name
        self.page_size = page_size
        self.attrs = attrs or AttributeSet()
        self.pages: Dict[int, Page] = {}
        self._next_local_id = 0
        # paging-system hook; set by BufferPool.create_set
        self._on_attr_update = None
        # per-set counters for the benchmarks (paper reports page-out volume)
        self.stats = {"evictions": 0, "spill_bytes": 0, "fetch_bytes": 0}

    # -- attribute transitions (these drive the §6 priority model) ------------
    def _touch(self, clock: int) -> None:
        self.attrs.access_recency = clock
        self.stats["accesses"] = self.stats.get("accesses", 0) + 1
        if self._on_attr_update:
            self._on_attr_update(self)

    def set_operation(self, op: CurrentOperation, clock: int) -> None:
        self.attrs.operation = op
        self._touch(clock)

    def end_lifetime(self, clock: int) -> None:
        self.attrs.lifetime = Lifetime.ENDED
        self.attrs.operation = CurrentOperation.IDLE
        self._touch(clock)

    def revive(self, clock: int) -> None:
        self.attrs.lifetime = Lifetime.ALIVE
        self._touch(clock)

    # -- service-driven attribute inference (paper §3.2) ----------------------
    def infer_from_service(self, service: str, clock: int) -> None:
        """Each service exhibits a specific writing/reading pattern."""
        if service == "sequential-write":
            self.attrs.writing = WritingPattern.SEQUENTIAL_WRITE
            self.set_operation(CurrentOperation.WRITE, clock)
        elif service == "sequential-read":
            self.attrs.reading = ReadingPattern.SEQUENTIAL_READ
            self.set_operation(CurrentOperation.READ, clock)
        elif service == "shuffle":
            self.attrs.writing = WritingPattern.CONCURRENT_WRITE
            self.set_operation(CurrentOperation.WRITE, clock)
        elif service == "hash":
            self.attrs.writing = WritingPattern.RANDOM_MUTABLE_WRITE
            self.attrs.reading = ReadingPattern.RANDOM_READ
            self.set_operation(CurrentOperation.READ_AND_WRITE, clock)
        else:
            raise ValueError(f"unknown service {service!r}")

    # -- victim selection (paper §6) -------------------------------------------
    def unpinned_resident_pages(self) -> List[Page]:
        return [p for p in self.pages.values() if p.resident and not p.pinned]

    def select_victims(self) -> List[Page]:
        """Order unpinned resident pages per the set's strategy and cap the
        count by the CurrentOperation eviction ratio (paper §6)."""
        candidates = self.unpinned_resident_pages()
        if not candidates:
            return []
        strategy = self.attrs.strategy
        reverse = strategy == EvictionStrategy.MRU  # MRU: most recent first
        candidates.sort(key=lambda p: p.last_access, reverse=reverse)
        ratio = self.attrs.eviction_ratio
        n = max(1, int(len(candidates) * ratio))
        return candidates[:n]

    def needs_spill_on_evict(self, page: Page) -> bool:
        """A dirty page of a live write-back set must be spilled before its
        memory is recycled (paper §5). Write-through pages were persisted at
        unpin time; lifetime-ended pages are simply dropped."""
        if self.attrs.lifetime == Lifetime.ENDED:
            return False
        if self.attrs.durability == DurabilityType.WRITE_THROUGH:
            return page.dirty  # not yet flushed (shouldn't happen post-unpin)
        return page.dirty or not page.spilled
