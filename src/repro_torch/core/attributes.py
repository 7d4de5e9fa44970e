"""Locality-set attributes (paper Table 2) and spilling costs (paper Table 3).

Every locality set carries a tag vector describing *how* an application uses it.
Attributes are either declared at creation time or inferred automatically from
the service that touches the set (paper §3.2 "Determining attributes").
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class DurabilityType(enum.Enum):
    """write-through: persist immediately on write (user data).

    write-back: keep in the pool; spill only on eviction (job/execution data).
    """

    WRITE_THROUGH = "write-through"
    WRITE_BACK = "write-back"


class WritingPattern(enum.Enum):
    SEQUENTIAL_WRITE = "sequential-write"      # immutable, write-once, in order
    CONCURRENT_WRITE = "concurrent-write"      # many streams into one page (shuffle)
    RANDOM_MUTABLE_WRITE = "random-mutable-write"  # alloc/modify/free (hash, KV state)
    NONE = "none"


class ReadingPattern(enum.Enum):
    SEQUENTIAL_READ = "sequential-read"
    RANDOM_READ = "random-read"
    NONE = "none"


class Location(enum.Enum):
    PINNED = "pinned"
    UNPINNED = "unpinned"


class Lifetime(enum.Enum):
    ALIVE = "alive"
    ENDED = "lifetime-ended"


class CurrentOperation(enum.Enum):
    READ = "read"
    WRITE = "write"
    READ_AND_WRITE = "read-and-write"
    IDLE = "idle"


class EvictionStrategy(enum.Enum):
    MRU = "mru"
    LRU = "lru"


class StorageScheme(enum.Enum):
    """Physical page layout of a locality set.

    row: ``[count:int64][record bytes...]`` — each page holds contiguous
    fixed-width records (the seed layout; every legacy set uses it).

    columnar: ``[count:int64][validity bitmap][col0 block][col1 block]...``
    — each page holds one column block: per-field contiguous arrays plus a
    validity bitmap (arrow-ish). Selected per set so the vectorized shuffle /
    aggregate / join kernels can stream whole columns without per-record
    decode; spill and pagelog paths are layout-oblivious (pages are opaque
    byte payloads either way).
    """

    ROW = "row"
    COLUMNAR = "columnar"


# ---------------------------------------------------------------------------
# Paper Table 3: normalized spilling-cost constants `c`.
# The cost is keyed on (reading/writing pattern, durability) because those are
# "the main factors determining the spilling cost" (paper §6 factor 2).
# ---------------------------------------------------------------------------
SPILL_COST_SEQ_WRITE_THROUGH = 1.0
SPILL_COST_SEQ_WRITE_BACK = 2.5
SPILL_COST_CONCURRENT_WRITE_BACK = 2.5
SPILL_COST_RANDOM_WRITE_BACK = 5.0


def spilling_cost(
    writing: WritingPattern,
    reading: ReadingPattern,
    durability: DurabilityType,
) -> float:
    """Table-3 lookup: normalized cost `c` of spilling one page of this set."""
    random_access = (
        writing == WritingPattern.RANDOM_MUTABLE_WRITE
        or reading == ReadingPattern.RANDOM_READ
    )
    if random_access:
        return SPILL_COST_RANDOM_WRITE_BACK
    if writing == WritingPattern.CONCURRENT_WRITE:
        return SPILL_COST_CONCURRENT_WRITE_BACK
    if durability == DurabilityType.WRITE_BACK:
        return SPILL_COST_SEQ_WRITE_BACK
    return SPILL_COST_SEQ_WRITE_THROUGH


def select_strategy(writing: WritingPattern, reading: ReadingPattern) -> EvictionStrategy:
    """Paper §6: MRU for sequential-write / concurrent-write / sequential-read
    locality sets, LRU for random-mutable-write / random-read sets."""
    if (
        writing == WritingPattern.RANDOM_MUTABLE_WRITE
        or reading == ReadingPattern.RANDOM_READ
    ):
        return EvictionStrategy.LRU
    return EvictionStrategy.MRU


# Eviction-ratio tuning (paper §6): evict only this fraction of unpinned pages
# from a victim set whose CurrentOperation involves `write`; a set that is only
# being read has no such limit (ratio 1.0).
WRITE_EVICTION_RATIO = 0.10


def eviction_ratio(op: CurrentOperation) -> float:
    if op in (CurrentOperation.WRITE, CurrentOperation.READ_AND_WRITE):
        return WRITE_EVICTION_RATIO
    return 1.0


@dataclass
class AttributeSet:
    """The full Table-2 tag vector for one locality set."""

    durability: DurabilityType = DurabilityType.WRITE_BACK
    writing: WritingPattern = WritingPattern.NONE
    reading: ReadingPattern = ReadingPattern.NONE
    lifetime: Lifetime = Lifetime.ALIVE
    operation: CurrentOperation = CurrentOperation.IDLE
    storage: StorageScheme = StorageScheme.ROW
    access_recency: int = 0  # integer timestamp of last access (paper Table 2)
    # free-form labels an application may attach (e.g. "kv-cache", "layer=3")
    labels: dict = field(default_factory=dict)

    @property
    def spilling_cost(self) -> float:
        return spilling_cost(self.writing, self.reading, self.durability)

    @property
    def strategy(self) -> EvictionStrategy:
        return select_strategy(self.writing, self.reading)

    @property
    def eviction_ratio(self) -> float:
        return eviction_ratio(self.operation)
