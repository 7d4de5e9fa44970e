"""Pangea core pieces the serving path needs: locality sets, Eq.-1 paging
(copies of the JAX package's numpy modules) and the device KV page pool."""
from .attributes import (AttributeSet, CurrentOperation, DurabilityType,
                         EvictionStrategy, Lifetime, Location, ReadingPattern,
                         WritingPattern, eviction_ratio, select_strategy,
                         spilling_cost)
from .kvcache import HBMExhaustedError, HostSlabStore, PagedKVCache, SeqState
from .locality_set import LocalitySet, Page
from .paging import PagingSystem, eviction_overhead

__all__ = [
    "AttributeSet", "CurrentOperation", "DurabilityType", "EvictionStrategy",
    "HBMExhaustedError", "HostSlabStore", "Lifetime", "LocalitySet",
    "Location", "Page", "PagedKVCache", "PagingSystem", "ReadingPattern",
    "SeqState", "WritingPattern", "eviction_overhead", "eviction_ratio",
    "select_strategy", "spilling_cost",
]
