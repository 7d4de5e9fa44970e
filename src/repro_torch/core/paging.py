"""Data-aware paging system — paper §6, Algorithm 1 + Eq. 1.

The paging system orders all locality sets by the overhead ``O`` of evicting
their pages:

    O = -1 * (t_now / t_r)   if lifetime == lifetime-ended
    O =  c * (t_r / t_now)   if lifetime == alive

where ``c`` is the Table-3 spilling-cost constant and ``t_r`` the set's access
recency. The set with the *lowest* O supplies victims; its per-set strategy
(MRU for sequential/concurrent patterns, LRU for random patterns) picks which
pages, and the CurrentOperation attribute caps how many (10% while writing).

A lazy min-heap keyed on O is maintained; entries are invalidated on attribute
updates (which are "significantly less frequent than page operations", §6).

Heap keys are memoized (PR-5 perf fix): at any fixed ``t_now`` Eq. 1 orders
ended sets by ``-1/t_r`` and alive sets by ``c * t_r`` (both classes scale
uniformly in ``t_now``, and ended overheads are negative while alive ones are
non-negative), so the heap is keyed on those ``t_now``-independent surrogates
and only *dirtied* sets — ones whose attributes actually changed — are ever
re-keyed. The old implementation re-pushed every registered set on every
eviction decision (O(sets·log sets) per allocation retry), which is exactly
the "full Eq.-1 heap refresh" wall-clock loss the ROADMAP flagged.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Tuple

from .attributes import Lifetime
from .locality_set import LocalitySet, Page


def eviction_overhead(ls: LocalitySet, clock: int) -> float:
    """Eq. 1. Lower = better eviction victim."""
    t_r = max(1, ls.attrs.access_recency)
    t_now = max(t_r, clock, 1)
    if ls.attrs.lifetime == Lifetime.ENDED:
        return -1.0 * (t_now / t_r)
    return ls.attrs.spilling_cost * (t_r / t_now)


class PagingSystem:
    """Algorithm 1: pick the lowest-priority locality set, evict victims from
    it using its selected strategy and tuned eviction count.

    ``policy`` selects the replacement approach (paper §9 comparisons):
      * "data-aware" — the paper's Eq.-1 dynamic priority (default);
      * "lru" / "mru" — global recency order across ALL sets, evicting 10%
        of unpinned pages per decision (the Fig.-3/8/9 baselines);
      * "freq-aware" — Eq. 1 with spilling cost replaced by access frequency
        (the paper's ablation in Fig. 3).
    """

    def __init__(self, policy: str = "data-aware"):
        self.policy = policy
        self._sets: Dict[str, LocalitySet] = {}
        self._heap: List[Tuple[float, int, str]] = []
        self._entry_count = itertools.count()
        self._stale: Dict[str, int] = {}  # name -> latest entry id
        self.rekeys = 0                   # heap pushes (memoization metric)

    # -- registration ----------------------------------------------------------
    def register(self, ls: LocalitySet, clock: int = 0) -> None:
        """Register a set with the paging system. ``clock`` is vestigial
        since the PR-5 memoization (heap keys are t_now-independent, so
        registration time never affects priority); accepted for caller
        compatibility."""
        self._sets[ls.name] = ls
        # attribute updates dirty the set: it alone is re-keyed
        ls._on_attr_update = self._push
        self._push(ls)

    def unregister(self, name: str) -> None:
        self._sets.pop(name, None)
        self._stale.pop(name, None)

    def _heap_key(self, ls: LocalitySet) -> float:
        """``t_now``-independent surrogate for Eq.-1 overhead: preserves the
        Eq.-1 ordering at every clock, so entries stay valid until the set's
        own attributes change (see module docstring)."""
        t_r = max(1, ls.attrs.access_recency)
        if self.policy == "freq-aware":
            # Fig.-3 ablation: spilling cost replaced by access frequency
            if ls.attrs.lifetime == Lifetime.ENDED:
                return -1.0
            return float(ls.stats.get("accesses", 0))
        if ls.attrs.lifetime == Lifetime.ENDED:
            return -1.0 / t_r
        return ls.attrs.spilling_cost * t_r

    def _push(self, ls: LocalitySet) -> None:
        eid = next(self._entry_count)
        self._stale[ls.name] = eid
        self.rekeys += 1
        heapq.heappush(self._heap, (self._heap_key(ls), eid, ls.name))

    def refresh(self, clock: int) -> None:
        """Re-key every set. With memoized keys this is never needed for
        correctness (attribute updates re-key incrementally); kept for
        explicit rebuilds after bulk attribute surgery."""
        for ls in self._sets.values():
            self._push(ls)

    # -- Algorithm 1 -----------------------------------------------------------
    def pick_victims(self, clock: int) -> Optional[Tuple[LocalitySet, List[Page]]]:
        """Returns (victim set, victim pages) or None if nothing evictable.

        Lazy-heap walk: skip stale entries and sets with no unpinned resident
        pages; re-push skipped-but-live sets so they stay in the queue.
        """
        if self.policy in ("lru", "mru"):
            return self._pick_global_recency(self.policy)
        repush: List[LocalitySet] = []
        found = None
        while self._heap:
            overhead, eid, name = heapq.heappop(self._heap)
            ls = self._sets.get(name)
            if ls is None or self._stale.get(name) != eid:
                continue  # stale entry
            victims = ls.select_victims()
            if victims:
                found = (ls, victims)
                repush.append(ls)
                break
            repush.append(ls)
        for ls in repush:
            self._push(ls)
        return found

    def _pick_global_recency(self, policy: str):
        """Fig.-3/8/9 baselines: 10% of unpinned pages by global recency,
        ignoring data semantics. Victims are grouped under their owning set
        (one set per call — the caller loops)."""
        pages: List[Tuple[int, LocalitySet, Page]] = []
        for ls in self._sets.values():
            for p in ls.unpinned_resident_pages():
                pages.append((p.last_access, ls, p))
        if not pages:
            return None
        pages.sort(key=lambda t: t[0], reverse=(policy == "mru"))
        n = max(1, len(pages) // 10)
        chosen = pages[:n]
        ls0 = chosen[0][1]
        same = [p for _, ls, p in chosen if ls is ls0]
        return ls0, same

    # -- introspection ---------------------------------------------------------
    def priority_order(self, clock: int) -> List[Tuple[str, float]]:
        """All sets ordered by Eq.-1 overhead (victims first) — for tests."""
        items = [(eviction_overhead(ls, clock), name) for name, ls in self._sets.items()]
        items.sort()
        return [(name, o) for o, name in items]

    @property
    def sets(self) -> Dict[str, LocalitySet]:
        return self._sets
