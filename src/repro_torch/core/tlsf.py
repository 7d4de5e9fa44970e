"""Two-Level Segregated Fit (TLSF) allocator — paper §5.

Pangea "by default uses the two-level segregated fit (TLSF) memory allocator to
allocate variable-sized pages from the shared memory". This is a faithful
reimplementation over a contiguous byte arena: first-level bins are power-of-two
size classes, each subdivided into ``2**SL_BITS`` linear second-level bins.
Free blocks carry boundary tags so coalescing with both neighbours is O(1);
find-suitable-block is O(1) via the two bitmap levels.

The arena itself is just byte accounting — callers receive ``(offset, size)``
and take numpy views into the pool's shared arena (the mmap-shared-memory
analogue from the paper).

Copy of the JAX package's ``core/tlsf.py``; nothing changes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

SL_BITS = 4  # 16 second-level subdivisions per first-level class
SL_COUNT = 1 << SL_BITS
MIN_BLOCK = 64  # bytes; everything is rounded up to this granularity


def _fls(x: int) -> int:
    """Index of the highest set bit (find-last-set)."""
    return x.bit_length() - 1


def _ffs(x: int) -> int:
    """Index of the lowest set bit (find-first-set); -1 if zero."""
    return (x & -x).bit_length() - 1


def _mapping(size: int) -> Tuple[int, int]:
    """size -> (first-level index, second-level index)."""
    fl = _fls(size)
    if fl < SL_BITS:
        return 0, size >> 1  # tiny sizes collapse into class 0
    sl = (size >> (fl - SL_BITS)) - SL_COUNT
    return fl - SL_BITS + 1, sl


@dataclass
class _Block:
    offset: int
    size: int
    free: bool
    prev_phys: Optional[int] = None  # offset of physically-previous block
    next_phys: Optional[int] = None
    prev_free: Optional[int] = None  # free-list links (offsets)
    next_free: Optional[int] = None


class TLSF:
    """TLSF allocator over ``capacity`` bytes. alloc() -> offset, free(offset)."""

    def __init__(self, capacity: int):
        if capacity < MIN_BLOCK:
            raise ValueError(f"capacity {capacity} < MIN_BLOCK {MIN_BLOCK}")
        self.capacity = capacity
        self._blocks: Dict[int, _Block] = {}
        fl_max, _ = _mapping(capacity)
        self._nfl = fl_max + 2
        self._fl_bitmap = 0
        self._sl_bitmap = [0] * self._nfl
        self._free_heads: Dict[Tuple[int, int], Optional[int]] = {}
        root = _Block(0, capacity, free=True)
        self._blocks[0] = root
        self._insert_free(root)
        self.allocated_bytes = 0

    # -- free-list bookkeeping ------------------------------------------------
    def _insert_free(self, b: _Block) -> None:
        fl, sl = _mapping(b.size)
        head = self._free_heads.get((fl, sl))
        b.prev_free = None
        b.next_free = head
        if head is not None:
            self._blocks[head].prev_free = b.offset
        self._free_heads[(fl, sl)] = b.offset
        self._fl_bitmap |= 1 << fl
        self._sl_bitmap[fl] |= 1 << sl

    def _remove_free(self, b: _Block) -> None:
        fl, sl = _mapping(b.size)
        if b.prev_free is not None:
            self._blocks[b.prev_free].next_free = b.next_free
        else:
            self._free_heads[(fl, sl)] = b.next_free
        if b.next_free is not None:
            self._blocks[b.next_free].prev_free = b.prev_free
        if self._free_heads.get((fl, sl)) is None:
            self._sl_bitmap[fl] &= ~(1 << sl)
            if self._sl_bitmap[fl] == 0:
                self._fl_bitmap &= ~(1 << fl)
        b.prev_free = b.next_free = None

    def _find_suitable(self, size: int) -> Optional[_Block]:
        fl, sl = _mapping(size)
        # search current fl for sl' >= sl, else any block in a higher fl
        sl_map = self._sl_bitmap[fl] & (~0 << sl) if fl < self._nfl else 0
        if sl_map == 0:
            fl_map = self._fl_bitmap & (~0 << (fl + 1))
            if fl_map == 0:
                return None
            fl = _ffs(fl_map)
            sl_map = self._sl_bitmap[fl]
        sl = _ffs(sl_map)
        off = self._free_heads.get((fl, sl))
        return self._blocks[off] if off is not None else None

    # -- public API -----------------------------------------------------------
    def alloc(self, size: int) -> Optional[int]:
        """Allocate ``size`` bytes; returns arena offset or None if exhausted."""
        size = max(MIN_BLOCK, (size + MIN_BLOCK - 1) // MIN_BLOCK * MIN_BLOCK)
        b = self._find_suitable(size)
        if b is None or b.size < size:
            return None
        self._remove_free(b)
        if b.size - size >= MIN_BLOCK:  # split; remainder stays free
            rem = _Block(b.offset + size, b.size - size, free=True,
                         prev_phys=b.offset, next_phys=b.next_phys)
            if b.next_phys is not None:
                self._blocks[b.next_phys].prev_phys = rem.offset
            b.next_phys = rem.offset
            b.size = size
            self._blocks[rem.offset] = rem
            self._insert_free(rem)
        b.free = False
        self.allocated_bytes += b.size
        return b.offset

    def free(self, offset: int) -> None:
        b = self._blocks.get(offset)
        if b is None or b.free:
            raise ValueError(f"double/invalid free at offset {offset}")
        b.free = True
        self.allocated_bytes -= b.size
        # coalesce with physical next
        if b.next_phys is not None:
            nxt = self._blocks[b.next_phys]
            if nxt.free:
                self._remove_free(nxt)
                b.size += nxt.size
                b.next_phys = nxt.next_phys
                if nxt.next_phys is not None:
                    self._blocks[nxt.next_phys].prev_phys = b.offset
                del self._blocks[nxt.offset]
        # coalesce with physical prev
        if b.prev_phys is not None:
            prv = self._blocks[b.prev_phys]
            if prv.free:
                self._remove_free(prv)
                prv.size += b.size
                prv.next_phys = b.next_phys
                if b.next_phys is not None:
                    self._blocks[b.next_phys].prev_phys = prv.offset
                del self._blocks[b.offset]
                b = prv
        self._insert_free(b)

    def block_size(self, offset: int) -> int:
        return self._blocks[offset].size

    @property
    def free_bytes(self) -> int:
        return self.capacity - self.allocated_bytes

    def check_invariants(self) -> None:
        """Debug/property-test hook: arena fully tiled, no adjacent free blocks."""
        off, total, prev = 0, 0, None
        while True:
            b = self._blocks[off]
            assert b.offset == off and b.prev_phys == prev
            if prev is not None:
                pb = self._blocks[prev]
                assert not (pb.free and b.free), "uncoalesced neighbours"
            total += b.size
            prev = off
            if b.next_phys is None:
                break
            off = b.next_phys
        assert total == self.capacity, f"arena leak: {total} != {self.capacity}"
