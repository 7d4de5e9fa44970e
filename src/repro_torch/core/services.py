"""Pushed-down computational services — paper §8.

Services are how applications touch locality sets; each service exhibits a
specific access pattern, which is how attributes get inferred automatically
(paper §3.2). Implemented here over numpy record views into buffer-pool pages:

* Sequential read/write service — multi-worker page writers + concurrent page
  iterators (the data-pipeline substrate).
* Shuffle service — virtual shuffle buffers: many writers append records for
  the same partition into small pages split from one large page
  (concurrent-write pattern). The device-side half of shuffle for MoE dispatch
  lives in ``kernels/shuffle_dispatch``.
* Hash service — virtual hash buffer: each page is an independent open-
  addressing hash partition (extendible hashing); full pages split; when the
  pool is exhausted pages spill as partial aggregates and are re-aggregated.
* Join service — build partitioned hash maps from one set, probe with another.

Page layout for record pages: ``[count:int64][record bytes...]``.

Copy of the JAX package's ``core/services.py``; nothing changes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .attributes import (AttributeSet, CurrentOperation, DurabilityType,
                         StorageScheme, WritingPattern)
from .buffer_pool import BufferPool, PoolExhaustedError
from .columnar import (ColumnarWriter, _col_view, _field_layout,
                       columns_to_records, iter_column_blocks,
                       records_to_columns)
from .locality_set import LocalitySet, Page
from .sanitizer import tracked_lock

_HEADER = 8  # int64 record count at page start


def job_data_attrs() -> AttributeSet:
    """Attribute preset for shuffle/execution job data (paper §3.1): write-back
    (spill only under pressure), concurrent-write pattern; lifetime is ended
    explicitly once the consuming stage has pulled the data."""
    return AttributeSet(durability=DurabilityType.WRITE_BACK,
                        writing=WritingPattern.CONCURRENT_WRITE)


def user_data_attrs() -> AttributeSet:
    """Attribute preset for long-lived user data (paper §3.1/§4):
    write-through durability — every written page is persisted at unpin, and
    on a node with a durable page log the images land there, so the set
    pages against disk as its working set exceeds the pool and survives a
    node restart (warm recovery)."""
    return AttributeSet(durability=DurabilityType.WRITE_THROUGH,
                        writing=WritingPattern.SEQUENTIAL_WRITE)


def columnar_job_data_attrs() -> AttributeSet:
    """Job-data preset with the columnar storage scheme: the set's pages hold
    column blocks, so the vectorized shuffle/aggregate paths stream whole
    columns (``core/columnar.py``)."""
    attrs = job_data_attrs()
    attrs.storage = StorageScheme.COLUMNAR
    return attrs


def columnar_user_data_attrs() -> AttributeSet:
    """Long-lived user data stored columnar (write-through durability rides
    the same page-image log path — blocks are opaque payloads to it)."""
    attrs = user_data_attrs()
    attrs.storage = StorageScheme.COLUMNAR
    return attrs


def is_columnar(ls: LocalitySet) -> bool:
    """Whether a locality set's pages hold column blocks (the per-set
    ``AttributeSet.storage`` dimension selects the scheme)."""
    return ls.attrs.storage is StorageScheme.COLUMNAR


def as_record_bytes(records: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """[N, ...] records -> [N, itemsize] uint8 rows (handles structured AND
    subarray dtypes, e.g. one token sequence per record)."""
    records = np.ascontiguousarray(records)
    n = len(records)
    raw = records.view(np.uint8).reshape(n, -1)
    if raw.shape[1] != dtype.itemsize:
        raise ValueError(f"record bytes {raw.shape[1]} != dtype itemsize "
                         f"{dtype.itemsize}")
    return raw


def from_record_bytes(buf: np.ndarray, dtype: np.dtype, n: int) -> np.ndarray:
    """Inverse of as_record_bytes: uint8 buffer -> n records of ``dtype``."""
    raw = buf[:n * dtype.itemsize]
    if dtype.subdtype is not None:
        base, shape = dtype.subdtype
        return raw.view(base).reshape((n, *shape))
    return raw.view(dtype)


# ---------------------------------------------------------------------------
# Sequential read/write service
# ---------------------------------------------------------------------------
class SequentialWriter:
    """Append fixed-dtype records to a locality set, page by page."""

    def __init__(self, pool: BufferPool, ls: LocalitySet, dtype: np.dtype):
        self.pool = pool
        self.ls = ls
        self.dtype = np.dtype(dtype)
        self.per_page = (ls.page_size - _HEADER) // self.dtype.itemsize
        if self.per_page < 1:
            raise ValueError("page too small for one record")
        self._page: Optional[Page] = None
        self._count = 0
        ls.infer_from_service("sequential-write", pool.clock)

    def _open_page(self) -> None:
        self._page = self.pool.new_page(self.ls)
        self._count = 0

    def _close_page(self) -> None:
        if self._page is None:
            return
        view = self.pool.view(self._page)
        view[:_HEADER].view(np.int64)[0] = self._count
        self.pool.unpin(self._page, dirty=True)
        self._page = None

    def append_batch(self, records: np.ndarray) -> None:
        raw = as_record_bytes(records, self.dtype)
        i = 0
        while i < len(raw):
            if self._page is None:
                self._open_page()
            room = self.per_page - self._count
            take = min(room, len(raw) - i)
            view = self.pool.view(self._page)
            start = _HEADER + self._count * self.dtype.itemsize
            stop = start + take * self.dtype.itemsize
            view[start:stop] = raw[i:i + take].reshape(-1)
            self._count += take
            i += take
            if self._count == self.per_page:
                self._close_page()

    def append(self, record) -> None:
        self.append_batch(np.array([record], dtype=self.dtype))

    def close(self) -> None:
        self._close_page()
        self.ls.set_operation(CurrentOperation.IDLE, self.pool.clock)


class PageIterator:
    """Concurrent page iterator over a subset of a locality set's pages."""

    def __init__(self, pool: BufferPool, ls: LocalitySet, dtype: np.dtype,
                 page_ids: Sequence[int]):
        self.pool = pool
        self.ls = ls
        self.dtype = np.dtype(dtype)
        self.page_ids = list(page_ids)

    def __iter__(self) -> Iterator[np.ndarray]:
        for pid in self.page_ids:
            page = self.ls.pages[pid]
            view = self.pool.pin(page)
            try:
                n = int(view[:_HEADER].view(np.int64)[0])
                yield from_record_bytes(view[_HEADER:], self.dtype, n)
            finally:
                self.pool.unpin(page)


def get_page_iterators(pool: BufferPool, ls: LocalitySet, dtype: np.dtype,
                       num_workers: int) -> List[PageIterator]:
    """Split the set's pages round-robin across ``num_workers`` iterators
    (paper §8 sequential read service)."""
    ls.infer_from_service("sequential-read", pool.clock)
    pids = sorted(ls.pages)
    return [PageIterator(pool, ls, dtype, pids[w::num_workers])
            for w in range(num_workers)]


def read_all(pool: BufferPool, ls: LocalitySet, dtype: np.dtype) -> np.ndarray:
    its = get_page_iterators(pool, ls, dtype, 1)
    chunks = [recs.copy() for recs in its[0]]
    if not chunks:
        return np.empty(0, dtype=dtype)
    return np.concatenate(chunks)


# ---------------------------------------------------------------------------
# Shuffle service — virtual shuffle buffers (paper §8)
# ---------------------------------------------------------------------------
SMALL_PAGE = 1 << 16  # 64 KiB small pages split from each large page


class _SmallPageAllocator:
    """Secondary allocator that pins one large page in a partition's locality
    set and splits it into small pages handed to concurrent writers.

    Thread-safe: concurrent writers share one allocator per partition,
    so ``alloc_small`` hands out disjoint small pages under a lock, and every
    small page carries an *extra pin* on behalf of its writer (released via
    ``release_small``) — otherwise a rotation triggered by one writer would
    unpin the large page a peer is still filling, and an eviction under
    pressure would pull the arena out from under its view."""

    def __init__(self, pool: BufferPool, ls: LocalitySet, small_page: int = SMALL_PAGE):
        self.pool = pool
        self.ls = ls
        self.small_page = min(small_page, ls.page_size)
        self._page: Optional[Page] = None
        self._next_off = 0
        self._outstanding = 0
        self._lock = tracked_lock("services.smallpage")

    def alloc_small(self) -> Tuple[Page, int]:
        """Returns ``(large_page, offset)`` with the large page pinned once
        for the caller; pair with ``release_small`` when the small page is
        full or the writer closes."""
        with self._lock:
            if self._page is None or self._next_off + self.small_page > self._page.size:
                self._rotate()
            off = self._next_off
            self._next_off += self.small_page
            self._outstanding += 1
            self.pool.pin(self._page)
            return self._page, off

    def release_small(self, page: Page) -> None:
        """Drop a writer's pin on its small page's large page."""
        self.pool.unpin(page, dirty=True)

    def _rotate(self) -> None:
        if self._page is not None:
            self.pool.unpin(self._page, dirty=True)
        self._page = self.pool.new_page(self.ls)
        self._next_off = 0
        # zero every small-page count header (arena memory may be recycled)
        view = self.pool.view(self._page)
        for base in range(0, self._page.size - self.small_page + 1, self.small_page):
            view[base:base + _HEADER].view(np.int64)[0] = 0

    def close(self) -> None:
        with self._lock:
            if self._page is not None:
                self.pool.unpin(self._page, dirty=True)
                self._page = None


class VirtualShuffleBuffer:
    """Per-(worker, partition) append handle writing into small pages
    (paper §3.2 code example + §8). Each open small page keeps its large
    page pinned (via ``alloc_small``), so concurrent writers on the same
    partition can't have their pages evicted mid-fill; ``close`` releases
    the pin on a partially filled page."""

    def __init__(self, allocator: _SmallPageAllocator, dtype: np.dtype,
                 on_write: Optional[Callable[[int, int], None]] = None):
        self.allocator = allocator
        self.on_write = on_write  # (num_records, num_bytes) per add_batch
        self.dtype = np.dtype(dtype)
        self._page: Optional[Page] = None
        self._base = 0
        self._count = 0
        self._cap = (allocator.small_page - _HEADER) // self.dtype.itemsize

    def _open(self) -> None:
        self._page, self._base = self.allocator.alloc_small()
        self._count = 0
        view = self.allocator.pool.view(self._page)
        view[self._base:self._base + _HEADER].view(np.int64)[0] = 0

    def _close_small(self) -> None:
        if self._page is not None:
            self.allocator.release_small(self._page)
            self._page = None

    def add_batch(self, records: np.ndarray) -> None:
        raw = as_record_bytes(records, self.dtype)
        if self.on_write is not None and len(raw):
            self.on_write(len(raw), len(raw) * self.dtype.itemsize)
        i = 0
        pool = self.allocator.pool
        while i < len(raw):
            if self._page is None:
                self._open()
            take = min(self._cap - self._count, len(raw) - i)
            view = pool.view(self._page)
            start = self._base + _HEADER + self._count * self.dtype.itemsize
            stop = start + take * self.dtype.itemsize
            view[start:stop] = raw[i:i + take].reshape(-1)
            self._count += take
            view[self._base:self._base + _HEADER].view(np.int64)[0] = self._count
            i += take
            if self._count == self._cap:
                self._close_small()  # small page full; next add opens another

    def close(self) -> None:
        """Release the pin on a partially filled small page (the records
        stay; only the writer's hold on the arena is dropped)."""
        self._close_small()

    def add(self, record) -> None:
        self.add_batch(np.array([record], dtype=self.dtype))


def iter_small_page_records(pool: BufferPool, ls: LocalitySet,
                            dtype: np.dtype,
                            small_page: int = SMALL_PAGE) -> Iterator[np.ndarray]:
    """Stream the records of a set whose pages are small-page shuffle output
    (each ``small_page`` window self-describes with an int64 count header).
    This is the decode side of a raw page-image move: a map partition
    exported as whole page images — same host or across the process data
    plane — reads back here without the producing service.  Yielded arrays
    are views valid only until the next iteration."""
    dtype = np.dtype(dtype)
    small = min(small_page, ls.page_size)
    for pid in sorted(ls.pages):
        page = ls.pages[pid]
        view = pool.pin(page)
        try:
            for base in range(0, page.size - small + 1, small):
                n = int(view[base:base + _HEADER].view(np.int64)[0])
                if n == 0:
                    continue
                yield from_record_bytes(view[base + _HEADER:], dtype, n)
        finally:
            pool.unpin(page)


class ShuffleService:
    """One locality set per partition; concurrent writers share large pages
    through small-page sub-allocation. Readers use the sequential service."""

    def __init__(self, pool: BufferPool, name: str, num_partitions: int,
                 dtype: np.dtype, page_size: int = 1 << 20,
                 attrs_factory: Optional[Callable[[], AttributeSet]] = None):
        self.pool = pool
        self.dtype = np.dtype(dtype)
        self.num_partitions = num_partitions
        self.partition_sets: List[LocalitySet] = []
        self._allocators: List[_SmallPageAllocator] = []
        for p in range(num_partitions):
            attrs = attrs_factory() if attrs_factory else AttributeSet()
            ls = pool.create_set(f"{name}/part{p}", page_size, attrs)
            ls.infer_from_service("shuffle", pool.clock)
            self.partition_sets.append(ls)
            self._allocators.append(_SmallPageAllocator(pool, ls))
        self._buffers: Dict[Tuple[int, int], VirtualShuffleBuffer] = {}
        self._lock = tracked_lock("services.shuffle")  # buffer map + write counters
        # per-partition write accounting: what the locality-aware scheduler
        # reads to place reducers where their input already lives
        self.partition_records: List[int] = [0] * num_partitions
        self.partition_bytes: List[int] = [0] * num_partitions

    def _count_write(self, partition_id: int, nrec: int, nbytes: int) -> None:
        with self._lock:
            self.partition_records[partition_id] += nrec
            self.partition_bytes[partition_id] += nbytes

    def get_buffer(self, worker_id, partition_id: int) -> VirtualShuffleBuffer:
        """Append handle for one (worker, partition). ``worker_id`` is any
        hashable writer identity — concurrent writer threads must use
        distinct ids so each gets its own buffer (the partition's allocator
        hands their small pages out disjointly)."""
        key = (worker_id, partition_id)
        with self._lock:
            if key not in self._buffers:
                self._buffers[key] = VirtualShuffleBuffer(
                    self._allocators[partition_id], self.dtype,
                    on_write=lambda nr, nb, p=partition_id: self._count_write(p, nr, nb))
            return self._buffers[key]

    def shuffle_batch(self, worker_id: int, records: np.ndarray,
                      key_fn: Callable[[np.ndarray], np.ndarray]) -> None:
        """Vectorized shuffle: route ``records`` to partitions by key hash."""
        keys = key_fn(records)
        parts = keys % self.num_partitions
        for p in np.unique(parts):
            self.get_buffer(worker_id, int(p)).add_batch(records[parts == p])

    def finish_writes(self) -> None:
        for buf in self._buffers.values():
            buf.close()  # drop writer pins on partially filled small pages
        for alloc in self._allocators:
            alloc.close()
        for ls in self.partition_sets:
            ls.set_operation(CurrentOperation.IDLE, self.pool.clock)

    def iter_partition(self, partition_id: int) -> Iterator[np.ndarray]:
        """Stream one partition's records small-page by small-page — the
        pressure-safe read path: a consumer (e.g. a reducer pull) stages
        O(small page), never the whole partition. Pinning each large page in
        turn faults any spilled map output back through the pool. Yielded
        arrays are views valid only until the next iteration; copy to
        retain."""
        ls = self.partition_sets[partition_id]
        ls.infer_from_service("sequential-read", self.pool.clock)
        yield from iter_small_page_records(
            self.pool, ls, self.dtype, self.small_page_of(partition_id))

    def small_page_of(self, partition_id: int) -> int:
        """The small-page stride of one partition's pages — what a raw
        page-image consumer needs to decode them (``iter_small_page_records``
        on the far side of an export)."""
        return self._allocators[partition_id].small_page

    def read_partition(self, partition_id: int) -> np.ndarray:
        """Read back one whole partition (gathers ``iter_partition``)."""
        out = [chunk.copy() for chunk in self.iter_partition(partition_id)]
        if not out:
            return np.empty(0, dtype=self.dtype)
        return np.concatenate(out)

    def release_partition(self, partition_id: int) -> None:
        """Consumer is done with this partition: end the lifetime of its
        job-data pages (making them the cheapest eviction victims, paper §6)
        and drop the set, returning arena space to the pool."""
        ls = self.partition_sets[partition_id]
        ls.end_lifetime(self.pool.clock)
        self.pool.drop_set(ls)


class ColumnarShuffleService:
    """Columnar twin of ``ShuffleService``: one columnar locality set per
    partition, written block-at-a-time by per-(worker, partition)
    ``ColumnarWriter`` handles. The fused map pass hands each writer an
    already-routed *column slice* — ``add_columns`` memcpys it straight into
    the partition's column block, no per-record work and no row
    materialization anywhere on the map side. ``iter_partition`` streams the
    blocks back out as zero-copy ``(columns, n)`` views (the reducer pull /
    join probe feed). The same accounting surface as the row service
    (``partition_records`` / ``partition_bytes``) keeps the locality-aware
    scheduler working unchanged."""

    def __init__(self, pool: BufferPool, name: str, num_partitions: int,
                 dtype: np.dtype, page_size: int = 1 << 20,
                 attrs_factory: Optional[Callable[[], AttributeSet]] = None):
        self.pool = pool
        self.dtype = np.dtype(dtype)
        self.num_partitions = num_partitions
        self.partition_sets: List[LocalitySet] = []
        # one shared landing writer per partition, provisioned up front with
        # its first page (the paper's pre-provisioned per-partition shuffle
        # buffers) — map passes memcpy routed slices without any cold-start
        # page allocation in the landing loop. Appends serialize under
        # ``_lock``, consistent with the per-node CRC-chain contract.
        self._writers: List[ColumnarWriter] = []
        self._lock = tracked_lock("services.columnar")
        for p in range(num_partitions):
            attrs = attrs_factory() if attrs_factory else columnar_job_data_attrs()
            ls = pool.create_set(f"{name}/part{p}", page_size, attrs)
            ls.infer_from_service("shuffle", pool.clock)
            self.partition_sets.append(ls)
            w = ColumnarWriter(pool, ls, self.dtype)
            w._open_page()
            self._writers.append(w)
        self.partition_records: List[int] = [0] * num_partitions
        self.partition_bytes: List[int] = [0] * num_partitions
        # per-partition, per-field incremental CRC32 of the routed column
        # bytes, chained slice by slice in append order by the fused map pass.
        # One chain per field keeps the fingerprint invariant to block
        # boundaries, so consumers re-verify it block by block after the pull.
        nfields = len(_field_layout(self.dtype))
        self.partition_crcs: List[List[int]] = [
            [0] * nfields for _ in range(num_partitions)]
        self._released: set = set()

    def get_writer(self, worker_id, partition_id: int) -> ColumnarWriter:
        """The pre-provisioned landing writer for one partition (``worker_id``
        is accepted for call-site compatibility; writers are shared, so
        callers must serialize appends — ``add_columns``/``add_routed`` do)."""
        return self._writers[partition_id]

    def add_columns(self, worker_id, partition_id: int,
                    columns: Dict[str, np.ndarray], n: int,
                    start: int = 0) -> None:
        """Append ``columns[start:start+n]`` to one partition (the routed
        slice a fused dispatch pass produced)."""
        if n == 0:
            return
        with self._lock:
            self._writers[partition_id].append_columns(columns, n, start=start)
            self.partition_records[partition_id] += n
            self.partition_bytes[partition_id] += n * self.dtype.itemsize

    def add_routed(self, worker_id, columns: Dict[str, np.ndarray],
                   offsets: np.ndarray) -> None:
        """Bulk landing: append every partition's routed slice in one call.
        ``columns`` is partition-major (the fused dispatch output) and
        ``offsets`` the ``num_partitions + 1`` slice boundaries. One lock
        round-trip and one set of flat column views for the whole page,
        instead of one of each per partition."""
        itemsize = self.dtype.itemsize
        flats = {name: _col_view(columns[name])
                 for name, _, _, _ in _field_layout(self.dtype)}
        bounds = offsets.tolist() if hasattr(offsets, "tolist") else offsets
        with self._lock:
            for p in range(self.num_partitions):
                lo = bounds[p]
                n = bounds[p + 1] - lo
                if n == 0:
                    continue
                self._writers[p].append_flat(flats, n, start=lo)
                self.partition_records[p] += n
                self.partition_bytes[p] += n * itemsize

    def add_gathered(self, worker_id, columns: Dict[str, np.ndarray],
                     order: np.ndarray, offsets: np.ndarray) -> None:
        """Fused landing (the map hot path): gather each partition's rows
        from the source block straight into its pre-provisioned pages —
        ``np.take(..., out=page_region)``, no routed intermediate — while
        chaining the per-field partition CRCs over the landed bytes.
        ``order``/``offsets`` are a ``host_dispatch_plan`` result over this
        block's reducer ids."""
        itemsize = self.dtype.itemsize
        bounds = (offsets.tolist() if hasattr(offsets, "tolist")
                  else list(offsets))
        with self._lock:
            for p in range(self.num_partitions):
                lo, hi = bounds[p], bounds[p + 1]
                if hi == lo:
                    continue
                self._writers[p].gather_append(columns, order, lo, hi,
                                               self.partition_crcs[p])
                self.partition_records[p] += hi - lo
                self.partition_bytes[p] += (hi - lo) * itemsize

    def finish_writes(self) -> None:
        # each writer's close already marks its (1:1) partition set IDLE
        for w in self._writers:
            w.close()

    def iter_partition(self, partition_id: int
                       ) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
        """Stream one partition's column blocks — zero-copy views valid only
        until the next iteration; pinning each page faults spilled blocks
        back through the pool (same pressure-safe contract as the row
        service's small-page iterator)."""
        yield from iter_column_blocks(
            self.pool, self.partition_sets[partition_id], self.dtype)

    def read_partition(self, partition_id: int) -> np.ndarray:
        out = [columns_to_records(cols, self.dtype, n)
               for cols, n in self.iter_partition(partition_id)]
        if not out:
            return np.empty(0, dtype=self.dtype)
        return np.concatenate(out)

    def release_partition(self, partition_id: int) -> None:
        """End one partition's lifetime and drop its pages. Idempotent:
        deferred-release pulls (``ClusterShuffle.pull_columns``) and failure
        cleanup (``discard_map_output``) may both reach the same partition."""
        with self._lock:
            if partition_id in self._released:
                return
            self._released.add(partition_id)
        ls = self.partition_sets[partition_id]
        ls.end_lifetime(self.pool.clock)
        self.pool.drop_set(ls)


# ---------------------------------------------------------------------------
# Hash service — virtual hash buffer (paper §8)
# ---------------------------------------------------------------------------
def _hash_slot(keys: np.ndarray, cap: int) -> np.ndarray:
    """Fibonacci hash → initial probe slot."""
    h = (keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
    return (h % np.uint64(cap)).astype(np.int64)


class _HashPage:
    """Open-addressing (linear probing) int64->float64 aggregate table living
    inside one buffer-pool page. Layout: [count:int64][used:u1 xC][pad]
    [keys:int64 xC][vals:float64 xC]."""

    def __init__(self, pool: BufferPool, ls: LocalitySet, page: Page):
        self.pool = pool
        self.ls = ls
        self.page = page
        cap = (page.size - _HEADER - 7) // (1 + 8 + 8)
        cap -= cap % 8 or 0
        self.cap = max(8, cap - 8)
        self._layout()

    def _layout(self) -> None:
        view = self.pool.view(self.page)
        off = _HEADER
        self.used = view[off:off + self.cap].view(np.uint8)
        off += self.cap
        off += (-off) % 8
        self.keys = view[off:off + 8 * self.cap].view(np.int64)
        off += 8 * self.cap
        self.vals = view[off:off + 8 * self.cap].view(np.float64)

    @property
    def count(self) -> int:
        return int(self.pool.view(self.page)[:_HEADER].view(np.int64)[0])

    def _set_count(self, n: int) -> None:
        self.pool.view(self.page)[:_HEADER].view(np.int64)[0] = n

    def insert_add(self, keys: np.ndarray,
                   vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized aggregate-insert. Returns (rem_keys, rem_vals): pairs
        not inserted because the table hit its load limit — the caller seals
        this page and retries on a fresh one. Rejections are safe even when a
        rejected key exists deeper in the probe chain, because ``finalize()``
        re-aggregates partials across the whole partition chain."""
        if len(keys) == 0:
            return keys, vals
        # pre-aggregate duplicate keys within the batch
        ukeys, inv = np.unique(keys, return_inverse=True)
        uvals = np.zeros(len(ukeys), dtype=np.float64)
        np.add.at(uvals, inv, vals)
        keys, vals = ukeys, uvals

        limit = int(self.cap * 0.7)
        n = self.count
        base = _hash_slot(keys, self.cap)
        pending = np.arange(len(keys))
        for probe in range(self.cap):
            if len(pending) == 0:
                break
            s = (base[pending] + probe) % self.cap
            occupied = self.used[s].astype(bool)
            match = occupied & (self.keys[s] == keys[pending])
            if match.any():
                self.vals[s[match]] += vals[pending[match]]  # unique keys → unique slots
            empty = ~occupied
            survivors = pending[occupied & ~match]  # collided; probe further
            if empty.any():
                cand = pending[empty]
                cslot = s[empty]
                order = np.argsort(cslot, kind="stable")
                cand, cslot = cand[order], cslot[order]
                first = np.ones(len(cslot), dtype=bool)
                first[1:] = cslot[1:] != cslot[:-1]
                winners, wslots = cand[first], cslot[first]
                losers = cand[~first]
                room = max(0, limit - n)
                if room < len(winners):
                    rejected = winners[room:]
                    winners, wslots = winners[:room], wslots[:room]
                    if len(winners):
                        self.used[wslots] = 1
                        self.keys[wslots] = keys[winners]
                        self.vals[wslots] = vals[winners]
                        n += len(winners)
                    self._set_count(n)
                    rem = np.concatenate([rejected, losers, survivors])
                    return keys[rem], vals[rem]
                self.used[wslots] = 1
                self.keys[wslots] = keys[winners]
                self.vals[wslots] = vals[winners]
                n += len(winners)
                survivors = np.concatenate([survivors, losers])
            pending = survivors
        self._set_count(n)
        return keys[pending], vals[pending]

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        mask = self.used.astype(bool)
        return self.keys[mask].copy(), self.vals[mask].copy()


class HashService:
    """Hash aggregation over buffer-pool pages (paper §8).

    K root partitions, each a *chain* of hash pages. The chain head is pinned
    and receives inserts; when it fills, it is sealed (unpinned → becomes an
    evictable/spillable partial-aggregate page, exactly the paper's "select a
    page, unpin it, and spill it to disk as partial-aggregation results") and
    a fresh head is allocated. ``finalize()`` re-aggregates each partition's
    chain — pinning sealed pages pulls any spilled partials back through the
    buffer pool transparently (the monolithic-design payoff: no separate
    spill-file machinery).
    """

    PAIR_DTYPE = np.dtype([("key", np.int64), ("val", np.float64)])

    def __init__(self, pool: BufferPool, name: str, num_root_partitions: int = 8,
                 page_size: int = 1 << 20):
        self.pool = pool
        self.name = name
        self.ls = pool.create_set(name, page_size)
        self.ls.infer_from_service("hash", pool.clock)
        self.depth = max(1, int(np.ceil(np.log2(max(2, num_root_partitions)))))
        self._heads: Dict[int, _HashPage] = {}
        self._sealed: Dict[int, List[int]] = {p: [] for p in range(1 << self.depth)}
        for p in range(1 << self.depth):
            self._heads[p] = self._new_hash_page()

    def _new_hash_page(self) -> _HashPage:
        page = self.pool.new_page(self.ls)  # returned pinned
        view = self.pool.view(page)
        view[:] = 0
        return _HashPage(self.pool, self.ls, page)

    def _partition_of(self, keys: np.ndarray) -> np.ndarray:
        h = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        return (h >> np.uint64(64 - self.depth)).astype(np.int64)

    def _seal_and_replace(self, part: int) -> None:
        hp = self._heads[part]
        self._sealed[part].append(hp.page.page_id)
        self.pool.unpin(hp.page, dirty=True)  # now evictable (paper §8)
        self._heads[part] = self._new_hash_page()

    def insert(self, keys: np.ndarray, vals: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        parts = self._partition_of(keys)
        for p in np.unique(parts):
            m = parts == p
            k, v = keys[m], vals[m]
            while len(k):
                k, v = self._heads[int(p)].insert_add(k, v)
                if len(k):
                    self._seal_and_replace(int(p))

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """Re-aggregate each partition chain (head + sealed partials)."""
        all_keys: List[np.ndarray] = []
        all_vals: List[np.ndarray] = []
        for p, hp in self._heads.items():
            k, v = hp.items()
            all_keys.append(k)
            all_vals.append(v)
            for pid in self._sealed[p]:
                page = self.ls.pages[pid]
                self.pool.pin(page)  # transparently restores spilled partials
                try:
                    sk, sv = _HashPage(self.pool, self.ls, page).items()
                    all_keys.append(sk)
                    all_vals.append(sv)
                finally:
                    self.pool.unpin(page)
        keys = np.concatenate(all_keys) if all_keys else np.empty(0, np.int64)
        vals = np.concatenate(all_vals) if all_vals else np.empty(0, np.float64)
        if len(keys) == 0:
            return keys, vals
        uk, inv = np.unique(keys, return_inverse=True)
        out = np.zeros(len(uk), dtype=np.float64)
        np.add.at(out, inv, vals)
        return uk, out

    def close(self) -> None:
        for hp in self._heads.values():
            self.pool.unpin(hp.page, dirty=True)
        self.ls.set_operation(CurrentOperation.IDLE, self.pool.clock)


# ---------------------------------------------------------------------------
# Join service (paper §8): partitioned hash join through the buffer pool
# ---------------------------------------------------------------------------
def join_output_dtype(build_dtype: np.dtype, probe_dtype: np.dtype,
                      build_key: str, probe_key: str) -> np.dtype:
    """Output record layout for a materialized equi-join: the join key first,
    then the build side's non-key fields (prefixed ``b_``), then the probe
    side's (prefixed ``p_``). Scalar fields only — the canonical output order
    is a lexicographic sort over every field."""
    build_dtype = np.dtype(build_dtype)
    probe_dtype = np.dtype(probe_dtype)
    fields = [("key", build_dtype.fields[build_key][0])]
    fields += [(f"b_{n}", build_dtype.fields[n][0])
               for n in build_dtype.names if n != build_key]
    fields += [(f"p_{n}", probe_dtype.fields[n][0])
               for n in probe_dtype.names if n != probe_key]
    return np.dtype(fields)


def canonical_join_sort(out: np.ndarray) -> np.ndarray:
    """Sort joined records into their canonical total order (every field,
    first field most significant). A hash join emits matches in probe order,
    which differs between a single-pool run and a distributed one — after this
    sort the two are byte-identical, which is how equivalence is asserted."""
    if len(out) <= 1:
        return out
    order = np.lexsort(tuple(out[f] for f in reversed(out.dtype.names)))
    return out[order]


class JoinService:
    """Partitioned hash join over buffer-pool pages (paper §8).

    Build-side records are appended page by page into a locality set, so an
    over-capacity build *spills through the pool's eviction policy* instead of
    growing an unbounded heap table; only the join keys stay resident, as a
    sorted row index. Probing is vectorized (binary search over the sorted
    keys) and matched build rows are fetched back one page at a time —
    faulting any spilled build pages in transparently, the same
    monolithic-pool story as the hash service's partial-aggregate pages.
    """

    def __init__(self, pool: BufferPool, name: str,
                 build_dtype: np.dtype, probe_dtype: np.dtype,
                 build_key: str, probe_key: str,
                 page_size: int = 1 << 16,
                 attrs_factory: Optional[Callable[[], AttributeSet]] = job_data_attrs):
        self.pool = pool
        self.build_dtype = np.dtype(build_dtype)
        self.probe_dtype = np.dtype(probe_dtype)
        self.build_key = build_key
        self.probe_key = probe_key
        self.out_dtype = join_output_dtype(self.build_dtype, self.probe_dtype,
                                           build_key, probe_key)
        attrs = attrs_factory() if attrs_factory else None
        self.ls = pool.create_set(name, page_size, attrs)
        self._writer = SequentialWriter(pool, self.ls, self.build_dtype)
        self.per_page = self._writer.per_page
        self._key_chunks: List[np.ndarray] = []
        self.build_rows = 0
        self._skeys: Optional[np.ndarray] = None   # build keys, sorted
        self._srows: Optional[np.ndarray] = None   # row id of each sorted key
        self._pids: List[int] = []

    # -- build side ------------------------------------------------------------
    def build_batch(self, records: np.ndarray) -> None:
        if len(records) == 0:
            return
        self._key_chunks.append(
            np.asarray(records[self.build_key], np.int64).copy())
        self._writer.append_batch(records)
        self.build_rows += len(records)

    def finish_build(self) -> None:
        """Seal the build side: close the writer (its pages become evictable)
        and sort the resident key index for binary-search probing."""
        self._writer.close()
        self._pids = sorted(self.ls.pages)
        keys = (np.concatenate(self._key_chunks) if self._key_chunks
                else np.empty(0, np.int64))
        self._key_chunks = []
        order = np.argsort(keys, kind="stable")
        self._skeys = keys[order]
        self._srows = order

    def _fetch_build_rows(self, row_ids: np.ndarray) -> np.ndarray:
        """Gather build records by row id, pinning each touched page once
        (row ids are page-grouped first, so a spilled page faults in at most
        once per probe batch)."""
        out = np.empty(len(row_ids), self.build_dtype)
        if len(row_ids) == 0:
            return out
        order = np.argsort(row_ids, kind="stable")
        rs = row_ids[order]
        pg = rs // self.per_page
        bounds = np.flatnonzero(np.diff(pg)) + 1
        for a, b in zip(np.concatenate([[0], bounds]),
                        np.concatenate([bounds, [len(rs)]])):
            page = self.ls.pages[self._pids[int(pg[a])]]
            view = self.pool.pin(page)
            try:
                n = int(view[:_HEADER].view(np.int64)[0])
                recs = from_record_bytes(view[_HEADER:], self.build_dtype, n)
                out[order[a:b]] = recs[rs[a:b] % self.per_page]
            finally:
                self.pool.unpin(page)
        return out

    # -- probe side ------------------------------------------------------------
    def _match_positions(self, probe_keys: np.ndarray):
        """(probe_row_idx, build_row_id) for every match of a probe batch."""
        pk = np.asarray(probe_keys, np.int64)
        left = np.searchsorted(self._skeys, pk, "left")
        counts = np.searchsorted(self._skeys, pk, "right") - left
        m = counts > 0
        cm, lm = counts[m], left[m]
        offs = np.concatenate([[0], np.cumsum(cm)])
        total = int(offs[-1])
        pos = np.repeat(lm, cm) + (np.arange(total) - np.repeat(offs[:-1], cm))
        return np.repeat(np.flatnonzero(m), cm), self._srows[pos]

    def probe_count(self, records: np.ndarray) -> int:
        """Match count for a probe batch without materializing the output."""
        if len(records) == 0 or self.build_rows == 0:
            return 0
        pk = np.asarray(records[self.probe_key], np.int64)
        return int((np.searchsorted(self._skeys, pk, "right")
                    - np.searchsorted(self._skeys, pk, "left")).sum())

    def probe_batch(self, records: np.ndarray) -> np.ndarray:
        """Probe the build table with one batch; returns the matched joined
        records (un-ordered — callers canonical-sort the final concat)."""
        if len(records) == 0 or self.build_rows == 0:
            return np.empty(0, self.out_dtype)
        probe_idx, build_rows = self._match_positions(records[self.probe_key])
        if len(probe_idx) == 0:
            return np.empty(0, self.out_dtype)
        brecs = self._fetch_build_rows(build_rows)
        precs = records[probe_idx]
        out = np.empty(len(probe_idx), self.out_dtype)
        out["key"] = precs[self.probe_key]
        for f in self.build_dtype.names:
            if f != self.build_key:
                out[f"b_{f}"] = brecs[f]
        for f in self.probe_dtype.names:
            if f != self.probe_key:
                out[f"p_{f}"] = precs[f]
        return out

    # -- columnar batches -----------------------------------------------
    def build_columns(self, columns: Dict[str, np.ndarray], n: int) -> None:
        """Build from a column block: the key column feeds the resident index
        directly (no row decode); rows are materialized once for the spillable
        build pages, which stay row-oriented so ``_fetch_build_rows``'s
        page-grouped gather is unchanged."""
        if n == 0:
            return
        self._key_chunks.append(
            np.asarray(columns[self.build_key][:n], np.int64).copy())
        self._writer.append_batch(columns_to_records(columns,
                                                     self.build_dtype, n))
        self.build_rows += n

    def probe_columns(self, columns: Dict[str, np.ndarray],
                      n: int) -> np.ndarray:
        """Probe with a column block: the searchsorted match runs on the key
        column as-is and output fields gather per column — no probe-side row
        materialization at all (the columnar join hot path)."""
        if n == 0 or self.build_rows == 0:
            return np.empty(0, self.out_dtype)
        pk = np.asarray(columns[self.probe_key][:n], np.int64)
        probe_idx, build_rows = self._match_positions(pk)
        if len(probe_idx) == 0:
            return np.empty(0, self.out_dtype)
        brecs = self._fetch_build_rows(build_rows)
        out = np.empty(len(probe_idx), self.out_dtype)
        out["key"] = pk[probe_idx]
        for f in self.build_dtype.names:
            if f != self.build_key:
                out[f"b_{f}"] = brecs[f]
        for f in self.probe_dtype.names:
            if f != self.probe_key:
                out[f"p_{f}"] = columns[f][:n][probe_idx]
        return out

    def close(self) -> None:
        """End the build table's job-data lifetime and return its pages."""
        self.ls.end_lifetime(self.pool.clock)
        self.pool.drop_set(self.ls)


def join_records(pool: BufferPool, build_ls: LocalitySet,
                 probe_ls: LocalitySet, build_dtype: np.dtype,
                 probe_dtype: np.dtype, build_key: str, probe_key: str,
                 out_name: str = "join_out",
                 page_size: int = 1 << 16) -> np.ndarray:
    """Single-pool materialized equi-join — the reference the distributed
    ``runtime/join.ClusterJoin`` must match byte-for-byte (after the shared
    canonical sort). Streams both sides through the sequential read service;
    the build table lives in pool pages via ``JoinService``."""
    js = JoinService(pool, f"{out_name}.build", build_dtype, probe_dtype,
                     build_key, probe_key, page_size=page_size)
    for recs in PageIterator(pool, build_ls, build_dtype,
                             sorted(build_ls.pages)):
        js.build_batch(recs)
    js.finish_build()
    outs = [js.probe_batch(recs)
            for recs in PageIterator(pool, probe_ls, probe_dtype,
                                     sorted(probe_ls.pages))]
    js.close()
    out = (np.concatenate(outs) if outs
           else np.empty(0, js.out_dtype))
    return canonical_join_sort(out)


def join_service(pool: BufferPool, build_ls: LocalitySet, probe_ls: LocalitySet,
                 build_dtype: np.dtype, probe_dtype: np.dtype,
                 build_key: str, probe_key: str,
                 out_name: str = "join_out") -> np.ndarray:
    """Hash join match count: build a table from ``build_ls``, probe with
    ``probe_ls``. Kept as the count-only entry point (``join_records``
    materializes the joined rows) — both run on ``JoinService``."""
    js = JoinService(pool, f"{out_name}.tbl", build_dtype, probe_dtype,
                     build_key, probe_key)
    for recs in PageIterator(pool, build_ls, build_dtype,
                             sorted(build_ls.pages)):
        js.build_batch(recs)
    js.finish_build()
    matches = sum(js.probe_count(recs)
                  for recs in PageIterator(pool, probe_ls, probe_dtype,
                                           sorted(probe_ls.pages)))
    js.close()
    return np.array([matches], dtype=np.int64)
