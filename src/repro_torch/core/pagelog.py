"""Durable per-node page tier — append-only page log + consistent-hash index.

The ``SpillStore`` is scratch: it exists to absorb eviction bursts and dies
with its node. This module adds the tier *below* it, the one Pangea's
"monolithic storage for all data" thesis actually needs for long-lived sets:

* an **append-only page log** (``pages.log`` in the node's durable
  directory) — every write-through page image is appended as a checksummed
  record ``[magic | crc32 | epoch | seq | name_len | payload_len | flags |
  set name | payload]``. Appends never seek; a page rewritten later simply
  appends a superseding record for the same ``(set, seq)`` key;
* a **consistent-hash page index** — live entries are bucketed by hashing
  the owning set's name onto a virtual-node ring, so the index can grow its
  bucket count (or, later, split across index files) while relocating only
  the sets whose ring interval moved. Lookup is ``(set name, page seq) ->
  (file offset, length, epoch, payload crc)``;
* **epoch stamping** — every record carries the cluster's topology/job event
  counter (``StatisticsDB.event_seq`` via ``epoch_fn``) at append time.
  Replay after a restart compares a set's newest log epoch against the
  catalog's shard epoch and *fences* stale state: entries logged before a
  shard was dropped or rebuilt elsewhere must not resurrect;
* **torn-tail truncation** — replay walks the log verifying each record's
  CRC32; the first short or corrupt record marks a tail torn by a crash
  mid-append, and the file is truncated back to the last good record.

A restarted ``StorageNode`` warm-starts by replaying its local index
(``PageLog.__init__`` does the replay; ``BufferPool.adopt_durable_set``
turns live entries back into non-resident pages that fault in on demand),
and ``scheduler.recovery_plan`` costs "read the local page log" against
"pull replica bytes over the wire".

Copy of the JAX package's ``core/pagelog.py``: the record format, the index,
replay, ``scan_log`` and ``fsck`` are the same, so either package replays the
other's log and the same appends write the same bytes. One change: no fsync
runs while a lock is held. A tail sync snapshots the tail under the index
lock, takes the one sync turn (a flag on ``_sync_cv``) and fsyncs a duplicate
of the append descriptor holding nothing; compaction writes and fsyncs the
new generation from a snapshot holding nothing, then swaps it in under the
lock after copying the records appended meanwhile (see ``compact``).
"""
from __future__ import annotations

import bisect
import hashlib
import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from . import sanitizer
from .sanitizer import tracked_condition, tracked_rlock

MAGIC = 0x50474C31  # "PGL1"
# magic u32 | crc u32 | epoch i64 | seq i64 | name_len u16 | payload_len u32
# | flags u8 — crc covers everything after itself (tail + name + payload)
_HEADER = struct.Struct("<IIqqHIB")
_TAIL = struct.Struct("<qqHIB")

FLAG_DATA = 0
FLAG_TOMBSTONE = 1   # drops every prior entry of the named set
FLAG_RENAME = 2      # payload = old set name; entries move to the new name
FLAG_GENERATION = 3  # payload = u64 generation number; first record of a
#                      compacted log file (never indexed)

LOG_FILENAME = "pages.log"
COMPACT_TMP_FILENAME = "pages.log.compact"

# Durability-vs-throughput knob. ``none`` preserves
# the original behavior: records are flushed to the OS but never fsync'd
# (a machine crash may lose the tail; replay's torn-tail truncation makes
# that safe, and replicas remain the durability truth). ``close`` syncs
# once when the log is closed, ``group`` batches one sync per
# ``group_bytes`` of appended records, ``always`` syncs every append.
FSYNC_POLICIES = ("none", "close", "group", "always")


def _hash64(key: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "little")


@dataclass
class PageLogEntry:
    """One live page image in the log: where it sits and how to verify it."""

    name: str
    seq: int
    epoch: int
    offset: int          # file offset of the payload bytes
    length: int
    payload_crc: int


class ConsistentHashIndex:
    """The page index: live entries bucketed by consistent-hashing the set
    name onto a virtual-node ring. All of one set's pages share a bucket, so
    set-granular operations (drop, rename, epoch query) touch one bucket,
    and growing the bucket count relocates only the sets whose ring interval
    moved — the property a future multi-file index needs."""

    def __init__(self, num_buckets: int = 16, vnodes: int = 8):
        self.num_buckets = num_buckets
        ring: List[Tuple[int, int]] = []
        for b in range(num_buckets):
            for v in range(vnodes):
                ring.append((_hash64(f"bucket{b}#vnode{v}"), b))
        ring.sort()
        self._points = [p for p, _ in ring]
        self._owners = [b for _, b in ring]
        self._buckets: List[Dict[Tuple[str, int], PageLogEntry]] = [
            {} for _ in range(num_buckets)]

    def bucket_of(self, name: str) -> int:
        i = bisect.bisect_right(self._points, _hash64(name))
        return self._owners[i % len(self._owners)]

    def put(self, entry: PageLogEntry) -> None:
        bucket = self._buckets[self.bucket_of(entry.name)]
        bucket[(entry.name, entry.seq)] = entry

    def get(self, name: str, seq: int) -> Optional[PageLogEntry]:
        return self._buckets[self.bucket_of(name)].get((name, seq))

    def entries_for(self, name: str) -> List[PageLogEntry]:
        bucket = self._buckets[self.bucket_of(name)]
        return sorted((e for (n, _), e in bucket.items() if n == name),
                      key=lambda e: e.seq)

    def drop_set(self, name: str) -> int:
        bucket = self._buckets[self.bucket_of(name)]
        victims = [k for k in bucket if k[0] == name]
        for k in victims:
            del bucket[k]
        return len(victims)

    def rename_set(self, old: str, new: str) -> int:
        entries = self.entries_for(old)
        self.drop_set(old)
        for e in entries:
            e.name = new
            self.put(e)
        return len(entries)

    def set_names(self) -> List[str]:
        names = {n for bucket in self._buckets for (n, _) in bucket}
        return sorted(names)

    def __len__(self) -> int:
        return sum(len(b) for b in self._buckets)


class PageLog:
    """One node's durable page tier. Thread-safe (engine workers append
    concurrently with pool faults). Construction replays the on-disk log
    into the index, truncating any torn tail, so a freshly opened PageLog
    *is* the warm-start state.

    Locks: ``_lock`` guards the index, the file handles and the counters.
    ``_sync_cv`` guards two flags: ``_syncing`` is the sync turn (one tail
    sync, or one compaction's swap and directory sync, at a time) and
    ``_compacting`` serialises compactions. The two are never held together,
    and no fsync runs while either is held."""

    def __init__(self, directory: str,
                 epoch_fn: Optional[Callable[[], int]] = None,
                 index_buckets: int = 16,
                 fsync_policy: str = "none",
                 group_bytes: int = 1 << 20,
                 compact_threshold: Optional[float] = None,
                 compact_min_bytes: int = 256 << 10,
                 compact_interval_s: Optional[float] = None):
        if fsync_policy not in FSYNC_POLICIES:
            raise ValueError(f"fsync_policy must be one of {FSYNC_POLICIES}, "
                             f"got {fsync_policy!r}")
        if compact_threshold is not None and compact_threshold <= 1.0:
            raise ValueError("compact_threshold is a file/live amplification "
                             "ratio and must be > 1.0")
        self.directory = directory
        self.epoch_fn = epoch_fn
        self.fsync_policy = fsync_policy
        self.group_bytes = group_bytes
        self.compact_threshold = compact_threshold
        self.compact_min_bytes = compact_min_bytes
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, LOG_FILENAME)
        self.index = ConsistentHashIndex(index_buckets)
        self._lock = tracked_rlock("pagelog")
        self._sync_cv = tracked_condition("pagelog.sync")
        self._syncing = False
        self._compacting = False
        self._append_fh = None
        self._read_fh = None
        self._next_seq: Dict[str, int] = {}
        self.bytes_appended = 0
        self.fsync_count = 0     # observable: tests assert group batching
        self._unsynced = 0       # bytes appended since the last fsync
        self.report: Dict[str, int] = {}
        # Compaction state: superseded/tombstoned records otherwise
        # accumulate forever.  ``generation`` counts rewrites; live/file byte
        # counters feed the amplification trigger.
        self.generation = 0
        self.compactions = 0
        self.compaction_bytes = 0   # bytes rewritten by compaction passes
        self.last_compaction: Dict[str, int] = {}
        self._live_bytes = 0
        self._file_bytes = 0
        self._compactor: Optional[threading.Thread] = None
        self._compactor_stop = threading.Event()
        self._replay()
        if compact_interval_s is not None:
            self.start_compactor(compact_interval_s)

    # -- replay / torn-tail truncation ----------------------------------------
    def _replay(self) -> None:
        report = {"records": 0, "data": 0, "tombstones": 0, "renames": 0,
                  "truncated_bytes": 0, "crc_failures": 0}
        if os.path.exists(self.path):
            good_end, records = scan_log(self.path, self.index, report)
            file_len = os.path.getsize(self.path)
            if good_end < file_len:
                # torn tail: a crash mid-append left a short or corrupt
                # record; everything before it is intact, so cut there
                report["truncated_bytes"] = file_len - good_end
                with open(self.path, "r+b") as f:
                    f.truncate(good_end)
            for name in self.index.set_names():
                entries = self.index.entries_for(name)
                self._next_seq[name] = entries[-1].seq + 1 if entries else 0
            self.generation = report.get("generation", 0)
            self._file_bytes = os.path.getsize(self.path)
            self._live_bytes = self._index_live_bytes()
        report["live_entries"] = len(self.index)
        report["live_sets"] = len(self.index.set_names())
        self.report = report

    def _index_live_bytes(self) -> int:
        return sum(_record_size(e.name, e.length)
                   for name in self.index.set_names()
                   for e in self.index.entries_for(name))

    # -- write path ------------------------------------------------------------
    def _epoch(self) -> int:
        return self.epoch_fn() if self.epoch_fn is not None else 0

    def _append_record(self, name: str, payload: bytes, seq: int,
                       flags: int, epoch: Optional[int] = None) -> int:
        """Append one record; returns the payload's file offset."""
        nb = name.encode("utf-8")
        if epoch is None:
            epoch = self._epoch()
        record = _pack_record(nb, payload, seq, flags, epoch)
        if self._append_fh is None:
            self._append_fh = open(self.path, "ab")
        fh = self._append_fh
        start = fh.tell()
        fh.write(record)
        fh.flush()
        nbytes = len(record)
        self.bytes_appended += nbytes
        self._file_bytes += nbytes
        self._unsynced += nbytes
        return start + _HEADER.size + len(nb), epoch

    def _sync_due(self, force: bool) -> bool:
        return bool(self._append_fh is not None and self._unsynced and (
            force
            or self.fsync_policy == "always"
            or (self.fsync_policy == "group"
                and self._unsynced >= self.group_bytes)))

    def _take_sync_turn(self) -> None:
        with self._sync_cv:
            while self._syncing:
                self._sync_cv.wait()
            self._syncing = True

    def _give_sync_turn(self) -> None:
        with self._sync_cv:
            self._syncing = False
            self._sync_cv.notify_all()

    def _sync_tail(self, force: bool = False) -> None:
        """Fsync the unsynced tail if the policy says it is due.  Called by
        the public mutators after releasing the index lock, and fsyncs
        holding no lock at all: the tail is measured under the lock, the
        sync turn keeps a second syncer from counting the same batch, and
        the fsync goes to a duplicate of the append descriptor."""
        with self._lock:
            if not self._sync_due(force):
                return
        self._take_sync_turn()
        try:
            with self._lock:
                if not self._sync_due(force):
                    return  # the turn's previous holder synced this tail
                pending = self._unsynced
                fd = os.dup(self._append_fh.fileno())
            try:
                with sanitizer.blocking_region("pagelog.fsync"):
                    os.fsync(fd)
            finally:
                os.close(fd)
            with self._lock:
                self.fsync_count += 1
                self._unsynced = max(0, self._unsynced - pending)
        finally:
            self._give_sync_turn()

    def next_seq(self, name: str) -> int:
        with self._lock:
            return self._next_seq.get(name, 0)

    def append(self, name: str, payload: bytes,
               seq: Optional[int] = None) -> PageLogEntry:
        """Append one page image for ``(name, seq)``. Re-appending an
        existing seq supersedes the prior image (the index keeps only the
        newest); seq=None allocates the set's next sequence number."""
        with self._lock:
            if seq is None:
                seq = self._next_seq.get(name, 0)
            prior = self.index.get(name, seq)
            offset, epoch = self._append_record(name, payload, seq, FLAG_DATA)
            self._next_seq[name] = max(self._next_seq.get(name, 0), seq + 1)
            entry = PageLogEntry(name=name, seq=seq, epoch=epoch,
                                 offset=offset, length=len(payload),
                                 payload_crc=zlib.crc32(payload) & 0xFFFFFFFF)
            self.index.put(entry)
            if prior is not None:
                self._live_bytes -= _record_size(name, prior.length)
            self._live_bytes += _record_size(name, len(payload))
        self.maybe_compact()
        self._sync_tail()
        return entry

    def drop_set(self, name: str) -> None:
        """Tombstone a set: replay will not resurrect its entries."""
        with self._lock:
            entries = self.index.entries_for(name)
            if not entries:
                return  # never logged (or already tombstoned): nothing to cut
            self._append_record(name, b"", 0, FLAG_TOMBSTONE)
            self.index.drop_set(name)
            self._next_seq.pop(name, None)
            self._live_bytes -= sum(_record_size(name, e.length)
                                    for e in entries)
        self.maybe_compact()
        self._sync_tail()

    def rename_set(self, old: str, new: str) -> None:
        """Re-key a set's entries in O(1) log bytes: a rename record whose
        payload is the old name; data records are not rewritten."""
        with self._lock:
            entries = self.index.entries_for(old)
            if not entries:
                return
            self._append_record(new, old.encode("utf-8"), 0, FLAG_RENAME)
            self.index.rename_set(old, new)
            self._next_seq[new] = self._next_seq.pop(old, 0)
            delta = len(new.encode("utf-8")) - len(old.encode("utf-8"))
            self._live_bytes += delta * len(entries)
        self.maybe_compact()
        self._sync_tail()

    # -- read path ---------------------------------------------------------------
    def read(self, name: str, seq: int) -> bytes:
        """Read and CRC-verify one live page image."""
        with self._lock:
            entry = self.index.get(name, seq)
            if entry is None:
                raise KeyError(f"page log has no entry for {name!r} seq {seq}")
            if self._read_fh is None:
                self._read_fh = open(self.path, "rb")
            self._read_fh.seek(entry.offset)
            payload = self._read_fh.read(entry.length)
        if (len(payload) != entry.length
                or zlib.crc32(payload) & 0xFFFFFFFF != entry.payload_crc):
            raise IOError(
                f"page log corruption: {name!r} seq {seq} failed CRC")
        return payload

    def entries_for(self, name: str) -> List[PageLogEntry]:
        with self._lock:
            return self.index.entries_for(name)

    def set_names(self) -> List[str]:
        with self._lock:
            return self.index.set_names()

    def set_epoch(self, name: str) -> int:
        """Newest epoch across a set's live entries (-1 when absent) — what
        replay fencing compares against the catalog's shard epoch."""
        with self._lock:
            entries = self.index.entries_for(name)
            return max((e.epoch for e in entries), default=-1)

    def set_bytes(self, name: str) -> int:
        with self._lock:
            return sum(e.length for e in self.index.entries_for(name))

    # -- compaction ----------------------------------------------------------
    def live_bytes(self) -> int:
        with self._lock:
            return self._live_bytes

    def file_bytes(self) -> int:
        with self._lock:
            return self._file_bytes

    def amplification(self) -> float:
        """File bytes over live-record bytes — 1.0 is a perfectly compact
        log; superseded images, tombstoned sets, and rename markers all push
        it up."""
        with self._lock:
            return self._file_bytes / max(1, self._live_bytes)

    def compact(self) -> Dict[str, int]:
        """Rewrite the live records into a new generation file and atomically
        swap it in (``os.replace``).  The new file opens with a generation
        record, then every live page image in (set, seq) order with its
        original epoch and seq — so fencing, warm restore, and ``read()``
        behave identically before and after.  Readers never see a partial
        file: the swap is the commit point, and a crash before it leaves the
        old log untouched (plus a stale ``pages.log.compact`` that the next
        compaction overwrites and ``fsck`` reports).

        No lock is held across a sync. The live entries are snapshotted
        under the index lock, and the new file is written and fsynced from
        that snapshot. Then compaction takes the sync turn, copies the
        records appended meanwhile (some may be acknowledged durable
        already) and fsyncs again, and under the lock copies the last few
        records (appended after the turn was taken, so none is acknowledged
        yet) and swaps. The directory fsync follows, still holding the turn,
        so no append to the new file is acknowledged durable before the
        swap is. Replaying the copied records after the snapshot's gives the
        index the live state the old file held."""
        with self._sync_cv:
            while self._compacting:
                self._sync_cv.wait()
            self._compacting = True
        try:
            return self._compact()
        finally:
            with self._sync_cv:
                self._compacting = False
                self._sync_cv.notify_all()

    def _compact(self) -> Dict[str, int]:
        tmp = os.path.join(self.directory, COMPACT_TMP_FILENAME)
        with self._lock:
            new_gen = self.generation + 1
            gen_epoch = self._epoch()
            live = [(e.name, e.seq, e.epoch, e.offset, e.length, e.payload_crc)
                    for name in self.index.set_names()
                    for e in self.index.entries_for(name)]
            copied = self._file_bytes
            if not os.path.exists(self.path):
                open(self.path, "ab").close()
            src = open(self.path, "rb")  # the old inode, append-only
        with src, open(tmp, "wb") as out:
            out.write(_pack_record(b"", struct.pack("<Q", new_gen),
                                   0, FLAG_GENERATION, gen_epoch))
            for name, seq, epoch, offset, length, crc in live:
                src.seek(offset)
                payload = src.read(length)
                if (len(payload) != length
                        or zlib.crc32(payload) & 0xFFFFFFFF != crc):
                    raise IOError(
                        f"page log corruption: {name!r} seq {seq} failed CRC")
                out.write(_pack_record(name.encode("utf-8"), payload, seq,
                                       FLAG_DATA, epoch))
            self._fsync_file(out)
            self._take_sync_turn()
            try:
                with self._lock:
                    copied = self._copy_tail(src, out, copied)
                self._fsync_file(out)
                with self._lock:
                    end = self._copy_tail(src, out, copied)
                    out.close()
                    stats = self._swap(tmp, new_gen, len(live),
                                       unsynced=end - copied)
                self._fsync_directory()
            finally:
                self._give_sync_turn()
        return stats

    def _copy_tail(self, src, out, start: int) -> int:
        """Copy the old file's records from ``start`` to its end (caller
        holds the index lock) into the new generation; returns the end."""
        end = self._file_bytes
        if end > start:
            src.seek(start)
            out.write(src.read(end - start))
        return end

    def _swap(self, tmp: str, new_gen: int, rewritten: int,
              unsynced: int) -> Dict[str, int]:
        """Make the new generation the log (caller holds the index lock and
        the sync turn): swap the file, reopen, rebuild the index."""
        before = self._file_bytes
        # handles point at the old inode until replaced
        if self._append_fh is not None:
            self._append_fh.close()
            self._append_fh = None
        if self._read_fh is not None:
            self._read_fh.close()
            self._read_fh = None
        os.replace(tmp, self.path)
        # offsets all moved: rebuild the index from the new file.  Only the
        # records copied after the last fsync are owed a sync.
        self._unsynced = unsynced
        if unsynced:
            self._append_fh = open(self.path, "ab")
        self.index = ConsistentHashIndex(self.index.num_buckets)
        scan_log(self.path, self.index, {})
        self.generation = new_gen
        self._file_bytes = os.path.getsize(self.path)
        self._live_bytes = self._index_live_bytes()
        self.compactions += 1
        self.compaction_bytes += self._file_bytes
        self.last_compaction = {
            "generation": new_gen, "records": rewritten,
            "before_bytes": before, "after_bytes": self._file_bytes}
        return dict(self.last_compaction)

    @staticmethod
    def _fsync_file(fh) -> None:
        fh.flush()
        with sanitizer.blocking_region("pagelog.fsync"):
            os.fsync(fh.fileno())

    def _fsync_directory(self) -> None:
        try:
            dirfd = os.open(self.directory, os.O_RDONLY)
        except OSError:  # pragma: no cover - platform without dir fsync
            return
        try:
            with sanitizer.blocking_region("pagelog.fsync"):
                os.fsync(dirfd)
        except OSError:  # pragma: no cover - platform without dir fsync
            pass
        finally:
            os.close(dirfd)

    def maybe_compact(self) -> bool:
        """Amplification-triggered compaction: runs when the knob is set,
        the file is past the minimum size, and file/live exceeds the
        threshold.  Called after every mutating append (and periodically by
        the background compactor thread), never with the index lock held."""
        if self.compact_threshold is None:
            return False
        with self._lock:
            if (self._file_bytes < self.compact_min_bytes
                    or self.amplification() <= self.compact_threshold):
                return False
        self.compact()
        return True

    def start_compactor(self, interval_s: float) -> None:
        """Background amplification sweeps — for nodes whose write paths
        should never pay the rewrite inline."""
        if self._compactor is not None:
            return
        self._compactor_stop.clear()

        def loop() -> None:
            while not self._compactor_stop.wait(interval_s):
                try:
                    self.maybe_compact()
                except Exception:  # pragma: no cover - keep sweeping
                    pass

        self._compactor = threading.Thread(
            target=loop, name="pagelog-compactor", daemon=True)
        self._compactor.start()

    def stop_compactor(self) -> None:
        if self._compactor is None:
            return
        self._compactor_stop.set()
        self._compactor.join(timeout=5.0)
        self._compactor = None

    def close(self) -> None:
        """Close file handles; the log FILES stay — that is the point of the
        durable tier (``SpillStore.clear`` has no analogue here). The
        ``close`` and ``group`` fsync policies drain any unsynced tail here
        so a clean shutdown is durable."""
        self.stop_compactor()
        if self.fsync_policy in ("close", "group"):
            self._sync_tail(force=True)
        with self._lock:
            if self._append_fh is not None:
                self._append_fh.close()
                self._append_fh = None
            if self._read_fh is not None:
                self._read_fh.close()
                self._read_fh = None


def _record_size(name: str, payload_len: int) -> int:
    return _HEADER.size + len(name.encode("utf-8")) + payload_len


def _pack_record(name_bytes: bytes, payload: bytes, seq: int, flags: int,
                 epoch: int) -> bytes:
    """The one wire format: header (magic + crc over tail/name/payload),
    name, payload — shared by the live append path and compaction."""
    tail = _TAIL.pack(epoch, seq, len(name_bytes), len(payload), flags)
    crc = zlib.crc32(tail)
    crc = zlib.crc32(name_bytes, crc)
    crc = zlib.crc32(payload, crc) & 0xFFFFFFFF
    return struct.pack("<II", MAGIC, crc) + tail + name_bytes + payload


def scan_log(path: str, index: Optional[ConsistentHashIndex],
             report: Dict[str, int]) -> Tuple[int, int]:
    """Walk one log file record by record, CRC-verifying each; optionally
    applying data/tombstone/rename records to ``index``. Returns
    ``(offset_after_last_good_record, records_seen)``. Shared by replay
    (which then truncates the torn tail) and ``fsck`` (read-only)."""
    good_end = 0
    records = 0
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + _HEADER.size <= len(data):
        magic, crc, epoch, seq, name_len, payload_len, flags = \
            _HEADER.unpack_from(data, pos)
        if magic != MAGIC:
            report["crc_failures"] = report.get("crc_failures", 0) + 1
            break
        end = pos + _HEADER.size + name_len + payload_len
        if end > len(data):
            break  # short record: torn tail
        body = data[pos + 8:end]  # everything the crc covers
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            report["crc_failures"] = report.get("crc_failures", 0) + 1
            break
        name = data[pos + _HEADER.size:
                    pos + _HEADER.size + name_len].decode("utf-8")
        payload_off = pos + _HEADER.size + name_len
        records += 1
        report["records"] = report.get("records", 0) + 1
        if flags == FLAG_GENERATION:
            report["generations"] = report.get("generations", 0) + 1
            if payload_len == 8:
                report["generation"] = struct.unpack_from(
                    "<Q", data, payload_off)[0]
        elif flags == FLAG_TOMBSTONE:
            report["tombstones"] = report.get("tombstones", 0) + 1
            if index is not None:
                index.drop_set(name)
        elif flags == FLAG_RENAME:
            report["renames"] = report.get("renames", 0) + 1
            if index is not None:
                old = data[payload_off:payload_off + payload_len].decode(
                    "utf-8")
                index.rename_set(old, name)
        else:
            report["data"] = report.get("data", 0) + 1
            if index is not None:
                payload = data[payload_off:payload_off + payload_len]
                index.put(PageLogEntry(
                    name=name, seq=seq, epoch=epoch, offset=payload_off,
                    length=payload_len,
                    payload_crc=zlib.crc32(payload) & 0xFFFFFFFF))
        pos = end
        good_end = pos
    return good_end, records


def fsck(directory: str) -> Dict[str, object]:
    """Read-only health check of one page-log directory (``tools/
    pagelog_fsck.py`` is the CLI). Reports record counts, live sets after
    applying tombstones/renames, and any torn tail — without truncating."""
    path = os.path.join(directory, LOG_FILENAME)
    out: Dict[str, object] = {"directory": directory, "exists": False}
    if not os.path.exists(path):
        return out
    report: Dict[str, int] = {}
    index = ConsistentHashIndex()
    good_end, _records = scan_log(path, index, report)
    file_len = os.path.getsize(path)
    out.update(report)
    out["exists"] = True
    out["file_bytes"] = file_len
    out["torn_tail_bytes"] = file_len - good_end
    out["live_entries"] = len(index)
    out["live_sets"] = index.set_names()
    out["generation"] = report.get("generation", 0)
    live = sum(_record_size(e.name, e.length)
               for name in index.set_names()
               for e in index.entries_for(name))
    out["live_bytes"] = live
    out["amplification"] = round(file_len / max(1, live), 4)
    # A generation record is written first by compaction; one appearing
    # later means files were concatenated or corrupted.
    gen_ok = True
    if report.get("generations", 0) > 1:
        gen_ok = False
    out["stale_compact_tmp"] = os.path.exists(
        os.path.join(directory, COMPACT_TMP_FILENAME))
    out["clean"] = (good_end == file_len
                    and report.get("crc_failures", 0) == 0
                    and gen_ok)
    return out
