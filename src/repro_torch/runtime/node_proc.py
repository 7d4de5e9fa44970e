"""Multi-process data plane: one OS process per storage node.

``Cluster(backend="proc")`` re-platforms the in-process ``StorageNode``
loop onto real node processes.  The split follows the paper's monolithic
storage-process design:

* **control plane** — a length-prefixed JSON socket per node
  (``runtime/rpc.py``): shuffle map/pull orchestration, catalog ops,
  pressure/admission probes, kill/revive;
* **data plane** — page payloads (row small-page blocks and columnar blocks
  alike) move through ``core/shm_arena.py`` shared-memory frames and bypass
  the sockets entirely: a page image is copied once into a frame by its
  producer and once out by its consumer, with zero pickling (the
  ``rpc.pickle_fallbacks`` counter is the testable invariant).

Every segment is *created* by the driver — a SIGKILLed node process never
owned one, so it can never leak one — while each node process *allocates*
from its own outbox.  Sibling processes map each other's outboxes read-only,
so shuffle partition pages travel node-to-node without ever landing in the
driver.

On this design the driver stays a thin orchestrator: map work, admission
waits, spill fsyncs, and page-log writes all happen inside the node
processes, so their blocking time overlaps across nodes instead of
serializing through the driver loop the way the in-process backend's
``map_sharded`` does.

Copy of the JAX package's ``runtime/node_proc.py``. As in ``cluster.py``,
nothing is resolved before the fork. Node processes never touch torch.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import shutil
import signal
import socket
import threading
import time
import types
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.columnar import (ColumnarWriter, columns_to_records,
                             iter_column_blocks, records_to_columns,
                             route_partition_ids, set_column_crcs)
from ..core.memory_manager import MemoryManager, derive_staging_cap
from ..core.sanitizer import tracked_lock
from ..core.replication import (PartitionScheme, record_content_checksum,
                                replica_nodes, shard_checksum)
from ..core.services import (ColumnarShuffleService, SequentialWriter,
                             ShuffleService, columnar_job_data_attrs,
                             columnar_user_data_attrs, is_columnar,
                             iter_small_page_records, job_data_attrs,
                             user_data_attrs)
from ..core.shm_arena import (ArenaFullError, ShmArena, arena_name, gather,
                              segment_exists)
from ..core.statistics import StatisticsDB
from .cluster import (Cluster, DeadNodeError, RecoveryReport, ShardInfo,
                      ShardedSet, StorageNode, _iter_record_chunks,
                      dispatch_plan, reducer_hash)
from .rpc import RpcConnection, serve_connection
from .scheduler import ClusterScheduler
from .transfer import TransferEngine

__all__ = ["ProcCluster", "ProcShuffle", "NodeDiedError", "CleanupReport"]


class NodeDiedError(DeadNodeError):
    """A node *process* died mid-call (EOF/reset on its control socket)."""


# -- attrs factories over the wire -------------------------------------------
# Callables cannot cross the process boundary; the proc backend ships attrs
# as one of these preset kind strings instead.
_KIND_TO_ATTRS: Dict[str, Optional[Callable]] = {
    "none": None,
    "user": user_data_attrs,
    "job": job_data_attrs,
    "columnar_user": columnar_user_data_attrs,
    "columnar_job": columnar_job_data_attrs,
}
_ATTRS_TO_KIND = {v: k for k, v in _KIND_TO_ATTRS.items()}


def _attrs_kind(factory: Optional[Callable]) -> str:
    try:
        return _ATTRS_TO_KIND[factory]
    except KeyError:
        raise ValueError(
            "the proc backend ships shard attributes by name; use one of the "
            "preset factories (user/job/columnar_user/columnar_job) or None"
        ) from None


def _attrs_from_kind(kind: str):
    factory = _KIND_TO_ATTRS[kind]
    return factory() if factory is not None else None


def _dtype_to_wire(dtype: np.dtype):
    dtype = np.dtype(dtype)
    return dtype.descr if dtype.names else dtype.str


def _dtype_from_wire(wire) -> np.dtype:
    if isinstance(wire, str):
        return np.dtype(wire)
    return np.dtype([tuple(f) for f in wire])


def _record_bytes(arr: np.ndarray) -> bytes:
    """A record chunk's exact bytes, detached from any pinned page."""
    return np.ascontiguousarray(arr).tobytes()


# ===========================================================================
# Child side: the node process
# ===========================================================================
class _NodeServer:
    """Hosts one real ``StorageNode`` inside its own OS process and serves
    the control-plane ops.  Single-threaded by design: one in-flight request
    per node (the driver's per-connection lock enforces it), concurrency
    comes from having many node processes."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.node_id = int(cfg["node_id"])
        self.epoch = int(cfg.get("epoch", 0))
        self.node = StorageNode(
            self.node_id, cfg["capacity"], cfg.get("spill_dir"),
            policy=cfg["policy"],
            pressure_watermark=cfg["pressure_watermark"],
            pagelog_dir=cfg.get("pagelog_dir"),
            epoch_fn=lambda: self.epoch,
            pagelog_fsync=cfg["pagelog_fsync"],
            pagelog_compact_threshold=cfg.get("pagelog_compact_threshold"))
        frame = int(cfg["frame_size"])
        self.inbox = ShmArena.attach(cfg["inbox"], frame,
                                     int(cfg["inbox_frames"]))
        self.outbox = ShmArena.attach(cfg["outbox"], frame,
                                      int(cfg["outbox_frames"]), owner=True)
        self.admission = bool(cfg["admission"])
        self.timeout_s = float(cfg["admission_timeout_s"])
        self._peers: Dict[str, ShmArena] = {}
        self._writers: Dict[str, dict] = {}
        self._cursors: Dict[int, dict] = {}
        self._next_cursor = 0
        self._reservations: Dict[int, object] = {}
        self._next_rid = 0
        self._shuffles: Dict[str, "_ChildShuffle"] = {}
        self.handlers = {
            "ping": self.op_ping,
            "close": self.op_close,
            "free": self.op_free,
            "write_set": self.op_write_set,
            "export_set": self.op_export_set,
            "drop_set": self.op_drop_set,
            "checksum_set": self.op_checksum_set,
            "pressure": self.op_pressure,
            "reserve": self.op_reserve,
            "try_reserve": self.op_try_reserve,
            "release_reservation": self.op_release_reservation,
            "admit": self.op_admit,
            "log_sets": self.op_log_sets,
            "log_info": self.op_log_info,
            "log_drop": self.op_log_drop,
            "log_report": self.op_log_report,
            "log_compact": self.op_log_compact,
            "warm_restore": self.op_warm_restore,
            "shuffle_begin": self.op_shuffle_begin,
            "map_set": self.op_map_set,
            "map_finish": self.op_map_finish,
            "export_part": self.op_export_part,
            "import_part": self.op_import_part,
            "local_attach": self.op_local_attach,
            "release_part": self.op_release_part,
            "reduce_read": self.op_reduce_read,
            "reduce_stats": self.op_reduce_stats,
            "reduce_release": self.op_reduce_release,
        }

    # every request piggybacks the driver's topology/job event counter, so
    # the node's page log stamps records with the same epochs the in-process
    # backend would (the revival fence depends on it)
    def note_epoch(self, meta: dict) -> None:
        e = meta.get("epoch")
        if e is not None and int(e) > self.epoch:
            self.epoch = int(e)

    # -- payload channels ---------------------------------------------------
    def _payload(self, meta: dict, raw: bytes) -> np.ndarray:
        """Resolve a request's payload: a sibling's outbox (``seg``), the
        driver's inbox (bare ``desc``), or the raw socket bytes."""
        desc = meta.get("desc")
        if desc is None:
            return gather(None, None, raw)
        seg = meta.get("seg")
        if seg is None:
            return self.inbox.read(desc)
        peer = self._peers.get(seg)
        if peer is None:
            peer = ShmArena.attach(seg, int(meta["frame_size"]),
                                   int(meta["num_frames"]))
            self._peers[seg] = peer
        return peer.read(desc)

    def _ship(self, buf: np.ndarray) -> Tuple[Optional[dict], bytes]:
        """Outbound payload: shm frames when the outbox has room, socket
        bytes otherwise (counted by the rpc wire counters, never pickled)."""
        if buf.nbytes == 0:
            return None, b""
        try:
            return self.outbox.put(buf), b""
        except ArenaFullError:
            return None, buf.tobytes()

    # -- basic ops ----------------------------------------------------------
    def op_ping(self, meta, raw):
        return {"pid": os.getpid(), "node_id": self.node_id}

    def op_close(self, meta, raw):
        return {}

    def op_free(self, meta, raw):
        self.outbox.free(meta["desc"])
        return {}

    # -- set creation / export ---------------------------------------------
    def op_write_set(self, meta, raw):
        """Chunked record ingest into a fresh locality set.  The final chunk
        (``done``) may carry ``expect_crc``: on mismatch the set is dropped
        and the error propagates, so a recovery copy verifies in-node without
        a second read pass."""
        name = meta["name"]
        st = self._writers.get(name)
        pool = self.node.pool
        if st is None:
            kind = meta.get("kind", "none")
            attrs = _attrs_from_kind(kind)
            dtype = _dtype_from_wire(meta["dtype"])
            ls = pool.create_set(name, int(meta["page_size"]), attrs)
            wcls = (ColumnarWriter if kind.startswith("columnar")
                    else SequentialWriter)
            st = {"writer": wcls(pool, ls, dtype), "ls": ls, "dtype": dtype,
                  "crc": 0, "n": 0}
            self._writers[name] = st
        buf = self._payload(meta, raw)
        if buf.nbytes:
            recs = buf.view(st["dtype"])
            st["writer"].append_batch(recs)
            st["crc"] = zlib.crc32(buf, st["crc"])
            st["n"] += len(recs)
        if not meta.get("done"):
            return {"num_records": st["n"]}
        self._writers.pop(name, None)
        st["writer"].close()
        crc = st["crc"] & 0xFFFFFFFF
        expect = meta.get("expect_crc")
        if expect is not None and crc != int(expect):
            pool.drop_set(st["ls"])
            raise ValueError(f"write_set {name!r}: crc mismatch "
                             f"({crc:#x} != {int(expect):#x})")
        return {"num_records": st["n"], "crc": crc}

    def op_export_set(self, meta, raw):
        """Cursor-style streaming read of a set's record bytes, cut at
        record-chunk boundaries, with a running CRC32 that equals the
        catalog's ``shard_checksum`` at ``done`` (the chain is order-exact)."""
        cur = meta.get("cursor")
        if cur is None:
            pool = self.node.pool
            ls = pool.get_set(meta["name"])
            dtype = _dtype_from_wire(meta["dtype"])
            cur = self._next_cursor
            self._next_cursor += 1
            self._cursors[cur] = {"gen": _iter_record_chunks(pool, ls, dtype),
                                  "crc": 0, "n": 0,
                                  "itemsize": dtype.itemsize}
        st = self._cursors[cur]
        max_bytes = int(meta.get("max_bytes", 1 << 20))
        parts: List[bytes] = []
        total = 0
        done = False
        while total < max_bytes:
            try:
                chunk = next(st["gen"])
            except StopIteration:
                done = True
                break
            b = _record_bytes(chunk)
            parts.append(b)
            total += len(b)
            st["n"] += len(chunk)
        buf = np.frombuffer(b"".join(parts), np.uint8)
        st["crc"] = zlib.crc32(buf, st["crc"])
        if done:
            self._cursors.pop(cur, None)
        desc, out_raw = self._ship(buf)
        return {"cursor": cur, "done": done, "nbytes": int(buf.nbytes),
                "crc": st["crc"] & 0xFFFFFFFF,
                "num_records": st["n"], "desc": desc}, out_raw

    def op_drop_set(self, meta, raw):
        pool = self.node.pool
        name = meta["name"]
        if name in pool.paging.sets:
            pool.drop_set(pool.get_set(name))
        return {}

    def op_checksum_set(self, meta, raw):
        pool = self.node.pool
        ls = pool.get_set(meta["name"])
        dtype = _dtype_from_wire(meta["dtype"])
        crc = 0
        content = 0
        n = 0
        for chunk in _iter_record_chunks(pool, ls, dtype):
            crc = zlib.crc32(_record_bytes(chunk), crc)
            content = (content + record_content_checksum(chunk)) % (1 << 64)
            n += len(chunk)
        return {"crc": crc & 0xFFFFFFFF, "content_crc": content,
                "num_records": n}

    # -- memory / admission -------------------------------------------------
    def op_pressure(self, meta, raw):
        memory = self.node.memory
        return {"score": float(memory.pressure_score()),
                "report": memory.pressure_report()}

    def op_reserve(self, meta, raw):
        res = self.node.memory.reserve(int(meta["nbytes"]))
        rid = self._next_rid
        self._next_rid += 1
        self._reservations[rid] = res
        return {"rid": rid}

    def op_try_reserve(self, meta, raw):
        res = self.node.memory.try_reserve(
            int(meta["nbytes"]), urgency=meta.get("urgency", "normal"),
            timeout=meta.get("timeout"))
        if res is None:
            return {"rid": None}
        rid = self._next_rid
        self._next_rid += 1
        self._reservations[rid] = res
        return {"rid": rid}

    def op_release_reservation(self, meta, raw):
        res = self._reservations.pop(int(meta["rid"]), None)
        if res is not None:
            res.release()
        return {}

    def op_admit(self, meta, raw):
        ok = self.node.memory.admission.admit_placement(
            int(meta["nbytes"]), deadline_s=float(meta["deadline_s"]),
            count=bool(meta.get("count", True)))
        return {"admitted": bool(ok)}

    # -- durable page log ---------------------------------------------------
    def _log(self):
        return self.node.memory.pagelog

    def op_log_sets(self, meta, raw):
        log = self._log()
        if log is None:
            return {"sets": {}}
        return {"sets": {name: int(log.set_epoch(name))
                         for name in log.set_names()}}

    def op_log_info(self, meta, raw):
        log = self._log()
        name = meta["name"]
        if log is None or not log.entries_for(name):
            return {"entries": 0, "epoch": 0, "bytes": 0}
        return {"entries": len(log.entries_for(name)),
                "epoch": int(log.set_epoch(name)),
                "bytes": int(log.set_bytes(name))}

    def op_log_drop(self, meta, raw):
        log = self._log()
        if log is not None:
            for name in meta["names"]:
                log.drop_set(name)
        return {}

    def op_log_report(self, meta, raw):
        log = self._log()
        if log is None:
            return {"configured": False}
        return {"configured": True, "generation": int(log.generation),
                "compactions": int(log.compactions),
                "live_bytes": int(log.live_bytes()),
                "file_bytes": int(log.file_bytes()),
                "amplification": float(log.amplification())}

    def op_log_compact(self, meta, raw):
        log = self._log()
        if log is None:
            return {"compacted": False}
        log.compact()
        return {"compacted": True, "generation": int(log.generation)}

    def op_warm_restore(self, meta, raw):
        """Adopt one set from the replayed local page log after a revival
        (same contract as ``Cluster._warm_restore_set``, in-node)."""
        pool = self.node.pool
        log = self._log()
        name = meta["name"]
        if log is None or not log.entries_for(name):
            return {"adopted": False}
        if name in pool.paging.sets:
            return {"adopted": True}
        kind = meta.get("kind", "none")
        dtype = _dtype_from_wire(meta["dtype"])
        if not Cluster._verify_log_crc(log, name, dtype,
                                       int(meta["expect_crc"]),
                                       columnar=kind.startswith("columnar")):
            return {"adopted": False}
        pool.adopt_durable_set(name, int(meta["page_size"]),
                               _attrs_from_kind(kind))
        return {"adopted": True}

    # -- shuffle data plane --------------------------------------------------
    def _shuffle(self, name: str) -> "_ChildShuffle":
        return self._shuffles[name]

    def op_shuffle_begin(self, meta, raw):
        name = meta["shuffle"]
        if name not in self._shuffles:
            self._shuffles[name] = _ChildShuffle(
                self, name, int(meta["num_reducers"]),
                _dtype_from_wire(meta["dtype"]), int(meta["page_size"]),
                bool(meta["columnar"]), bool(meta["admission"]))
        return {}

    def op_map_set(self, meta, raw):
        return self._shuffle(meta["shuffle"]).map_set(
            meta["set_name"], meta.get("key_field"),
            int(meta.get("batch", 65536)))

    def op_map_finish(self, meta, raw):
        return self._shuffle(meta["shuffle"]).finish()

    def op_export_part(self, meta, raw):
        return self._shuffle(meta["shuffle"]).export_part(
            int(meta["reducer"]), int(meta.get("max_bytes", 1 << 20)))

    def op_import_part(self, meta, raw):
        return self._shuffle(meta["shuffle"]).import_part(
            meta, self._payload(meta, raw))

    def op_local_attach(self, meta, raw):
        return self._shuffle(meta["shuffle"]).local_attach(
            int(meta["reducer"]))

    def op_release_part(self, meta, raw):
        self._shuffle(meta["shuffle"]).release_part(int(meta["reducer"]))
        return {}

    def op_reduce_read(self, meta, raw):
        return self._shuffle(meta["shuffle"]).reduce_read(
            int(meta["reducer"]), meta.get("cursor"),
            int(meta.get("max_bytes", 1 << 20)))

    def op_reduce_stats(self, meta, raw):
        return self._shuffle(meta["shuffle"]).reduce_stats(
            int(meta["reducer"]))

    def op_reduce_release(self, meta, raw):
        self._shuffle(meta["shuffle"]).reduce_release(int(meta["reducer"]))
        return {}

    # -- lifecycle ----------------------------------------------------------
    def teardown(self) -> None:
        try:
            memory = self.node.memory
            if memory is not None:
                if memory.pagelog is not None:
                    memory.pagelog.close()
                memory.close()  # graceful exit cleans the scratch spill dir
        except Exception:
            pass
        for arena in [self.inbox, self.outbox, *self._peers.values()]:
            try:
                arena.close()
            except Exception:
                pass


class _ChildShuffle:
    """Per-process shuffle state: the real ``ShuffleService`` (or columnar
    twin) plus export cursors, import landing sets, and the reduce-source
    registry.  Mirrors exactly what ``ClusterShuffle`` keeps per node, but
    the bytes never leave this process except as whole page images."""

    def __init__(self, server: _NodeServer, name: str, num_reducers: int,
                 dtype: np.dtype, page_size: int, columnar: bool,
                 admission: bool):
        self.server = server
        self.name = name
        self.num_reducers = num_reducers
        self.dtype = dtype
        self.page_size = page_size
        self.columnar = columnar
        self.admission = admission
        self.svc = None
        # reducer -> {"pages": [...], "crc": running} export cursor
        self._exports: Dict[int, dict] = {}
        # (reducer, src_node) -> {"ls", "crc"} import landing state
        self._imports: Dict[Tuple[int, int], dict] = {}
        # reducer -> {src_node: source entry} for the reduce read
        self.sources: Dict[int, Dict[int, dict]] = {}
        self._read_cursors: Dict[int, dict] = {}
        self._next_cursor = 0

    # -- map side -----------------------------------------------------------
    def _service(self):
        if self.svc is None:
            pool = self.server.node.pool
            if self.columnar:
                self.svc = ColumnarShuffleService(
                    pool, f"{self.name}/map{self.server.node_id}",
                    self.num_reducers, self.dtype, page_size=self.page_size,
                    attrs_factory=columnar_job_data_attrs)
            else:
                self.svc = ShuffleService(
                    pool, f"{self.name}/map{self.server.node_id}",
                    self.num_reducers, self.dtype, page_size=self.page_size,
                    attrs_factory=job_data_attrs)
        return self.svc

    def _paced(self, nbytes: int):
        memory = self.server.node.memory
        if not self.admission:
            return memory.reserve(nbytes)
        return (memory.try_reserve(nbytes, urgency="required",
                                   timeout=self.server.timeout_s)
                or memory.reserve(nbytes))

    def map_set(self, set_name: str, key_field: Optional[str],
                batch: int) -> dict:
        """Map one locally held set into this node's shuffle buffers.  This
        runs *inside* the node process: admission waits and spill I/O here
        overlap with every other node's, which is the wall-clock win the
        proc backend exists for."""
        pool = self.server.node.pool
        ls = pool.get_set(set_name)
        svc = self._service()
        worker = (self.server.node_id, 0)
        total = 0
        if self.columnar and is_columnar(ls):
            for cols, n in iter_column_blocks(pool, ls, self.dtype):
                keys = (cols[key_field] if key_field is not None
                        else columns_to_records(cols, self.dtype, n)
                        [self.dtype.names[0]])
                h = route_partition_ids(keys, self.num_reducers)
                parts = (h.astype(np.uint8) if self.num_reducers <= 256
                         else h.astype(np.int64))
                order, _counts, offsets = dispatch_plan(parts,
                                                        self.num_reducers)
                reservation = self._paced(n * self.dtype.itemsize)
                try:
                    svc.add_gathered(worker, cols, order, offsets)
                finally:
                    reservation.release()
                total += n
            return {"records": total}
        field_name = key_field or self.dtype.names[0]
        for chunk in _iter_record_chunks(pool, ls, self.dtype):
            for i in range(0, len(chunk), batch):
                recs = chunk[i:i + batch]
                parts = reducer_hash(recs[field_name], self.num_reducers)
                order, _counts, offsets = dispatch_plan(parts,
                                                        self.num_reducers)
                reservation = self._paced(recs.nbytes)
                try:
                    if self.columnar:
                        # row-stored input into a columnar shuffle: split
                        # once, then the fused gather path (same
                        # compatibility route as the in-process map_batch)
                        svc.add_gathered(worker, records_to_columns(recs),
                                         order, offsets)
                    else:
                        routed = recs[order]
                        for r in range(self.num_reducers):
                            sub = routed[offsets[r]:offsets[r + 1]]
                            if len(sub):
                                svc.get_buffer(worker, r).add_batch(sub)
                finally:
                    reservation.release()
                total += len(recs)
        return {"records": total}

    def finish(self) -> dict:
        svc = self._service()
        svc.finish_writes()
        memory = self.server.node.memory
        out = {"partition_bytes": [int(b) for b in svc.partition_bytes],
               "partition_records": [int(n) for n in svc.partition_records],
               "pressure": float(memory.pressure_score())}
        if self.columnar:
            out["crcs"] = [[int(c) for c in crcs]
                           for crcs in svc.partition_crcs]
        return out

    # -- partition export (whole page images out of the pool) ---------------
    def export_part(self, reducer: int, max_bytes: int):
        svc = self._service()
        st = self._exports.get(reducer)
        pool = self.server.node.pool
        if st is None:
            ls = svc.partition_sets[reducer]
            st = {"ls": ls, "pages": sorted(ls.pages), "crc": 0}
            self._exports[reducer] = st
        sizes: List[int] = []
        parts: List[np.ndarray] = []
        total = 0
        while st["pages"]:
            page = st["ls"].pages[st["pages"][0]]
            if sizes and total + page.size > max_bytes:
                break
            view = pool.pin(page)
            try:
                parts.append(np.array(view[:page.size], dtype=np.uint8))
            finally:
                pool.unpin(page)
            sizes.append(int(page.size))
            total += int(page.size)
            st["pages"].pop(0)
        buf = (np.concatenate(parts) if parts
               else np.empty(0, dtype=np.uint8))
        st["crc"] = zlib.crc32(buf, st["crc"])
        done = not st["pages"]
        out = {"sizes": sizes, "done": done, "nbytes": int(buf.nbytes),
               "crc": st["crc"] & 0xFFFFFFFF}
        if not self.columnar:
            out["small_page"] = int(svc.small_page_of(reducer))
        if done:
            self._exports.pop(reducer, None)
            if self.columnar:
                out["crcs"] = [int(c) for c in svc.partition_crcs[reducer]]
        desc, raw = self.server._ship(buf)
        out["desc"] = desc
        return out, raw

    # -- partition import (landing page images into the pool) ---------------
    def import_part(self, meta: dict, buf: np.ndarray) -> dict:
        reducer = int(meta["reducer"])
        src = int(meta["src_node"])
        key = (reducer, src)
        pool = self.server.node.pool
        st = self._imports.get(key)
        if st is None:
            attrs = (columnar_job_data_attrs() if self.columnar
                     else job_data_attrs())
            name = f"{self.name}/import/r{reducer}/n{src}"
            st = {"ls": pool.create_set(name, self.page_size, attrs),
                  "name": name, "crc": 0}
            self._imports[key] = st
        st["crc"] = zlib.crc32(buf, st["crc"])
        if (st["crc"] & 0xFFFFFFFF) != int(meta["crc"]):
            raise ValueError(
                f"import_part {self.name}/r{reducer} from node {src}: "
                f"page stream crc mismatch")
        if buf.nbytes:
            reservation = self._paced(buf.nbytes)
            try:
                off = 0
                for size in meta["sizes"]:
                    size = int(size)
                    page = pool.new_page(st["ls"], size=size)
                    pool.view(page)[:] = buf[off:off + size]
                    pool.unpin(page, dirty=True)
                    off += size
            finally:
                reservation.release()
        if meta.get("done"):
            if self.columnar:
                got = set_column_crcs(pool, st["ls"], self.dtype)
                want = [int(c) for c in meta.get("crcs", [])]
                if [int(c) for c in got] != want:
                    raise ValueError(
                        f"import_part {self.name}/r{reducer} from node "
                        f"{src}: column crc chain mismatch")
            entry = {"kind": "import", "name": st["name"]}
            if not self.columnar:
                entry["small_page"] = int(meta["small_page"])
            self.sources.setdefault(reducer, {})[src] = entry
            self._imports.pop(key, None)
        return {"nbytes": int(buf.nbytes)}

    def local_attach(self, reducer: int) -> dict:
        svc = self._service()
        self.sources.setdefault(reducer, {})[self.server.node_id] = {
            "kind": "own"}
        return {"nbytes": int(svc.partition_bytes[reducer])}

    def release_part(self, reducer: int) -> None:
        if self.svc is not None:
            self.svc.release_partition(reducer)

    # -- reduce side ----------------------------------------------------------
    def _reduce_chunks(self, reducer: int):
        """Record chunks of the landed reduce input, in source-node order
        (matching the in-process backend's sorted-service pull order)."""
        pool = self.server.node.pool
        for src in sorted(self.sources.get(reducer, {})):
            entry = self.sources[reducer][src]
            if entry["kind"] == "own":
                for chunk in self._service().iter_partition(reducer):
                    if self.columnar:
                        cols, n = chunk
                        yield columns_to_records(cols, self.dtype, n)
                    else:
                        yield chunk
                continue
            ls = pool.get_set(entry["name"])
            if self.columnar:
                for cols, n in iter_column_blocks(pool, ls, self.dtype):
                    yield columns_to_records(cols, self.dtype, n)
            else:
                yield from iter_small_page_records(
                    pool, ls, self.dtype, small_page=entry["small_page"])

    def reduce_read(self, reducer: int, cursor: Optional[int],
                    max_bytes: int):
        if cursor is None:
            cursor = self._next_cursor
            self._next_cursor += 1
            self._read_cursors[cursor] = {
                "gen": self._reduce_chunks(reducer), "n": 0}
        st = self._read_cursors[cursor]
        parts: List[bytes] = []
        total = 0
        done = False
        while total < max_bytes:
            try:
                chunk = next(st["gen"])
            except StopIteration:
                done = True
                break
            b = _record_bytes(chunk)
            parts.append(b)
            total += len(b)
            st["n"] += len(chunk)
        buf = np.frombuffer(b"".join(parts), np.uint8)
        if done:
            self._read_cursors.pop(cursor, None)
        desc, raw = self.server._ship(buf)
        return {"cursor": cursor, "done": done, "nbytes": int(buf.nbytes),
                "num_records": st["n"], "desc": desc}, raw

    def reduce_stats(self, reducer: int) -> dict:
        """Count + order-independent content checksum of the landed reduce
        input, computed here so checksum-only verification never ships the
        records anywhere (the benchmark's byte-identity certificate)."""
        n = 0
        content = 0
        for chunk in self._reduce_chunks(reducer):
            n += len(chunk)
            content = (content + record_content_checksum(chunk)) % (1 << 64)
        return {"num_records": n, "content_crc": content}

    def reduce_release(self, reducer: int) -> None:
        pool = self.server.node.pool
        for src, entry in self.sources.pop(reducer, {}).items():
            if entry["kind"] == "own":
                self.release_part(reducer)
            elif entry["name"] in pool.paging.sets:
                ls = pool.get_set(entry["name"])
                ls.end_lifetime(pool.clock)
                pool.drop_set(ls)


def _node_main(cfg: dict, sock: socket.socket,
               parent_sock: socket.socket,
               inherited: Sequence[socket.socket]) -> None:
    """Node-process entry point (fork start method — nothing is pickled).
    Inherited control sockets of *sibling* nodes are closed first, so a
    sibling's death reaches the driver as a clean EOF."""
    parent_sock.close()
    for s in inherited:
        try:
            s.close()
        except OSError:
            pass
    server = _NodeServer(cfg)
    try:
        serve_connection(sock, server.handlers, on_request=server.note_epoch)
    finally:
        try:
            server.teardown()
        finally:
            # skip inherited atexit/multiprocessing finalizers: the driver
            # owns every shared resource this process touched
            os._exit(0)


# ===========================================================================
# Driver side
# ===========================================================================
@dataclass
class CleanupReport:
    """What ``ProcCluster.close`` left behind (nothing, when healthy)."""

    orphan_processes: List[int] = field(default_factory=list)
    leaked_segments: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.orphan_processes and not self.leaked_segments


class _RemoteReservation:
    """Driver-side handle for a reservation held inside a node process."""

    def __init__(self, handle: "ProcNodeHandle", rid: int):
        self._handle = handle
        self.rid = rid

    def release(self) -> None:
        try:
            self._handle.call("release_reservation", rid=self.rid)
        except DeadNodeError:
            pass  # the node died; its reservations died with it


class _RemoteAdmission:
    def __init__(self, handle: "ProcNodeHandle"):
        self._handle = handle

    def admit_placement(self, nbytes: int, deadline_s: float = 0.05,
                        count: bool = True) -> bool:
        try:
            rep, _ = self._handle.call("admit", nbytes=int(nbytes),
                                       deadline_s=float(deadline_s),
                                       count=bool(count))
        except DeadNodeError:
            return False
        return bool(rep["admitted"])


class _RemotePageLog:
    """The scheduler's window onto a node process's page log (just the
    three probes ``recovery_plan`` costs with)."""

    def __init__(self, handle: "ProcNodeHandle"):
        self._handle = handle

    def _info(self, name: str) -> dict:
        rep, _ = self._handle.call("log_info", name=name)
        return rep

    def entries_for(self, name: str) -> int:
        return int(self._info(name)["entries"])

    def set_epoch(self, name: str) -> int:
        return int(self._info(name)["epoch"])

    def set_bytes(self, name: str) -> int:
        return int(self._info(name)["bytes"])


class RemoteMemory:
    """Duck-types the slice of ``MemoryManager`` the scheduler and shuffle
    admission paths touch, over RPC.  Same call sites, same semantics —
    the grant itself is taken inside the node process."""

    def __init__(self, handle: "ProcNodeHandle"):
        self._handle = handle
        self.admission = _RemoteAdmission(handle)

    def pressure_score(self) -> float:
        try:
            rep, _ = self._handle.call("pressure")
        except DeadNodeError:
            return 0.0
        return float(rep["score"])

    def pressure_report(self) -> dict:
        rep, _ = self._handle.call("pressure")
        return rep["report"]

    def reserve(self, nbytes: int) -> _RemoteReservation:
        rep, _ = self._handle.call("reserve", nbytes=int(nbytes))
        return _RemoteReservation(self._handle, int(rep["rid"]))

    def try_reserve(self, nbytes: int, *, urgency: str = "normal",
                    timeout: Optional[float] = None
                    ) -> Optional[_RemoteReservation]:
        rep, _ = self._handle.call("try_reserve", nbytes=int(nbytes),
                                   urgency=urgency, timeout=timeout)
        rid = rep.get("rid")
        if rid is None:
            return None
        return _RemoteReservation(self._handle, int(rid))

    @property
    def pagelog(self) -> Optional[_RemotePageLog]:
        if self._handle.cluster._pagelog_dir is None:
            return None
        return _RemotePageLog(self._handle)


class ProcNodeHandle:
    """Driver-side identity of one node process: its control connection,
    its two arenas (both *created* here, so a SIGKILL never leaks one), and
    the set-name mirror the scheduler's ``_holds`` reads without an RPC."""

    def __init__(self, cluster: "ProcCluster", node_id: int):
        self.cluster = cluster
        self.node_id = node_id
        self.generation = 0
        self.alive = False
        self.proc = None
        self.conn: Optional[RpcConnection] = None
        self.inbox: Optional[ShmArena] = None
        self.outbox: Optional[ShmArena] = None
        # set names this node's pool holds — kept in sync by every driver op
        # that creates/drops remote sets, so placement never pays an RPC
        self.set_mirror: set = set()
        self._memory = RemoteMemory(self)
        self._pool = types.SimpleNamespace(
            paging=types.SimpleNamespace(sets=self.set_mirror))
        self.spawn()

    @property
    def memory(self) -> Optional[RemoteMemory]:
        return self._memory if self.alive else None

    @property
    def pool(self):
        return self._pool if self.alive else None

    def spawn(self) -> None:
        self._unlink_arenas()
        c = self.cluster
        g = self.generation
        self.generation += 1
        self.inbox = ShmArena(arena_name(f"in{self.node_id}g{g}"),
                              c.arena_frame_bytes, c._inbox_frames,
                              create=True, owner=True)
        self.outbox = ShmArena(arena_name(f"out{self.node_id}g{g}"),
                               c.arena_frame_bytes, c._outbox_frames,
                               create=True, owner=False)
        c._segments.extend([self.inbox.name, self.outbox.name])
        parent_sock, child_sock = socket.socketpair()
        cfg = {
            "node_id": self.node_id,
            "capacity": c.node_capacity,
            "spill_dir": c._node_spill_dir(self.node_id),
            "policy": c.policy,
            "pressure_watermark": c.pressure_watermark,
            "pagelog_dir": c._node_pagelog_dir(self.node_id),
            "pagelog_fsync": c._pagelog_fsync,
            "pagelog_compact_threshold": c._pagelog_compact_threshold,
            "frame_size": c.arena_frame_bytes,
            "inbox": self.inbox.name,
            "inbox_frames": c._inbox_frames,
            "outbox": self.outbox.name,
            "outbox_frames": c._outbox_frames,
            "admission": c.admission,
            "admission_timeout_s": c.admission_timeout_s,
            "epoch": c.stats.event_seq,
        }
        inherited = [h.conn.sock for h in c.nodes.values()
                     if h is not self and h.conn is not None]
        self.proc = c._ctx.Process(
            target=_node_main, args=(cfg, child_sock, parent_sock, inherited),
            name=f"pangea-node{self.node_id}", daemon=True)
        self.proc.start()
        child_sock.close()
        self.conn = RpcConnection(parent_sock, timeout_s=c.rpc_timeout_s)
        self.set_mirror.clear()
        self.alive = True
        self.call("ping")

    def call(self, op: str, raw: bytes = b"", **fields):
        if not self.alive:
            raise DeadNodeError(f"node {self.node_id} is down")
        fields.setdefault("epoch", self.cluster.stats.event_seq)
        try:
            return self.conn.call(op, raw=raw, **fields)
        except OSError as exc:  # EOF/reset/timeout: the process is gone
            self.cluster._note_node_death(self.node_id)
            err = NodeDiedError(
                f"node {self.node_id} process died mid-call ({op!r})")
            err.node_id = self.node_id
            raise err from exc

    # -- payload helper (driver -> node) ------------------------------------
    def send_chunk(self, payload: bytes):
        """Stage an outbound payload in this node's inbox; falls back to the
        socket when the arena is full.  Returns ``(fields, raw, desc)`` —
        free ``desc`` after the call that consumed it returns."""
        try:
            desc = self.inbox.put(payload)
            return {"desc": desc}, b"", desc
        except ArenaFullError:
            return {"desc": None}, payload, None

    def fetch_reply(self, rep: dict, raw: bytes) -> np.ndarray:
        """Read an inbound payload (node -> driver) from the node's outbox
        (then free its frames) or from the raw socket bytes."""
        desc = rep.get("desc")
        buf = gather(self.outbox, desc, raw)
        if desc is not None:
            self.call("free", desc=desc)
        return buf

    def mark_dead(self) -> None:
        self.alive = False
        if self.conn is not None:
            self.conn.close()

    def sigkill(self) -> None:
        if self.proc is not None and self.proc.is_alive():
            try:
                os.kill(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.join(10)

    def _unlink_arenas(self) -> None:
        for arena in (self.inbox, self.outbox):
            if arena is not None and arena.created:
                try:
                    arena.unlink()
                except Exception:
                    pass
        self.inbox = None
        self.outbox = None


class ProcCluster:
    """``Cluster(backend="proc")``: the same catalog/scheduler/statistics
    control plane as the in-process backend, with every ``StorageNode``
    hosted in its own OS process and page bytes moving through shared
    memory.  The scheduler is the *same* ``ClusterScheduler`` class — the
    handles duck-type ``alive``/``memory``/``pool.paging.sets`` — so
    placement, admission, and recovery costing are shared code, not a
    re-implementation."""

    backend = "proc"

    def __init__(self, num_nodes: int, node_capacity: int = 32 << 20,
                 page_size: int = 1 << 18, replication_factor: int = 1,
                 spill_dir: Optional[str] = None,
                 transfer_workers: int = 4, policy: str = "data-aware",
                 admission: bool = True,
                 admission_deadline_s: float = 0.05,
                 admission_timeout_s: float = 0.2,
                 pressure_watermark: float = 0.85,
                 pagelog_dir: Optional[str] = None,
                 pagelog_fsync: str = "none",
                 pagelog_compact_threshold: Optional[float] = None,
                 arena_bytes: int = 8 << 20,
                 arena_frame_bytes: int = 1 << 16,
                 rpc_chunk_bytes: int = 1 << 20,
                 rpc_timeout_s: float = 60.0):
        if num_nodes < 2:
            raise ValueError("a cluster needs at least 2 nodes")
        self.num_nodes = num_nodes
        self.node_capacity = node_capacity
        self.page_size = page_size
        self.replication_factor = replication_factor
        self.policy = policy
        self.admission = admission
        self.admission_deadline_s = admission_deadline_s
        self.admission_timeout_s = admission_timeout_s
        self.pressure_watermark = pressure_watermark
        self._spill_dir = spill_dir
        self._pagelog_dir = pagelog_dir
        self._pagelog_fsync = pagelog_fsync
        self._pagelog_compact_threshold = pagelog_compact_threshold
        self.arena_frame_bytes = int(arena_frame_bytes)
        self._inbox_frames = max(4, int(arena_bytes) // self.arena_frame_bytes)
        self._outbox_frames = self._inbox_frames
        self.rpc_chunk_bytes = int(rpc_chunk_bytes)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self._ctx = mp.get_context("fork")  # spawn would re-import the world
        self.stats = StatisticsDB()
        self._segments: List[str] = []
        self.nodes: Dict[int, ProcNodeHandle] = {}
        for n in range(num_nodes):
            self.nodes[n] = ProcNodeHandle(self, n)
        self.driver_memory = MemoryManager(node_capacity, policy=policy)
        self.catalog: Dict[str, ShardedSet] = {}
        self.conflict_guards: Dict = {}
        self.durable_blobs: Dict[str, Tuple[int, int]] = {}
        self.scheduler = ClusterScheduler(self)
        self._transfer_workers = transfer_workers
        self._transfer: Optional[TransferEngine] = None
        self._acct_lock = tracked_lock("proc.acct")
        self.net_bytes = 0
        self.local_bytes = 0
        self._closed = False
        self._last_report: Optional[CleanupReport] = None

    # -- shared-with-Cluster plumbing -----------------------------------------
    def _node_spill_dir(self, node_id: int) -> Optional[str]:
        if self._spill_dir is None:
            return None
        return f"{self._spill_dir}/node{node_id}"

    def _node_pagelog_dir(self, node_id: int) -> Optional[str]:
        if self._pagelog_dir is None:
            return None
        return f"{self._pagelog_dir}/node{node_id}"

    def node(self, node_id: int) -> ProcNodeHandle:
        handle = self.nodes[node_id]
        if not handle.alive:
            raise DeadNodeError(f"node {node_id} is down")
        return handle

    def alive_node_ids(self) -> List[int]:
        return [n for n, h in self.nodes.items() if h.alive]

    def dead_node_ids(self) -> List[int]:
        return [n for n, h in self.nodes.items() if not h.alive]

    def conflict_guard(self, name_a: str, name_b: str, node: int):
        return None  # heterogeneous replica registration is inproc-only

    def add_net_bytes(self, n: int) -> None:
        with self._acct_lock:
            self.net_bytes += n

    def add_local_bytes(self, n: int) -> None:
        with self._acct_lock:
            self.local_bytes += n

    @property
    def transfer(self) -> TransferEngine:
        if self._transfer is None:
            cap = (derive_staging_cap(self.node_capacity,
                                      self.pressure_watermark)
                   if self.admission else None)
            self._transfer = TransferEngine(self._transfer_workers,
                                            name="transfer",
                                            dest_inflight_cap=cap)
        return self._transfer

    # -- membership -----------------------------------------------------------
    def _note_node_death(self, node_id: int) -> None:
        handle = self.nodes[node_id]
        if not handle.alive:
            return
        handle.mark_dead()
        handle.set_mirror.clear()
        self.stats.note_event()  # topology event: pressure snapshots stale

    def kill_node(self, node_id: int) -> None:
        """SIGKILL the node process — for this backend that IS the machine
        loss.  Scratch spill dies with the machine; the durable page log
        (a separate disk in the model) survives for warm recovery."""
        handle = self.nodes[node_id]
        handle.sigkill()
        self._note_node_death(node_id)
        sd = self._node_spill_dir(node_id)
        if sd is not None and os.path.isdir(sd):
            shutil.rmtree(sd, ignore_errors=True)
        handle._unlink_arenas()

    def revive_node(self, node_id: int,
                    warm: Optional[bool] = None) -> List[str]:
        handle = self.nodes[node_id]
        if handle.alive:
            raise ValueError(f"node {node_id} is alive; nothing to revive")
        if warm is None:
            warm = self._pagelog_dir is not None
        log_dir = self._node_pagelog_dir(node_id)
        if not warm and log_dir is not None and os.path.isdir(log_dir):
            shutil.rmtree(log_dir, ignore_errors=True)
        handle.spawn()  # the child's PageLog construction replays the index
        self.stats.note_event()
        return self._fence_pagelog(node_id)

    def _fence_pagelog(self, node_id: int) -> List[str]:
        """Same fence as ``Cluster._fence_pagelog`` with the log accessed
        over RPC: purge replayed sets the catalog no longer names on this
        node, or whose cataloged epoch outruns the log's."""
        handle = self.nodes[node_id]
        rep, _ = handle.call("log_sets")
        log_sets: Dict[str, int] = {name: int(e)
                                    for name, e in rep["sets"].items()}
        if not log_sets:
            return []
        valid: Dict[str, int] = {}
        for sset in self.catalog.values():
            info = sset.shards.get(node_id)
            if info is not None:
                valid[info.set_name] = info.epoch
            for oinfo in sset.shards.values():
                for holder, rep_name in oinfo.replicas:
                    if holder == node_id:
                        valid[rep_name] = oinfo.epoch
        for name, (nid, epoch) in self.durable_blobs.items():
            if nid == node_id:
                valid[name] = epoch
        fenced = [name for name, epoch in log_sets.items()
                  if name not in valid or epoch < valid[name]]
        if fenced:
            handle.call("log_drop", names=sorted(fenced))
        return sorted(fenced)

    # -- record movement ------------------------------------------------------
    def _send_records(self, node_id: int, set_name: str,
                      records: np.ndarray, dtype: np.dtype, page_size: int,
                      kind: str, expect_crc: Optional[int] = None) -> int:
        """Chunked driver -> node record write (inbox frames, socket
        fallback).  Returns the record bytes shipped."""
        handle = self.node(node_id)
        payload = records.tobytes()
        chunk = self.rpc_chunk_bytes
        offsets = list(range(0, len(payload), chunk)) or [0]
        for i, off in enumerate(offsets):
            piece = payload[off:off + chunk]
            done = i == len(offsets) - 1
            fields, raw, desc = handle.send_chunk(piece)
            fields.update(name=set_name, dtype=_dtype_to_wire(dtype),
                          page_size=page_size, kind=kind, done=done)
            if done and expect_crc is not None:
                fields["expect_crc"] = int(expect_crc)
            try:
                handle.call("write_set", raw=raw, **fields)
            finally:
                if desc is not None:
                    handle.inbox.free(desc)
        handle.set_mirror.add(set_name)
        return len(payload)

    def _fetch_set(self, node_id: int, set_name: str,
                   dtype: np.dtype) -> Tuple[np.ndarray, int]:
        """Stream a whole set driver-side; returns ``(records, crc)``."""
        handle = self.node(node_id)
        parts: List[np.ndarray] = []
        cursor = None
        while True:
            fields = {"name": set_name, "dtype": _dtype_to_wire(dtype),
                      "max_bytes": self.rpc_chunk_bytes}
            if cursor is not None:
                fields["cursor"] = cursor
            rep, raw = handle.call("export_set", **fields)
            parts.append(handle.fetch_reply(rep, raw))
            if rep["done"]:
                whole = (np.concatenate(parts) if parts
                         else np.empty(0, np.uint8))
                return whole.view(dtype), int(rep["crc"])
            cursor = rep["cursor"]

    def _copy_set(self, src_id: int, src_set: str, dst_id: int,
                  dst_set: str, dtype: np.dtype, page_size: int, kind: str,
                  expect_crc: Optional[int] = None) -> int:
        """Node-to-node set copy: the source exports record chunks into its
        outbox, the destination reads them straight out of that sibling
        segment — the bytes never visit the driver.  The destination
        verifies ``expect_crc`` in-node on the final chunk."""
        src = self.node(src_id)
        dst = self.node(dst_id)
        moved = 0
        cursor = None
        while True:
            fields = {"name": src_set, "dtype": _dtype_to_wire(dtype),
                      "max_bytes": self.rpc_chunk_bytes}
            if cursor is not None:
                fields["cursor"] = cursor
            rep, raw = src.call("export_set", **fields)
            desc = rep.get("desc")
            wfields = {"name": dst_set, "dtype": _dtype_to_wire(dtype),
                       "page_size": page_size, "kind": kind,
                       "done": bool(rep["done"]), "desc": desc}
            if desc is not None:
                wfields.update(seg=src.outbox.name,
                               frame_size=src.outbox.frame_size,
                               num_frames=src.outbox.num_frames)
            if rep["done"] and expect_crc is not None:
                wfields["expect_crc"] = int(expect_crc)
            try:
                dst.call("write_set", raw=raw, **wfields)
            finally:
                if desc is not None:
                    src.call("free", desc=desc)
            moved += int(rep["nbytes"])
            if rep["done"]:
                break
            cursor = rep["cursor"]
        dst.set_mirror.add(dst_set)
        if src_id == dst_id:
            self.add_local_bytes(moved)
        else:
            self.add_net_bytes(moved)
        return moved

    # -- raw byte blobs (serving KV slabs and other unsharded payloads) -------
    def store_bytes(self, node_id: int, name: str, data: bytes) -> int:
        """Blob write over RPC: the bytes land in the node *process*'s pool
        (drop-before-rewrite), so a serving replica slab physically outlives
        a SIGKILL of the sequence's primary node."""
        handle = self.node(node_id)
        handle.call("drop_set", name=name)
        recs = np.frombuffer(bytes(data), dtype=np.uint8)
        return self._send_records(node_id, name, recs, np.dtype(np.uint8),
                                  self.page_size, "none")

    def load_bytes(self, node_id: int, name: str) -> bytes:
        handle = self.node(node_id)
        if name not in handle.set_mirror:
            raise KeyError(name)
        recs, _crc = self._fetch_set(node_id, name, np.dtype(np.uint8))
        return recs.tobytes()

    def drop_bytes(self, node_id: int, name: str) -> None:
        handle = self.nodes[node_id]
        if handle.alive and name in handle.set_mirror:
            try:
                handle.call("drop_set", name=name)
            except DeadNodeError:
                pass  # died under us: its blobs are gone anyway
            handle.set_mirror.discard(name)

    def has_bytes(self, node_id: int, name: str) -> bool:
        handle = self.nodes[node_id]
        return bool(handle.alive and name in handle.set_mirror)

    # -- sharded sets ---------------------------------------------------------
    def create_sharded_set(self, name: str, records: np.ndarray,
                           key_fn: Callable[[np.ndarray], np.ndarray],
                           partitions_per_node: int = 4,
                           page_size: Optional[int] = None,
                           replication_factor: Optional[int] = None,
                           attrs_factory: Optional[Callable] = None,
                           partition_key: Optional[str] = None,
                           node_ids: Optional[Sequence[int]] = None,
                           ) -> ShardedSet:
        if name in self.catalog:
            raise ValueError(f"sharded set {name!r} already exists")
        factor = (self.replication_factor if replication_factor is None
                  else replication_factor)
        page_size = page_size or self.page_size
        domain = (list(node_ids) if node_ids is not None
                  else self.alive_node_ids())
        if not domain:
            raise DeadNodeError("no alive nodes to place a sharded set on")
        if factor >= len(domain):
            raise ValueError(f"replication factor {factor} needs more than "
                             f"{len(domain)} nodes")
        scheme = PartitionScheme(partition_key or name, key_fn,
                                 partitions_per_node * len(domain),
                                 len(domain))
        sset = ShardedSet(name, records.dtype, scheme, page_size, factor,
                          node_ids=domain)
        if attrs_factory is None and self._pagelog_dir is not None:
            attrs_factory = user_data_attrs
        kind = _attrs_kind(attrs_factory)
        sset.attrs_factory = attrs_factory
        slots = sset.scheme.node_of_records(records)
        order, _counts, offsets = dispatch_plan(slots, len(domain))
        routed = records[order]
        epoch = self.stats.event_seq
        # One engine job per destination write: sends to different node
        # processes overlap, so the durable tier's per-page fsyncs (and any
        # spill) pay once per node in wall-clock, not once per write — the
        # in-process backend necessarily serializes this loop.  Replicas
        # chain off their primary and stream child-to-child through sibling
        # shm (the driver never re-ships the bytes), CRC-verified in the
        # holder's process.
        jobs = []
        for slot, nid in enumerate(domain):
            shard = routed[offsets[slot]:offsets[slot + 1]]
            info = ShardInfo(node_id=nid,
                             set_name=sset.primary_set_name(nid),
                             num_records=len(shard),
                             checksum=shard_checksum(shard),
                             content_checksum=record_content_checksum(shard),
                             epoch=epoch)
            primary = self.transfer.submit(
                self._send_records, nid, info.set_name, shard, sset.dtype,
                page_size, kind, label=f"{name}/shard{nid}")
            jobs.append(primary)
            for hslot in replica_nodes(slot, len(domain), factor):
                holder = domain[hslot]
                rep_name = sset.replica_set_name(nid, holder)
                jobs.append(self.transfer.submit(
                    self._copy_set, nid, info.set_name, holder, rep_name,
                    sset.dtype, page_size, kind, info.checksum,
                    after=(primary,),
                    label=f"{name}/replica{nid}@{holder}"))
                info.replicas.append((holder, rep_name))
            sset.shards[nid] = info
        for fut in jobs:
            fut.result()
        self.catalog[name] = sset
        self.stats.register_replica(name, Cluster._replica_info(self, sset))
        self.stats.note_event()
        return sset

    def read_shard_from(self, sset: ShardedSet,
                        node_id: int) -> Tuple[int, np.ndarray]:
        info = sset.shards[node_id]
        mismatches: List[str] = []
        for holder, set_name in self.scheduler.read_sources(sset, node_id):
            recs, crc = self._fetch_set(holder, set_name, sset.dtype)
            if holder == node_id or crc == info.checksum:
                return holder, recs
            mismatches.append(f"{set_name}@{holder}")
        detail = (f" (checksum mismatch on {', '.join(mismatches)})"
                  if mismatches else "")
        raise DeadNodeError(
            f"node {node_id} is down and no verified replica of "
            f"{sset.name!r} shard {node_id} survives{detail}")

    def read_shard(self, sset: ShardedSet, node_id: int) -> np.ndarray:
        return self.read_shard_from(sset, node_id)[1]

    def read_sharded(self, sset: ShardedSet) -> np.ndarray:
        parts = [self.read_shard(sset, n) for n in sorted(sset.shards)]
        return np.concatenate(parts) if parts else np.empty(0, sset.dtype)

    def drop_sharded_set(self, sset: ShardedSet) -> None:
        for n, info in sset.shards.items():
            targets = [(n, info.set_name)] + list(info.replicas)
            for holder, set_name in targets:
                handle = self.nodes[holder]
                if handle.alive and set_name in handle.set_mirror:
                    handle.call("drop_set", name=set_name)
                    handle.set_mirror.discard(set_name)
        self.catalog.pop(sset.name, None)
        self.stats.note_event()

    # -- recovery -------------------------------------------------------------
    def recover_node(self, node_id: int) -> RecoveryReport:
        """Same recovery walk as the in-process backend — warm log adoption
        first when the scheduler costs it cheapest, else replica copies
        (node-to-node through sibling shm, CRC-verified in the destination
        process)."""
        t0 = time.perf_counter()
        report = RecoveryReport(node_id=node_id)
        report.fenced_sets = self.revive_node(node_id)
        for sset in self.catalog.values():
            kind = _attrs_kind(sset.attrs_factory)
            info = sset.shards.get(node_id)
            if info is not None:
                if not self._recover_shard(sset, info, node_id, kind,
                                           report):
                    report.checksum_failures.append(
                        f"{sset.name}: no surviving replica of shard "
                        f"{node_id}")
            for owner, oinfo in sset.shards.items():
                if owner == node_id:
                    continue
                for holder, rep_name in oinfo.replicas:
                    if holder != node_id:
                        continue
                    if self._warm_restore(node_id, rep_name, sset,
                                          oinfo.checksum, kind):
                        report.warm_replicas += 1
                        report.replicas_rebuilt += 1
                        continue
                    try:
                        report.bytes_transferred += self._copy_set(
                            owner, oinfo.set_name, node_id, rep_name,
                            sset.dtype, sset.page_size, kind,
                            expect_crc=oinfo.checksum)
                    except Exception:
                        report.checksum_failures.append(
                            f"{sset.name}: checksum mismatch on replica of "
                            f"shard {owner} at {node_id}")
                    report.replicas_rebuilt += 1
        report.seconds = time.perf_counter() - t0
        return report

    def _warm_restore(self, node_id: int, set_name: str, sset: ShardedSet,
                      expect_crc: int, kind: str) -> bool:
        if self._pagelog_dir is None:
            return False
        handle = self.nodes[node_id]
        if not handle.alive:
            return False
        rep, _ = handle.call("warm_restore", name=set_name,
                             page_size=sset.page_size,
                             dtype=_dtype_to_wire(sset.dtype),
                             expect_crc=int(expect_crc), kind=kind)
        if rep["adopted"]:
            handle.set_mirror.add(set_name)
            return True
        return False

    def _recover_shard(self, sset: ShardedSet, info: ShardInfo,
                       node_id: int, kind: str,
                       report: RecoveryReport) -> bool:
        for src in self.scheduler.recovery_plan(sset, node_id, node_id):
            if src.kind == "pagelog":
                if self._warm_restore(node_id, info.set_name, sset,
                                      info.checksum, kind):
                    report.sources[f"{sset.name}:{node_id}"] = "pagelog"
                    report.shards_recovered += 1
                    report.warm_shards += 1
                    return True
                continue
            if src.kind == "rebuild":
                # heterogeneous-replica rebuild is inproc-only (the proc
                # backend never registers replica pairs)
                continue
            try:
                report.bytes_transferred += self._copy_set(
                    src.holder, src.set_name, node_id, info.set_name,
                    sset.dtype, sset.page_size, kind,
                    expect_crc=info.checksum)
            except Exception:
                report.checksum_failures.append(
                    f"{sset.name}: checksum mismatch on shard {node_id} "
                    f"from {src.kind}@{src.holder}")
                self.nodes[node_id].call("drop_set", name=info.set_name)
                self.nodes[node_id].set_mirror.discard(info.set_name)
                continue
            report.sources[f"{sset.name}:{node_id}"] = \
                f"{src.kind}@{src.holder}"
            report.shards_recovered += 1
            return True
        return False

    # -- shuffles -------------------------------------------------------------
    def shuffle(self, name: str, num_reducers: int, dtype: np.dtype,
                page_size: Optional[int] = None,
                admission: Optional[bool] = None,
                columnar: bool = False) -> "ProcShuffle":
        return ProcShuffle(self, name, num_reducers, dtype,
                           page_size=page_size, admission=admission,
                           columnar=columnar)

    # -- observability --------------------------------------------------------
    def pressure_report(self) -> Dict[int, dict]:
        return {n: h.memory.pressure_report()
                for n, h in sorted(self.nodes.items()) if h.alive}

    def pagelog_report(self) -> Dict[int, dict]:
        return {n: h.call("log_report")[0]
                for n, h in sorted(self.nodes.items()) if h.alive}

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> CleanupReport:
        """Graceful teardown + the leak audit the tests assert on: no node
        process survives, no shm segment remains linked."""
        if self._closed:
            return self._last_report or CleanupReport()
        self._closed = True
        if self._transfer is not None:
            self._transfer.shutdown()
        for handle in self.nodes.values():
            if handle.alive:
                try:
                    handle.call("close")
                except (DeadNodeError, Exception):
                    pass
            handle.mark_dead()
            if handle.proc is not None:
                handle.proc.join(5)
                if handle.proc.is_alive():
                    handle.proc.terminate()
                    handle.proc.join(2)
                if handle.proc.is_alive():  # pragma: no cover
                    handle.proc.kill()
                    handle.proc.join(2)
            handle._unlink_arenas()
        orphans = [h.node_id for h in self.nodes.values()
                   if h.proc is not None and h.proc.is_alive()]
        leaked = [name for name in self._segments if segment_exists(name)]
        self._last_report = CleanupReport(orphan_processes=orphans,
                                          leaked_segments=leaked)
        return self._last_report

    def shutdown(self) -> CleanupReport:
        return self.close()

    def __enter__(self) -> "ProcCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ProcShuffle:
    """Driver-side orchestration of a shuffle across node processes.

    Map tasks are one RPC per shard, submitted as transfer-engine jobs:
    the worker thread blocks in ``recv`` (GIL released) while the node
    process partitions, writes, throttles on admission, and spills — so on
    N nodes those phases genuinely overlap, where the in-process
    ``map_sharded`` runs them through one serial driver loop.  Partition
    pulls move whole page images node-to-node through sibling outbox
    frames; the driver only relays descriptors."""

    def __init__(self, cluster: ProcCluster, name: str, num_reducers: int,
                 dtype: np.dtype, page_size: Optional[int] = None,
                 admission: Optional[bool] = None, columnar: bool = False):
        self.cluster = cluster
        self.name = name
        self.num_reducers = num_reducers
        self.dtype = np.dtype(dtype)
        self.page_size = page_size or cluster.page_size
        self.columnar = columnar
        self.admission = (cluster.admission if admission is None
                          else admission)
        self.scheduler = cluster.scheduler
        self.placement: Optional[Dict[int, int]] = None
        self.diversions: Dict[int, Tuple[int, int]] = {}
        self._lock = tracked_lock("proc.shuffle")
        self._begun: set = set()
        # worker node -> [(sset, shard_id, key_field, batch, n)]
        self._work: Dict[int, List[tuple]] = {}
        self._finished: set = set()
        self._done_pairs: set = set()  # (reducer, src) moved to its reducer
        self._landed: set = set()      # reducers fully landed
        self._dead_handled: set = set()

    # -- map side -------------------------------------------------------------
    def _ensure_begun(self, node_id: int) -> None:
        with self._lock:
            if node_id in self._begun:
                return
            self._begun.add(node_id)
        self.cluster.node(node_id).call(
            "shuffle_begin", shuffle=self.name,
            num_reducers=self.num_reducers,
            dtype=_dtype_to_wire(self.dtype), page_size=self.page_size,
            columnar=self.columnar, admission=self.admission)

    def map_shard(self, sset: ShardedSet, shard_id: int,
                  key_field: Optional[str] = None,
                  batch: int = 65536) -> int:
        sources = self.scheduler.read_sources(sset, shard_id)
        if not sources:
            raise DeadNodeError(
                f"no surviving copy of {sset.name!r} shard {shard_id}")
        worker, set_name = sources[0]
        self._ensure_begun(worker)
        rep, _ = self.cluster.node(worker).call(
            "map_set", shuffle=self.name, set_name=set_name,
            key_field=key_field, batch=batch)
        with self._lock:
            self._work.setdefault(worker, []).append(
                (sset, shard_id, key_field, batch, int(rep["records"])))
        return worker

    def map_sharded(self, sset: ShardedSet, key_field: Optional[str] = None,
                    batch: int = 65536) -> None:
        """Map every shard concurrently — one engine job per shard, each a
        blocking RPC into the shard holder's process.  A node process dying
        mid-map is re-executed from a replica holder (same recovery rule as
        the in-process straggler path)."""
        jobs = [(n, self.cluster.transfer.submit(
                    self.map_shard, sset, n, key_field, batch,
                    label=f"{self.name}/map{n}"))
                for n in sorted(sset.shards)]
        for shard_id, fut in jobs:
            try:
                fut.result()
            except NodeDiedError as exc:
                self._recover_dead(getattr(exc, "node_id", shard_id))
                self.map_shard(sset, shard_id, key_field, batch)

    def _finish_one(self, node_id: int) -> None:
        rep, _ = self.cluster.node(node_id).call("map_finish",
                                                 shuffle=self.name)
        for r, nbytes in enumerate(rep["partition_bytes"]):
            self.cluster.stats.record_shuffle_bytes(self.name, r, node_id,
                                                    int(nbytes))
        self.cluster.stats.record_node_pressure(node_id,
                                                float(rep["pressure"]))
        with self._lock:
            self._finished.add(node_id)

    def finish_maps(self) -> None:
        jobs = [(n, self.cluster.transfer.submit(
                    self._finish_one, n, label=f"{self.name}/finish{n}"))
                for n in sorted(self._work)]
        for node_id, fut in jobs:
            try:
                fut.result()
            except NodeDiedError as exc:
                self._recover_dead(getattr(exc, "node_id", node_id))

    # -- placement ------------------------------------------------------------
    def reducer_node(self, reducer: int) -> int:
        if self.placement is not None and reducer in self.placement:
            node = self.placement[reducer]
            if self.cluster.nodes[node].alive:
                return node
        alive = self.cluster.alive_node_ids()
        return alive[reducer % len(alive)]

    def assign_placement(self, placement: Dict[int, int]) -> None:
        self.placement = dict(placement)

    def place_reducers_locally(self) -> Dict[int, int]:
        if self.admission:
            plan = self.scheduler.place_reducers_admitted(
                self.name, self.num_reducers,
                deadline_s=self.cluster.admission_deadline_s)
            self.diversions = dict(plan.diversions)
            self.assign_placement(plan.placement)
        else:
            self.assign_placement(self.scheduler.place_reducers(
                self.name, self.num_reducers))
        return self.placement

    # -- death mid-shuffle ----------------------------------------------------
    def _recover_dead(self, dead: int) -> None:
        """Ride the replica recovery path for a SIGKILLed mapper: its map
        output died with its pool, so its shards re-map on surviving copy
        holders and the byte statistics re-publish (``record_shuffle_bytes``
        overwrites).  Only legal before any partition landed — afterwards
        surviving services were already partially drained, and a re-map
        would double-count records into pulled partitions."""
        with self._lock:
            if dead in self._dead_handled:
                return
            self._dead_handled.add(dead)
            items = self._work.pop(dead, [])
            refinish = dead in self._finished
        if self._done_pairs:
            raise DeadNodeError(
                f"node {dead} died after reduce pulls began; the shuffle "
                f"must re-run")
        for r in range(self.num_reducers):
            self.cluster.stats.record_shuffle_bytes(self.name, r, dead, 0)
        touched: set = set()
        for (sset, shard_id, key_field, batch, _n) in items:
            worker = self.map_shard(sset, shard_id, key_field, batch)
            touched.add(worker)
        if refinish:
            for worker in sorted(touched):
                self._finish_one(worker)
        if self.placement is not None:
            for r, node in list(self.placement.items()):
                if node == dead:
                    ranked, _total = self.scheduler._rank_candidates(
                        [self.name], r, self.reducer_node(r))
                    self.placement[r] = ranked[0]

    # -- reduce side ----------------------------------------------------------
    def _move_partition(self, src_id: int, dst_id: int, reducer: int) -> None:
        src = self.cluster.node(src_id)
        dst = self.cluster.node(dst_id)
        while True:
            rep, raw = src.call("export_part", shuffle=self.name,
                                reducer=reducer,
                                max_bytes=self.cluster.rpc_chunk_bytes)
            desc = rep.get("desc")
            fields = {"shuffle": self.name, "reducer": reducer,
                      "src_node": src_id, "sizes": rep["sizes"],
                      "crc": rep["crc"], "done": rep["done"], "desc": desc}
            if desc is not None:
                fields.update(seg=src.outbox.name,
                              frame_size=src.outbox.frame_size,
                              num_frames=src.outbox.num_frames)
            if not self.columnar:
                fields["small_page"] = rep["small_page"]
            elif rep["done"]:
                fields["crcs"] = rep.get("crcs", [])
            try:
                dst.call("import_part", raw=raw, **fields)
            finally:
                if desc is not None:
                    try:
                        src.call("free", desc=desc)
                    except DeadNodeError:
                        pass
            self.cluster.add_net_bytes(int(rep["nbytes"]))
            if rep["done"]:
                break
        src.call("release_part", shuffle=self.name, reducer=reducer)

    def _land(self, reducer: int) -> int:
        """Move partition ``reducer`` from every map node to its reducer
        node (page images through sibling shm; the driver relays only
        descriptors).  Returns the destination node id."""
        if reducer in self._landed:
            return self.reducer_node(reducer)
        attempts = 0
        while True:
            try:
                for n in sorted(self._work):
                    if not self.cluster.nodes[n].alive:
                        self._recover_dead(n)
                dst_id = self.reducer_node(reducer)
                dst = self.cluster.node(dst_id)
                self._ensure_begun(dst_id)
                for src_id in sorted(self._work):
                    if (reducer, src_id) in self._done_pairs:
                        continue
                    if src_id == dst_id:
                        rep, _ = dst.call("local_attach", shuffle=self.name,
                                          reducer=reducer)
                        self.cluster.add_local_bytes(int(rep["nbytes"]))
                    else:
                        self._move_partition(src_id, dst_id, reducer)
                    self._done_pairs.add((reducer, src_id))
                self._landed.add(reducer)
                return dst_id
            except NodeDiedError as exc:
                attempts += 1
                if attempts > 2:
                    raise
                dead = getattr(exc, "node_id", None)
                if dead is not None:
                    self._recover_dead(dead)
                # else: the dead-node sweep at the top of the retry finds it

    def pull(self, reducer: int) -> np.ndarray:
        """Land partition ``reducer`` on its reducer node, then materialize
        it driver-side (record chunks in source-node order — the same
        concatenation order as the in-process backend's ``pull``)."""
        dst_id = self._land(reducer)
        dst = self.cluster.node(dst_id)
        parts: List[np.ndarray] = []
        cursor = None
        while True:
            fields = {"shuffle": self.name, "reducer": reducer,
                      "max_bytes": self.cluster.rpc_chunk_bytes}
            if cursor is not None:
                fields["cursor"] = cursor
            rep, raw = dst.call("reduce_read", **fields)
            parts.append(dst.fetch_reply(rep, raw))
            if rep["done"]:
                break
            cursor = rep["cursor"]
        whole = np.concatenate(parts) if parts else np.empty(0, np.uint8)
        return whole.view(self.dtype)

    def pull_remote(self, reducer: int) -> dict:
        """Land the partition and verify it where it lies: the reducer node
        computes count + content checksum in-process, so reduce-side work
        overlaps landing and nothing rides the driver socket but a dict."""
        dst_id = self._land(reducer)
        rep, _ = self.cluster.node(dst_id).call(
            "reduce_stats", shuffle=self.name, reducer=reducer)
        return {"node": dst_id, "num_records": int(rep["num_records"]),
                "content_crc": int(rep["content_crc"])}

    def pull_async(self, reducer: int, after: Sequence = ()):
        return self.cluster.transfer.submit(
            self.pull_remote, reducer, after=after,
            label=f"{self.name}/pull{reducer}",
            dest=lambda: self.reducer_node(reducer),
            nbytes=lambda: sum(self.cluster.stats.shuffle_partition_bytes(
                self.name, reducer).values()))

    def release_reducer(self, reducer: int) -> None:
        try:
            self.cluster.node(self.reducer_node(reducer)).call(
                "reduce_release", shuffle=self.name, reducer=reducer)
        except DeadNodeError:
            pass
