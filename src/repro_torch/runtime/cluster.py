"""Multi-node cluster runtime over unified buffer pools — paper §2, §7–§9.

This is the layer that turns the single-node mechanisms (TLSF arena, unified
buffer pool, data-aware paging, services) into the system the paper evaluates.
It is split into three layers:

* **Mechanics (this module)** — ``StorageNode`` (one storage service: a
  ``BufferPool`` + spill store), ``Cluster`` (N nodes + the manager-side
  catalog/``StatisticsDB``), ``ShardedSet`` (hash-partitioned locality sets
  with chain replicas + CRC32 checksums), ``ClusterShuffle`` (map-side
  job-data pages, reducer pull, lifetime-ended release), replica-based
  ``recover_node``, and elastic ``remesh_degrade``.
* **Policy (``runtime/scheduler.py``)** — every placement decision is
  delegated to a ``ClusterScheduler``: reducer ``r`` lands on the node already
  holding the most map-output bytes for partition ``r``; reads of a dead
  owner's shard are routed to a CRC-verified surviving replica; a
  co-partitioned input elides the shuffle entirely (``stats.best_replica``);
  stragglers flagged by ``watchdog.StepTimer`` are re-executed from replica
  holders.
* **Wire (``runtime/transfer.py``)** — all inter-pool movement goes through
  ``copy_set`` and the threaded ``TransferEngine``; ``Cluster.transfer_records``
  is one client of it, and reducer pulls are engine jobs that overlap map
  finalization and each other.

The pressure signal is *enforced* as admission control: map
writers, pull chunks, and remesh streams pace themselves against the
destination MemoryManager's staging grant (``try_reserve``), the transfer
engine caps in-flight bytes per destination, and reducer placement re-routes
partitions whose planned node refuses admission past the deadline
(``place_reducers_admitted``; diversions recorded on
``ClusterShuffle.diversions``). ``Cluster(admission=False)`` restores the
always-grant behavior.

On unrecoverable node loss (no replacement machine), ``Cluster.remesh_degrade``
falls through to ``elastic.plan_remesh``: the cluster shrinks to the surviving
membership and every sharded set is re-partitioned over it from the freshest
surviving copies, instead of raising.

Everything moves through buffer pools: a "network transfer" is a paged read
from the source pool streamed into a sequential write on the destination pool,
with byte accounting standing in for the wire.

Copy of the JAX package's ``runtime/cluster.py``. Two changes: the dispatch
plan and the fused partition + CRC pass are this package's numpy
implementations, bound directly (the reference first tries a kernels package
that needs JAX); and there is no durable page log yet, so ``pagelog_dir``
raises ``NotImplementedError``.
"""
from __future__ import annotations

import os
import shutil
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.attributes import AttributeSet, StorageScheme
from ..core.buffer_pool import BufferPool, SpillStore
from ..core.columnar import (ColumnarWriter, ColumnLayout, _field_layout,
                             columns_crc32, columns_to_records,
                             iter_column_blocks,
                             read_all_columnar, read_block,
                             records_to_columns, route_partition_ids,
                             segment_sum)
from ..core.locality_set import LocalitySet
from ..core.memory_manager import MemoryManager, derive_staging_cap
from ..core.sanitizer import tracked_lock
from ..core.replication import (DistributedSet, PartitionScheme,
                                ReplicaRegistration,
                                combine_content_checksums,
                                record_content_checksum,
                                recover_target_shard, replica_nodes,
                                shard_checksum)
from ..core.services import (_HEADER, ColumnarShuffleService, HashService,
                             PageIterator, SequentialWriter, ShuffleService,
                             columnar_job_data_attrs, is_columnar,
                             job_data_attrs, read_all, user_data_attrs)
from ..core.statistics import ReplicaInfo, StatisticsDB
from .elastic import plan_remesh, remesh_partition_plan, surviving_node_ids
from .scheduler import ClusterScheduler
from .transfer import TransferEngine, copy_set
from .watchdog import StepTimer


def dispatch_plan(partition_ids: np.ndarray, num_partitions: int):
    """Group a batch by destination partition in one stable pass (the host
    analogue of MoE shuffle dispatch's slot assignment); records land
    contiguously per partition: ``order[offsets[p]:offsets[p+1]]`` are
    partition ``p``'s rows."""
    order = np.argsort(partition_ids, kind="stable")
    counts = np.bincount(partition_ids, minlength=num_partitions)
    offsets = np.empty(len(counts) + 1, np.int64)
    offsets[0] = 0
    np.cumsum(counts, out=offsets[1:])
    return order, counts, offsets


def _no_pagelog(pagelog_dir: Optional[str]) -> None:
    """The durable page log (``core/pagelog.py``) is not part of the port
    yet: asking for one raises instead of running without it."""
    if pagelog_dir is not None:
        raise NotImplementedError(
            "pagelog is ported in a later slice; pass pagelog_dir=None")


class DeadNodeError(RuntimeError):
    """Raised when touching a node that has been killed and not recovered,
    and no surviving replica can stand in for it."""


def reducer_hash(keys: np.ndarray, num_reducers: int) -> np.ndarray:
    """The shuffle's reducer-routing hash — ``int64 keys -> reducer ids``.

    Deliberately NOT the storage-placement hash (PartitionScheme's
    golden-ratio multiplier): reusing it would silently co-locate every
    record with its reducer and the shuffle would never exercise the
    transfer path. Shuffle-free execution is an explicit scheduler decision
    (plan_aggregation / plan_join), not a hash collision.

    Module-level (rather than a ``ClusterShuffle`` method) because every
    map site must route bit-identically — including map tasks running
    inside remote node processes (``runtime/node_proc``), which never see
    the driver's shuffle object."""
    h = keys.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
    h ^= h >> np.uint64(29)
    return (h % np.uint64(num_reducers)).astype(np.int64)


def _iter_record_chunks(pool, ls, dtype: np.dtype) -> Iterator[np.ndarray]:
    """Stream a locality set as record-array chunks regardless of its storage
    scheme: row pages decode in place (``PageIterator``), columnar pages
    materialize each block's columns into rows. The scheme-neutral read path
    the remesh stream and CRC verifiers share."""
    if is_columnar(ls):
        for cols, n in iter_column_blocks(pool, ls, dtype):
            yield columns_to_records(cols, dtype, n)
    else:
        yield from PageIterator(pool, ls, dtype, sorted(ls.pages))


def sharded_set_is_columnar(sset: "ShardedSet") -> bool:
    """Whether a sharded set's shards are columnar (the storage-scheme
    dimension of its remembered attrs factory; no factory means row)."""
    if sset.attrs_factory is None:
        return False
    return sset.attrs_factory().storage is StorageScheme.COLUMNAR


class StorageNode:
    """One Pangea storage service: a unified buffer pool plus its memory
    manager (paper §2 — every node runs one storage process owning all its
    data). ``node.memory`` is the runtime's window into the node's eviction
    policy, spill store, and pressure accounting. With a ``pagelog_dir`` the
    node also owns a durable page log — the tier below scratch spill that
    write-through sets page against and that survives the node's death."""

    def __init__(self, node_id: int, capacity: int,
                 spill_dir: Optional[str] = None,
                 policy: str = "data-aware",
                 pressure_watermark: float = 0.85,
                 pagelog_dir: Optional[str] = None,
                 epoch_fn=None,
                 pagelog_fsync: str = "none",
                 pagelog_compact_threshold: Optional[float] = None):
        self.node_id = node_id
        self.capacity = capacity
        self.pressure_watermark = pressure_watermark
        self.spill_dir = spill_dir
        self.policy = policy
        self.pagelog_dir = pagelog_dir
        self.epoch_fn = epoch_fn
        self.pagelog_fsync = pagelog_fsync
        self.pagelog_compact_threshold = pagelog_compact_threshold
        self.pool = self._build_pool()
        self.alive = True

    def _build_pool(self) -> BufferPool:
        """Construct the pool, reopening the durable page log from disk when
        one is configured (construction replays its index — a revival with
        surviving log files IS the warm start)."""
        _no_pagelog(self.pagelog_dir)
        return BufferPool(self.capacity, SpillStore(self.spill_dir),
                          policy=self.policy,
                          pressure_watermark=self.pressure_watermark)

    def revive(self) -> None:
        """Bring a killed node back with a fresh pool (and a reopened,
        replayed page log when durable storage is configured)."""
        self.pool = self._build_pool()
        self.alive = True

    @property
    def memory(self) -> Optional[MemoryManager]:
        """The node's MemoryManager (None once the node is dead)."""
        return self.pool.memory if self.pool is not None else None

    def write_records(self, set_name: str, records: np.ndarray,
                      dtype: np.dtype, page_size: int,
                      attrs: Optional[AttributeSet] = None) -> LocalitySet:
        ls = self.pool.create_set(set_name, page_size, attrs)
        if attrs is not None and attrs.storage is StorageScheme.COLUMNAR:
            w = ColumnarWriter(self.pool, ls, dtype)
        else:
            w = SequentialWriter(self.pool, ls, dtype)
        if len(records):
            w.append_batch(records)
        w.close()
        return ls

    def read_records(self, set_name: str, dtype: np.dtype) -> np.ndarray:
        ls = self.pool.get_set(set_name)
        if ls.attrs.storage is StorageScheme.COLUMNAR:
            return read_all_columnar(self.pool, ls, dtype)
        return read_all(self.pool, ls, dtype)


@dataclass
class ShardInfo:
    """Catalog entry for one primary shard of a sharded locality set.

    ``checksum`` is the order-exact CRC32 of the shard's record bytes
    (page-for-page copies must match it); ``content_checksum`` is the
    order-independent fingerprint (``record_content_checksum``) that also
    certifies shards re-assembled in a different record order — the
    co-partitioned rebuild path and the streaming remesh verify against it."""

    node_id: int
    set_name: str
    num_records: int
    checksum: int
    content_checksum: int = 0
    replicas: List[Tuple[int, str]] = field(default_factory=list)
    # topology/job event counter (StatisticsDB.event_seq) when this shard's
    # bytes were last (re)written — page-log replay is fenced against it, so
    # a shard dropped or rebuilt elsewhere while its node was dead cannot be
    # resurrected from the dead node's stale log entries
    epoch: int = 0


class ShardedSet:
    """A logical dataset hash-partitioned across the cluster's pools.

    ``shards[n]`` describes node ``n``'s primary shard; replicas live on the
    chain successors. Placement follows ``scheme`` over the set's placement
    domain ``node_ids`` (slot ``s`` of the scheme maps to ``node_ids[s]``) —
    the full membership at creation time, or the surviving membership after an
    elastic remesh. Any node can compute routing locally.
    """

    def __init__(self, name: str, dtype: np.dtype, scheme: PartitionScheme,
                 page_size: int, replication_factor: int,
                 node_ids: Optional[Sequence[int]] = None):
        self.name = name
        self.dtype = np.dtype(dtype)
        self.scheme = scheme
        self.page_size = page_size
        self.replication_factor = replication_factor
        self.node_ids: List[int] = (list(node_ids) if node_ids is not None
                                    else list(range(scheme.num_nodes)))
        # how to build each shard's AttributeSet; remembered so re-sharding
        # (remesh_degrade) re-creates shards under the same attributes
        self.attrs_factory: Optional[Callable[[], AttributeSet]] = None
        self.shards: Dict[int, ShardInfo] = {}

    @property
    def partition_key(self) -> str:
        """What this set is partitioned on (the scheme name registered in the
        statistics DB; co-partition detection compares it to a query's key)."""
        return self.scheme.name

    def node_of_records(self, records: np.ndarray) -> np.ndarray:
        """Actual node id (not scheme slot) each record routes to."""
        slots = self.scheme.node_of_records(records)
        return np.asarray(self.node_ids, dtype=np.int64)[slots]

    def primary_set_name(self, node_id: int) -> str:
        return f"{self.name}/shard{node_id}"

    def replica_set_name(self, owner: int, holder: int) -> str:
        return f"{self.name}/shard{owner}/replica@{holder}"


@dataclass
class ConflictGuard:
    """Paper §7's conflicting objects, cluster-level: when the same logical
    dataset is registered under two partitionings and node ``node`` holds a
    shard under BOTH, the records routed to ``node`` by both schemes exist
    nowhere else once that node dies — a factor-0 pair could then never
    rebuild either shard from the other. The guard is a copy of exactly
    those records, placed on the ring successor, consulted by the
    co-partitioned rebuild when the conflicted node's alternate shard is
    unreadable."""

    node: int           # the conflicted node both schemes route to
    holder: int         # where the guard copy lives
    set_name: str
    num_records: int
    checksum: int       # order-exact CRC32 of the guard records
    epoch: int = 0


@dataclass
class RecoveryReport:
    node_id: int
    shards_recovered: int = 0
    replicas_rebuilt: int = 0
    bytes_transferred: int = 0
    checksum_failures: List[str] = field(default_factory=list)
    # "<set>:<shard>" -> the recovery source the scheduler chose
    # ("replica@2", "rebuild<-other_set", "pagelog", ...)
    sources: Dict[str, str] = field(default_factory=dict)
    seconds: float = 0.0
    # durable-tier warm recovery
    warm_shards: int = 0        # primary shards restored from the local log
    warm_replicas: int = 0      # held replicas restored from the local log
    fenced_sets: List[str] = field(default_factory=list)  # stale log sets purged

    @property
    def ok(self) -> bool:
        return not self.checksum_failures


@dataclass
class RemeshReport:
    """What ``Cluster.remesh_degrade`` did: the elastic plan plus the
    re-sharding work (paper's recovery story when no replacement node
    exists — shrink instead of fail)."""

    dead_nodes: List[int]
    node_ids: List[int]                 # surviving placement domain
    plan: dict = field(default_factory=dict)
    resharded: List[str] = field(default_factory=list)
    lost: List[str] = field(default_factory=list)
    bytes_transferred: int = 0
    streamed: bool = False              # shard-to-shard streaming path used
    driver_peak_bytes: int = 0          # driver staging HWM during the remesh
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.lost


class Cluster:
    """N storage nodes + the manager node's catalog (paper §2 architecture).

    The manager here is in-process: ``catalog`` maps sharded-set names to
    their shard/replica/checksum metadata, ``stats`` is the paper's statistics
    database used by query planning (``best_replica``, shuffle byte maps),
    ``scheduler`` owns placement policy, and ``transfer`` is the lazy threaded
    engine every inter-pool byte rides through.

    ``backend`` selects the data plane: ``"inproc"`` (default) keeps every
    node an object in this process — fast to build, fully deterministic, the
    test fallback; ``"proc"`` re-platforms each node onto its own OS process
    with a socket control plane and a shared-memory page path
    (``runtime/node_proc.ProcCluster`` — same catalog/scheduler/shuffle
    surface, real wall-clock overlap).
    """

    def __new__(cls, *args, backend: str = "inproc", **kwargs):
        if cls is Cluster and backend == "proc":
            from .node_proc import ProcCluster
            return ProcCluster(*args, **kwargs)
        if backend not in ("inproc", "proc"):
            raise ValueError(f"unknown cluster backend {backend!r}")
        return super().__new__(cls)

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
                 backend: str = "inproc"):
        if num_nodes < 2:
            raise ValueError("a cluster needs at least 2 nodes")
        self.num_nodes = num_nodes
        self.node_capacity = node_capacity
        self.page_size = page_size
        self.replication_factor = replication_factor
        self.policy = policy
        # admission knobs: ``admission=False`` restores the original
        # always-grant behavior (writers never throttle, placement never
        # re-routes) — the benchmark baseline. The deadline bounds how long
        # the scheduler waits for a refusing node before diverting a
        # reducer; the timeout bounds how long a paced writer waits for a
        # staging grant before it is forced through.
        self.admission = admission
        self.admission_deadline_s = admission_deadline_s
        self.admission_timeout_s = admission_timeout_s
        self.pressure_watermark = pressure_watermark
        self._spill_dir = spill_dir
        # durable tier: per-node page-log directories under
        # ``pagelog_dir``; not ported yet, so it must stay None
        _no_pagelog(pagelog_dir)
        self._pagelog_dir = pagelog_dir
        # durability-vs-throughput knob forwarded to every node's PageLog
        # (``core/pagelog.FSYNC_POLICIES``); "none" is the original behavior
        self._pagelog_fsync = pagelog_fsync
        # amplification threshold for background log compaction (None = off)
        self._pagelog_compact_threshold = pagelog_compact_threshold
        # stats must exist before the nodes: every node's page log stamps
        # its records with the cluster's topology/job event counter
        self.stats = StatisticsDB()
        self.nodes: Dict[int, StorageNode] = {
            n: StorageNode(n, node_capacity, self._node_spill_dir(n),
                           policy=policy,
                           pressure_watermark=pressure_watermark,
                           pagelog_dir=self._node_pagelog_dir(n),
                           epoch_fn=self.stats.current_epoch,
                           pagelog_fsync=pagelog_fsync,
                           pagelog_compact_threshold=pagelog_compact_threshold)
            for n in range(num_nodes)
        }
        # the manager/driver process's own memory authority: pure accounting
        # (no arena) for bytes staged driver-side — remesh streaming chunks,
        # loader prefetch windows. Its high-water marks are what the
        # O(page)-driver-memory guarantees are asserted against.
        self.driver_memory = MemoryManager(node_capacity, policy=policy)
        self.catalog: Dict[str, ShardedSet] = {}
        # paper-§7 conflicting-object guards (satellite bugfix):
        # (base_name, other_name) -> {conflicted node -> ConflictGuard}
        self.conflict_guards: Dict[Tuple[str, str],
                                   Dict[int, ConflictGuard]] = {}
        # durable blobs: plain (non-sharded) pool sets that live in a node's
        # page log — checkpoint streams, mostly. name -> (node_id, epoch);
        # the revival fence treats registered blobs as valid log state.
        self.durable_blobs: Dict[str, Tuple[int, int]] = {}
        self.scheduler = ClusterScheduler(self)
        self._transfer_workers = transfer_workers
        self._transfer: Optional[TransferEngine] = None
        self._acct_lock = tracked_lock("cluster.acct")
        self.net_bytes = 0          # bytes that crossed node boundaries
        self.local_bytes = 0        # bytes moved pool->pool on one node

    def _node_spill_dir(self, node_id: int) -> Optional[str]:
        if self._spill_dir is None:
            return None
        return f"{self._spill_dir}/node{node_id}"

    def _node_pagelog_dir(self, node_id: int) -> Optional[str]:
        if self._pagelog_dir is None:
            return None
        return f"{self._pagelog_dir}/node{node_id}"

    # -- membership -----------------------------------------------------------
    def node(self, node_id: int) -> StorageNode:
        node = self.nodes[node_id]
        if not node.alive:
            raise DeadNodeError(f"node {node_id} is down")
        return node

    def alive_node_ids(self) -> List[int]:
        return [n for n, node in self.nodes.items() if node.alive]

    def dead_node_ids(self) -> List[int]:
        return [n for n, node in self.nodes.items() if not node.alive]

    def kill_node(self, node_id: int) -> None:
        """Simulate a machine loss: the node's pool, spill store, and every
        locality set on it are gone. The memory manager deletes every spill
        image it wrote — a dead machine's local disk is gone with it, and
        leaving the files behind leaked them under a real ``spill_dir``."""
        node = self.nodes[node_id]
        node.alive = False
        if node.pool is not None:
            node.pool.memory.close()
        node.pool = None  # drop the arena; nothing on this node survives
        # topology event: recorded pressure snapshots are now stale
        self.stats.note_event()

    def revive_node(self, node_id: int,
                    warm: Optional[bool] = None) -> List[str]:
        """Bring a dead node's identity back up with a fresh pool. With the
        durable tier configured a *warm* revival (the default) reopens the
        node's local page log — replaying its index — and then fences it:
        replayed sets the catalog no longer names on this node, or whose
        cataloged epoch is newer than the log's (dropped or re-sharded while
        the node was dead), are purged rather than resurrected (satellite
        bugfix — the fence rides ``StatisticsDB.note_event``'s counter,
        stamped into every log record at write time). ``warm=False`` models
        losing the machine's disk along with it: the log directory is wiped
        before the pool reopens, so recovery must pull every byte from
        replicas — the cold baseline the benchmark measures against.
        Returns the fenced (purged) set names."""
        node = self.nodes[node_id]
        if node.alive:
            raise ValueError(f"node {node_id} is alive; nothing to revive")
        if warm is None:
            warm = self._pagelog_dir is not None
        log_dir = self._node_pagelog_dir(node_id)
        if not warm and log_dir is not None and os.path.isdir(log_dir):
            shutil.rmtree(log_dir, ignore_errors=True)
        node.revive()
        self.stats.note_event()  # topology event: node re-joined
        return self._fence_pagelog(node_id)

    def _fence_pagelog(self, node_id: int) -> List[str]:
        """Purge replayed page-log state that no longer describes the
        catalog. Valid log sets are the node's cataloged primaries, the
        replicas it holds for other owners, its conflict-guard copies, and
        registered durable blobs — each at the epoch the catalog stamped
        when the bytes were (re)written. Anything else in the replayed
        index is stale history from before the node died."""
        pool = self.nodes[node_id].pool
        log = pool.memory.pagelog if pool is not None else None
        if log is None:
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
        for guards in self.conflict_guards.values():
            for g in guards.values():
                if g.holder == node_id:
                    valid[g.set_name] = g.epoch
        for name, (nid, epoch) in self.durable_blobs.items():
            if nid == node_id:
                valid[name] = epoch
        fenced = [name for name in log.set_names()
                  if name not in valid or log.set_epoch(name) < valid[name]]
        for name in fenced:
            log.drop_set(name)
        return sorted(fenced)

    # -- durable blobs (checkpoint streams and other non-sharded log sets) ----
    def register_durable_blob(self, name: str, node_id: int) -> None:
        self.durable_blobs[name] = (node_id, self.stats.event_seq)

    def unregister_durable_blob(self, name: str) -> None:
        self.durable_blobs.pop(name, None)

    # -- byte accounting (thread-safe: pulls run on engine workers) -----------
    def add_net_bytes(self, n: int) -> None:
        with self._acct_lock:
            self.net_bytes += n

    def add_local_bytes(self, n: int) -> None:
        with self._acct_lock:
            self.local_bytes += n

    # -- node-to-node transfer path -------------------------------------------
    @property
    def transfer(self) -> TransferEngine:
        """The cluster's transfer engine, spawned on first use (its workers
        exit when idle, so short-lived clusters don't accumulate threads).
        With admission on, the engine caps in-flight bytes per destination
        node at the watermark-derived staging budget, so overlapped pulls
        can't stampede one reducer node."""
        if self._transfer is None:
            cap = (derive_staging_cap(self.node_capacity,
                                      self.pressure_watermark)
                   if self.admission else None)
            self._transfer = TransferEngine(self._transfer_workers,
                                            name="transfer",
                                            dest_inflight_cap=cap)
        return self._transfer

    def _stream_records(self, src_id: int, src_set: str, dst_id: int,
                        dst_set: str, dtype: np.dtype,
                        page_size: Optional[int] = None,
                        attrs: Optional[AttributeSet] = None) -> int:
        src = self.node(src_id)
        dst = self.node(dst_id)
        moved = copy_set(src.pool, src_set, dst.pool, dst_set, dtype,
                         page_size or self.page_size, attrs)
        if src_id == dst_id:
            self.add_local_bytes(moved)
        else:
            self.add_net_bytes(moved)
        return moved

    def transfer_records(self, src_id: int, src_set: str, dst_id: int,
                         dst_set: str, dtype: np.dtype,
                         page_size: Optional[int] = None,
                         attrs: Optional[AttributeSet] = None) -> int:
        """Stream one locality set between pools (the cluster's "network":
        ``transfer.copy_set`` under the engine). Returns bytes moved;
        cross-node bytes are tallied as network traffic, same-node as
        pool-local copies."""
        if threading.current_thread().name.startswith("transfer"):
            # already on an engine worker: run inline rather than submitting a
            # job we would then block on (a full pool of waiters would wedge)
            return self._stream_records(src_id, src_set, dst_id, dst_set,
                                        dtype, page_size, attrs)
        return self.transfer_records_async(src_id, src_set, dst_id, dst_set,
                                           dtype, page_size, attrs).result()

    def transfer_records_async(self, src_id: int, src_set: str, dst_id: int,
                               dst_set: str, dtype: np.dtype,
                               page_size: Optional[int] = None,
                               attrs: Optional[AttributeSet] = None):
        return self.transfer.submit(
            self._stream_records, src_id, src_set, dst_id, dst_set, dtype,
            page_size, attrs, label=f"{src_set}->{dst_set}")

    # -- raw byte blobs (serving KV slabs and other unsharded payloads) -------
    def store_bytes(self, node_id: int, name: str, data: bytes) -> int:
        """Land a raw byte blob as a uint8 locality set on one node
        (drop-before-rewrite: a same-name re-store replaces the old copy).
        The serving tier ships KV page slabs through this — on the proc
        backend the bytes live in the node's OS process, so replica copies
        genuinely survive a SIGKILL of the primary and genuinely die with
        their own node. Returns the bytes stored."""
        node = self.node(node_id)
        if name in node.pool.paging.sets:
            node.pool.drop_set(node.pool.get_set(name))
        recs = np.frombuffer(bytes(data), dtype=np.uint8)
        node.write_records(name, recs, np.dtype(np.uint8), self.page_size)
        return len(recs)

    def load_bytes(self, node_id: int, name: str) -> bytes:
        """Read a blob back (raises ``DeadNodeError`` for a dead holder,
        ``KeyError`` when the node never got the blob)."""
        node = self.node(node_id)
        if name not in node.pool.paging.sets:
            raise KeyError(name)
        return node.read_records(name, np.dtype(np.uint8)).tobytes()

    def drop_bytes(self, node_id: int, name: str) -> None:
        node = self.nodes[node_id]
        if (node.alive and node.pool is not None
                and name in node.pool.paging.sets):
            node.pool.drop_set(node.pool.get_set(name))

    def has_bytes(self, node_id: int, name: str) -> bool:
        node = self.nodes[node_id]
        return bool(node.alive and node.pool is not None
                    and name in node.pool.paging.sets)

    # -- sharded locality sets ------------------------------------------------
    def create_sharded_set(self, name: str, records: np.ndarray,
                           key_fn: Callable[[np.ndarray], np.ndarray],
                           partitions_per_node: int = 4,
                           page_size: Optional[int] = None,
                           replication_factor: Optional[int] = None,
                           attrs_factory: Optional[Callable[[], AttributeSet]] = None,
                           partition_key: Optional[str] = None,
                           node_ids: Optional[Sequence[int]] = None,
                           ) -> ShardedSet:
        """Hash-partition ``records`` across the placement domain (every alive
        node by default) and chain-replicate each shard (paper §7 applied at
        page level: the replica IS another locality set, just on a different
        node). ``partition_key`` names what the set is partitioned on (e.g.
        the key field) so ``stats.best_replica`` can match co-partitioned
        queries and skip their shuffles; it defaults to the set name, which
        never matches and preserves the always-shuffle behavior."""
        if name in self.catalog:
            raise ValueError(f"sharded set {name!r} already exists")
        factor = (self.replication_factor if replication_factor is None
                  else replication_factor)
        page_size = page_size or self.page_size
        domain = list(node_ids) if node_ids is not None else self.alive_node_ids()
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
            # durable tier configured: sharded user data is write-through by
            # default so its pages land in each node's page log and a killed
            # node can warm-start from its local index
            attrs_factory = user_data_attrs
        sset.attrs_factory = attrs_factory
        self._place_records(sset, records)
        self.catalog[name] = sset
        self.stats.register_replica(name, self._replica_info(sset))
        self.stats.note_event()  # job event: staging moved real bytes
        return sset

    def register_replica_set(self, logical_name: str,
                             sset: ShardedSet) -> None:
        """Register a sharded set as a heterogeneously partitioned replica of
        a logical dataset (paper §7 through the cluster pools): queries over
        ``logical_name`` may then be routed to whichever replica's
        partitioning matches (``scheduler.plan_aggregation``), e.g. a
        by-key replica making an aggregation shuffle-free.

        Carried bugfix: registration is now *symmetric* — the base
        set is equally a heterogeneous replica of ``sset``, so recovery can
        rebuild in either direction — and paper §7's *conflicting objects*
        are guarded: when the same node holds a shard under BOTH
        partitionings and neither set carries chain replicas, the records
        both schemes route to that node would die with it, leaving the
        factor-0 pair unable to rebuild each other. A guard copy of exactly
        those records is written to the ring successor at registration."""
        self.stats.register_replica(logical_name, self._replica_info(sset))
        base = self.catalog.get(logical_name)
        if base is None or base is sset or base.name == sset.name:
            return
        self.stats.register_replica(sset.name, self._replica_info(base))
        self._guard_conflicting_objects(base, sset)

    def _guard_conflicting_objects(self, base: ShardedSet,
                                   other: ShardedSet) -> None:
        """Write the paper-§7 conflicting-object guards for a factor-0 pair:
        for every node holding a shard of ``other`` that ``base`` also
        routes records to, copy exactly the records both partitionings place
        there to the node's ring successor. Chain replicas already cover the
        conflict when either set carries them, so guards are only needed
        when both factors are zero."""
        if base.replication_factor > 0 or other.replication_factor > 0:
            return
        pair = (base.name, other.name)
        guards = self.conflict_guards.setdefault(pair, {})
        domain = other.node_ids
        if len(domain) < 2:
            return
        for slot, n in enumerate(domain):
            if n in guards or n not in other.shards or n not in base.shards:
                continue
            recs = self.read_shard(other, n)
            if not len(recs):
                continue
            conflicts = recs[base.node_of_records(recs) == n]
            if not len(conflicts):
                continue
            hslot = replica_nodes(slot, len(domain), 1)[0]
            holder = domain[hslot]
            gname = f"{other.name}/conflict{n}@{holder}"
            attrs = other.attrs_factory() if other.attrs_factory else None
            self.node(holder).write_records(gname, conflicts, other.dtype,
                                            other.page_size, attrs)
            self.add_net_bytes(conflicts.nbytes)
            guards[n] = ConflictGuard(
                node=n, holder=holder, set_name=gname,
                num_records=len(conflicts),
                checksum=shard_checksum(conflicts),
                epoch=self.stats.event_seq)

    def conflict_guard(self, name_a: str, name_b: str,
                       node: int) -> Optional[ConflictGuard]:
        """The live guard for the (a, b) replica pair's conflict on
        ``node``, in either registration order, or None when no guard copy
        survives on an alive holder."""
        for pair in ((name_a, name_b), (name_b, name_a)):
            g = self.conflict_guards.get(pair, {}).get(node)
            if g is not None and self.scheduler._holds(g.holder, g.set_name):
                return g
        return None

    def _replica_info(self, sset: ShardedSet) -> ReplicaInfo:
        return ReplicaInfo(
            set_name=sset.name, partition_key=sset.partition_key,
            num_partitions=sset.scheme.num_partitions,
            num_nodes=len(sset.node_ids), page_size=sset.page_size,
            extra={"replication_factor": sset.replication_factor,
                   "node_ids": list(sset.node_ids)})

    def _place_records(self, sset: ShardedSet, records: np.ndarray) -> None:
        """Write primaries + chain replicas for ``records`` over the set's
        placement domain (shared by creation and remesh re-sharding; shard
        attributes come from the set's remembered ``attrs_factory``)."""
        domain = sset.node_ids
        slots = sset.scheme.node_of_records(records)
        order, counts, offsets = dispatch_plan(slots, len(domain))
        routed = records[order]
        for slot, nid in enumerate(domain):
            shard = routed[offsets[slot]:offsets[slot + 1]]
            attrs = sset.attrs_factory() if sset.attrs_factory else None
            self.node(nid).write_records(sset.primary_set_name(nid), shard,
                                         sset.dtype, sset.page_size, attrs)
            info = ShardInfo(node_id=nid, set_name=sset.primary_set_name(nid),
                             num_records=len(shard),
                             checksum=shard_checksum(shard),
                             content_checksum=record_content_checksum(shard),
                             epoch=self.stats.event_seq)
            for hslot in replica_nodes(slot, len(domain),
                                       sset.replication_factor):
                holder = domain[hslot]
                rep_name = sset.replica_set_name(nid, holder)
                # replicas inherit the shard attributes: a write-through
                # replica lands in its holder's page log too, so a revived
                # holder warm-starts the replicas it held
                rep_attrs = sset.attrs_factory() if sset.attrs_factory else None
                self.transfer_records(nid, info.set_name, holder, rep_name,
                                      sset.dtype, sset.page_size,
                                      attrs=rep_attrs)
                info.replicas.append((holder, rep_name))
            sset.shards[nid] = info

    def read_shard_from(self, sset: ShardedSet,
                        node_id: int) -> Tuple[int, np.ndarray]:
        """Read one shard, preferring the primary but falling back to any
        surviving replica whose CRC32 matches the catalog (so a dead node with
        intact replicas never fails a read). Returns ``(holder, records)``."""
        info = sset.shards[node_id]
        mismatches: List[str] = []
        for holder, set_name in self.scheduler.read_sources(sset, node_id):
            recs = self.nodes[holder].read_records(set_name, sset.dtype)
            if holder == node_id or shard_checksum(recs) == info.checksum:
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
        """Gather every shard, reading dead owners' shards from surviving
        replicas (raises DeadNodeError only when a shard has no verified copy
        left — exactly what recovery and remesh exist to prevent)."""
        parts = [self.read_shard(sset, n) for n in sorted(sset.shards)]
        return np.concatenate(parts) if parts else np.empty(0, sset.dtype)

    def _drop_physical(self, sset: ShardedSet) -> None:
        for n, info in sset.shards.items():
            node = self.nodes[n]
            if node.alive and info.set_name in node.pool.paging.sets:
                node.pool.drop_set(node.pool.get_set(info.set_name))
            for holder, rep_name in info.replicas:
                hnode = self.nodes[holder]
                if hnode.alive and rep_name in hnode.pool.paging.sets:
                    hnode.pool.drop_set(hnode.pool.get_set(rep_name))

    def drop_sharded_set(self, sset: ShardedSet) -> None:
        self._drop_physical(sset)
        self.catalog.pop(sset.name, None)
        # guards exist to rebuild this set (or its pair partner) — dropping
        # the set retires every pair it participates in
        for pair in [p for p in self.conflict_guards if sset.name in p]:
            for g in self.conflict_guards[pair].values():
                hnode = self.nodes[g.holder]
                if (hnode.alive and hnode.pool is not None
                        and g.set_name in hnode.pool.paging.sets):
                    hnode.pool.drop_set(hnode.pool.get_set(g.set_name))
            del self.conflict_guards[pair]
        # a dropped set's shards are gone everywhere: any log entries left
        # on dead nodes are fenced at revival because the catalog no longer
        # names them
        self.stats.note_event()

    # -- replica-based recovery (paper §7) ------------------------------------
    def _rebuild_shard_from_replica(self, sset: ShardedSet, shard_id: int,
                                    alt_name: str) -> Tuple[np.ndarray, int]:
        """Re-materialize a shard by re-running ``sset``'s partitioner over a
        heterogeneously partitioned replica of the same logical data
        (``core/replication.recover_target_shard`` — paper §7's recovery from
        a differently partitioned replica). Returns ``(records, net_bytes)``;
        record order differs from the original, so callers verify the
        order-independent ``content_checksum``."""
        alt = self.catalog[alt_name]
        slot = sset.node_ids.index(shard_id)
        src_shards: Dict = {}
        reservations = []
        moved = 0
        try:
            for i, n in enumerate(sorted(alt.shards)):
                try:
                    holder, recs = self.read_shard_from(alt, n)
                except DeadNodeError:
                    # paper-§7 conflicting objects (carried bugfix): the
                    # alt's shard on the failed node itself may have no
                    # surviving copy — both partitionings routed those
                    # records there. The guard copy written at registration
                    # holds exactly the records this rebuild needs from it
                    # (the ones ``sset`` routes to ``shard_id``); any other
                    # unreadable alt shard is a genuine loss.
                    guard = self.conflict_guard(sset.name, alt_name, n)
                    if guard is None or n != shard_id:
                        raise
                    holder = guard.holder
                    recs = self.node(holder).read_records(guard.set_name,
                                                          sset.dtype)
                    if shard_checksum(recs) != guard.checksum:
                        raise
                # string keys: no alt shard may be skipped as "the failed
                # node" — a dead owner's shard reaches us through a replica
                src_shards[f"alt{i}"] = recs
                # the rebuild gathers the whole alt set driver-side: charge
                # it, so recovery shows up in the same pressure accounting
                # as every other stager
                reservations.append(self.driver_memory.reserve(recs.nbytes))
                if holder != shard_id:
                    moved += recs.nbytes
            reg = ReplicaRegistration(
                source=DistributedSet(f"{alt_name}.rebuild-src", None,
                                      src_shards),
                target=DistributedSet(sset.name, sset.scheme, {}),
                scheme=sset.scheme)
            return recover_target_shard(reg, slot), moved
        finally:
            for res in reservations:
                res.release()

    def _recover_shard(self, sset: ShardedSet, info: ShardInfo, node_id: int,
                       report: RecoveryReport) -> bool:
        """Execute the scheduler's cheapest viable recovery source for one
        lost primary shard. A candidate that fails verification falls through
        to the next-cheapest one; returns False when every candidate is
        exhausted."""
        pool = self.nodes[node_id].pool
        for src in self.scheduler.recovery_plan(sset, node_id, node_id):
            if src.kind == "pagelog":
                # local-disk warm restore: adopt the replayed index
                # and stream-verify. A torn tail or stale image just falls
                # through to the next candidate — the log is best-effort,
                # replicas remain the durability truth.
                if self._warm_restore_set(node_id, info.set_name,
                                          sset.page_size, sset.dtype,
                                          info.checksum,
                                          self._shard_attrs(sset)):
                    report.sources[f"{sset.name}:{node_id}"] = "pagelog"
                    report.shards_recovered += 1
                    report.warm_shards += 1
                    return True
                continue
            if src.kind == "rebuild":
                rebuilt, moved = self._rebuild_shard_from_replica(
                    sset, node_id, src.replica_of)
                if record_content_checksum(rebuilt) != info.content_checksum:
                    report.checksum_failures.append(
                        f"{sset.name}: content mismatch rebuilding shard "
                        f"{node_id} from {src.replica_of}")
                    continue
                attrs = sset.attrs_factory() if sset.attrs_factory else None
                self.nodes[node_id].write_records(
                    info.set_name, rebuilt, sset.dtype, sset.page_size, attrs)
                self.add_net_bytes(moved)
                report.bytes_transferred += moved
                # the rebuilt order is the shard's new canonical layout:
                # re-key the order-exact CRC (and the epoch: the bytes were
                # just rewritten) and refresh surviving replicas
                info.checksum = shard_checksum(rebuilt)
                info.epoch = self.stats.event_seq
                for holder, rep_name in info.replicas:
                    hnode = self.nodes[holder]
                    if not hnode.alive:
                        continue
                    if rep_name in hnode.pool.paging.sets:
                        hnode.pool.drop_set(hnode.pool.get_set(rep_name))
                    report.bytes_transferred += self.transfer_records(
                        node_id, info.set_name, holder, rep_name, sset.dtype,
                        sset.page_size, attrs=self._shard_attrs(sset))
                report.sources[f"{sset.name}:{node_id}"] = \
                    f"rebuild<-{src.replica_of}"
                report.shards_recovered += 1
                return True
            # primary/replica: page-for-page copy, order-exact CRC check
            # (shard attrs ride along, so a cold-recovered primary is
            # write-through again and re-enters the durable tier)
            report.bytes_transferred += self.transfer_records(
                src.holder, src.set_name, node_id, info.set_name, sset.dtype,
                sset.page_size, attrs=self._shard_attrs(sset))
            rebuilt = self.read_shard(sset, node_id)
            if shard_checksum(rebuilt) != info.checksum:
                report.checksum_failures.append(
                    f"{sset.name}: checksum mismatch on shard {node_id} "
                    f"from {src.kind}@{src.holder}")
                pool.drop_set(pool.get_set(info.set_name))
                continue
            report.sources[f"{sset.name}:{node_id}"] = \
                f"{src.kind}@{src.holder}"
            report.shards_recovered += 1
            return True
        return False

    def _shard_attrs(self, sset: ShardedSet) -> Optional[AttributeSet]:
        return sset.attrs_factory() if sset.attrs_factory else None

    def _warm_restore_set(self, node_id: int, set_name: str, page_size: int,
                          dtype: np.dtype, expect_crc: int,
                          attrs: Optional[AttributeSet] = None) -> bool:
        """Adopt one set from the revived node's replayed page log and
        stream-verify its CRC against the catalog. The verify pass reads the
        page images straight out of the log file — sequential disk reads,
        no pool allocation — so adoption stays O(index) and the pages stay
        non-resident until something actually pins them. On mismatch (torn
        tail truncated a page, stale bytes) nothing is adopted and the
        caller falls through to a replica or rebuild source."""
        pool = self.nodes[node_id].pool
        log = pool.memory.pagelog if pool is not None else None
        if log is None or not log.entries_for(set_name):
            return False
        if set_name in pool.paging.sets:
            return True  # already adopted during this recovery
        columnar = (attrs is not None
                    and attrs.storage is StorageScheme.COLUMNAR)
        if not self._verify_log_crc(log, set_name, dtype, expect_crc,
                                    columnar=columnar):
            return False
        pool.adopt_durable_set(set_name, page_size, attrs)
        return True

    @staticmethod
    def _verify_log_crc(log, set_name: str, dtype: np.dtype,
                        expect: int, columnar: bool = False) -> bool:
        """CRC a set's record bytes directly from its durable-log page
        images (each payload is itself CRC-checked by ``PageLog.read``).
        Entries are visited in seq order — the same order adoption assigns
        page ids, so the byte stream matches ``_verify_set_crc``'s. The
        cataloged checksum is the row-major record CRC for *both* storage
        schemes, so columnar payloads are decoded block -> records before
        hashing (the layout is a pure function of dtype + page size, and a
        logged payload is a whole page image)."""
        itemsize = np.dtype(dtype).itemsize
        crc = 0
        try:
            for entry in log.entries_for(set_name):
                payload = log.read(set_name, entry.seq)
                if columnar:
                    layout = ColumnLayout.for_page(dtype, len(payload))
                    cols, n = read_block(np.frombuffer(payload, np.uint8),
                                         layout)
                    body = columns_to_records(cols, dtype, n).tobytes()
                else:
                    n = int(np.frombuffer(payload[:_HEADER], np.int64)[0])
                    body = payload[_HEADER:_HEADER + n * itemsize]
                    if len(body) != n * itemsize:
                        return False
                crc = zlib.crc32(body, crc)
        except (IOError, KeyError, ValueError):
            return False
        return (crc & 0xFFFFFFFF) == expect

    def recover_node(self, node_id: int) -> RecoveryReport:
        """Bring a fresh node up under the failed node's identity and rebuild
        its state through the buffer pools:

        1. the node revives (``revive_node``): with the durable tier its
           local page log is replayed and fenced, so the scheduler can cost
           "adopt it from local disk" against "pull replica bytes";
        2. every primary shard it owned is re-materialized from the *cheapest*
           source the scheduler can cost (``scheduler.recovery_plan``): the
           fenced local page log (CRC stream-verified, zero network bytes),
           a surviving chain replica (verified against the cataloged CRC32,
           ties broken toward the least memory-pressured holder), or — when
           no direct copy survives — a co-partitioned rebuild from a
           heterogeneously partitioned replica set (verified against the
           order-independent content checksum);
        3. every replica it held for other owners is warm-restored from the
           log when its image survives, else re-replicated from the (alive)
           primary, restoring the replication factor.
        """
        t0 = time.perf_counter()
        report = RecoveryReport(node_id=node_id)
        report.fenced_sets = self.revive_node(node_id)
        for sset in self.catalog.values():
            info = sset.shards.get(node_id)
            if info is not None:
                if not self._recover_shard(sset, info, node_id, report):
                    report.checksum_failures.append(
                        f"{sset.name}: no surviving replica of shard "
                        f"{node_id}")
            # replicas this node held for other owners
            for owner, oinfo in sset.shards.items():
                if owner == node_id:
                    continue
                for holder, rep_name in oinfo.replicas:
                    if holder != node_id:
                        continue
                    if self._warm_restore_set(node_id, rep_name,
                                              sset.page_size, sset.dtype,
                                              oinfo.checksum,
                                              self._shard_attrs(sset)):
                        report.warm_replicas += 1
                        report.replicas_rebuilt += 1
                        continue
                    report.bytes_transferred += self.transfer_records(
                        owner, oinfo.set_name, node_id, rep_name, sset.dtype,
                        sset.page_size, attrs=self._shard_attrs(sset))
                    rebuilt = self.nodes[node_id].read_records(rep_name,
                                                               sset.dtype)
                    if shard_checksum(rebuilt) != oinfo.checksum:
                        report.checksum_failures.append(
                            f"{sset.name}: checksum mismatch on replica of "
                            f"shard {owner} at {node_id}")
                    report.replicas_rebuilt += 1
        report.seconds = time.perf_counter() - t0
        return report

    # -- elastic degrade (ROADMAP follow-up: shrink instead of fail) ----------
    def _verify_set_crc(self, holder: int, set_name: str, dtype: np.dtype,
                        expect: int) -> bool:
        """Streaming CRC pass over a candidate source set before it feeds the
        remesh: one page pinned at a time, O(page) driver memory, no gather."""
        pool = self.nodes[holder].pool
        ls = pool.get_set(set_name)
        crc = 0
        for chunk in _iter_record_chunks(pool, ls, dtype):
            crc = zlib.crc32(np.ascontiguousarray(chunk).tobytes(), crc)
        return (crc & 0xFFFFFFFF) == expect

    def _remesh_set_gather(self, sset: ShardedSet, alive: List[int],
                           report: RemeshReport) -> bool:
        """The gather path: gather the whole set at the driver, re-place it.
        Kept as the reference implementation (the streaming path must produce
        byte-identical shards) — its driver reservation is the whole set."""
        try:
            records = self.read_sharded(sset)
        except DeadNodeError:
            return False
        base_net = self.net_bytes
        with self.driver_memory.reserve(records.nbytes):
            per_node, num_parts = remesh_partition_plan(
                sset.scheme.num_partitions, len(sset.node_ids), alive)
            self._drop_physical(sset)
            sset.node_ids = list(alive)
            sset.scheme = PartitionScheme(sset.scheme.name,
                                          sset.scheme.key_fn,
                                          num_parts, len(alive))
            sset.replication_factor = min(sset.replication_factor,
                                          len(alive) - 1)
            sset.shards = {}
            self._place_records(sset, records)
        report.bytes_transferred += self.net_bytes - base_net
        return True

    def _remesh_set_streaming(self, sset: ShardedSet, alive: List[int],
                              report: RemeshReport) -> bool:
        """Stream one sharded set shard-to-shard onto the survivors: every
        source shard is scanned page by page (scheduler-ranked, CRC-verified
        source), each page-sized chunk is routed by the new scheme and
        appended to per-destination sequential writers, and only that chunk
        is ever staged driver-side (charged to ``driver_memory.reserve`` so
        the O(page) claim is assertable). Per-destination CRC32 and content
        checksums accumulate as chunks land, so the new catalog entries are
        certified without ever materializing a shard at the driver."""
        # 1. pick (and for replicas, verify) a source for every old shard
        #    before writing anything, so a lost set stages no partial state
        sources: Dict[int, Tuple[int, str]] = {}
        for n in sorted(sset.shards):
            info = sset.shards[n]
            chosen = None
            for holder, set_name in self.scheduler.remesh_read_source(
                    sset, n, alive):
                if holder == n or self._verify_set_crc(
                        holder, set_name, sset.dtype, info.checksum):
                    chosen = (holder, set_name)
                    break
            if chosen is None:
                return False
            sources[n] = chosen
        # 2. stage new shards under remesh names, streaming chunk by chunk
        per_node, num_parts = remesh_partition_plan(
            sset.scheme.num_partitions, len(sset.node_ids), alive)
        new_scheme = PartitionScheme(sset.scheme.name, sset.scheme.key_fn,
                                     num_parts, len(alive))
        writers: Dict[int, object] = {}
        crc = {nid: 0 for nid in alive}
        content = {nid: 0 for nid in alive}
        counts = {nid: 0 for nid in alive}
        columnar = sharded_set_is_columnar(sset)
        for nid in alive:
            attrs = sset.attrs_factory() if sset.attrs_factory else None
            ls = self.node(nid).pool.create_set(
                f"{sset.name}/shard{nid}@remesh", sset.page_size, attrs)
            writer_cls = ColumnarWriter if columnar else SequentialWriter
            writers[nid] = writer_cls(self.node(nid).pool, ls, sset.dtype)
        base_net = self.net_bytes
        try:
            for n in sorted(sset.shards):
                holder, set_name = sources[n]
                src_pool = self.nodes[holder].pool
                ls_src = src_pool.get_set(set_name)
                for chunk in _iter_record_chunks(src_pool, ls_src,
                                                 sset.dtype):
                    # staged: the pinned chunk plus its routed copy below
                    with self.driver_memory.reserve(2 * chunk.nbytes):
                        slots = new_scheme.node_of_records(chunk)
                        order, _cnt, offsets = dispatch_plan(slots, len(alive))
                        routed = chunk[order]
                        for slot, nid in enumerate(alive):
                            sub = routed[offsets[slot]:offsets[slot + 1]]
                            if not len(sub):
                                continue
                            # pace the shard-to-shard stream against the
                            # destination survivor's admission grant — a
                            # pressured survivor throttles the remesh
                            # instead of being buried by it
                            reservation = None
                            if self.admission:
                                memory = self.nodes[nid].memory
                                if memory is not None:
                                    reservation = memory.try_reserve(
                                        sub.nbytes, urgency="required",
                                        timeout=self.admission_timeout_s)
                            try:
                                writers[nid].append_batch(sub)
                            finally:
                                if reservation is not None:
                                    reservation.release()
                            crc[nid] = zlib.crc32(
                                np.ascontiguousarray(sub).tobytes(), crc[nid])
                            content[nid] = combine_content_checksums(
                                [content[nid], record_content_checksum(sub)])
                            counts[nid] += len(sub)
                            if holder == nid:
                                self.add_local_bytes(sub.nbytes)
                            else:
                                self.add_net_bytes(sub.nbytes)
            for w in writers.values():
                w.close()
        except BaseException:
            # drop the staging sets so a failed stream (pool exhaustion on a
            # pressured survivor, a dying source) leaves the old layout
            # intact and a retried remesh doesn't trip over stale names
            for nid in alive:
                pool = self.nodes[nid].pool
                name = f"{sset.name}/shard{nid}@remesh"
                if pool is not None and name in pool.paging.sets:
                    pool.drop_set(pool.get_set(name))
            raise
        # 3. swap: drop the old layout, rename staging sets into place
        self._drop_physical(sset)
        sset.node_ids = list(alive)
        sset.scheme = new_scheme
        sset.replication_factor = min(sset.replication_factor,
                                      len(alive) - 1)
        sset.shards = {}
        for nid in alive:
            pool = self.node(nid).pool
            pool.rename_set(pool.get_set(f"{sset.name}/shard{nid}@remesh"),
                            sset.primary_set_name(nid))
            sset.shards[nid] = ShardInfo(
                node_id=nid, set_name=sset.primary_set_name(nid),
                num_records=counts[nid], checksum=crc[nid] & 0xFFFFFFFF,
                content_checksum=content[nid],
                epoch=self.stats.event_seq)
        # 4. chain replicas from the new primaries
        for slot, nid in enumerate(alive):
            info = sset.shards[nid]
            for hslot in replica_nodes(slot, len(alive),
                                       sset.replication_factor):
                holder = alive[hslot]
                rep_name = sset.replica_set_name(nid, holder)
                self.transfer_records(nid, info.set_name, holder, rep_name,
                                      sset.dtype, sset.page_size,
                                      attrs=self._shard_attrs(sset))
                info.replicas.append((holder, rep_name))
        report.bytes_transferred += self.net_bytes - base_net
        return True

    def remesh_degrade(self,
                       dead_nodes: Optional[Sequence[int]] = None,
                       streaming: bool = True) -> RemeshReport:
        """Unrecoverable node loss: no replacement machine will take the dead
        node's identity, so fall through to ``elastic.plan_remesh`` — shrink
        the membership to the survivors and re-partition every sharded set
        over it from the freshest surviving copies (primaries where alive,
        CRC-verified replicas where not). Sets with an unreadable shard are
        reported as ``lost`` rather than silently truncated. The set objects
        are updated in place, so existing handles stay valid.

        By default each set streams shard-to-shard in page-sized chunks
        (peak driver-side buffering O(page), asserted via the driver
        MemoryManager's reservation high-water mark); ``streaming=False``
        keeps the gather-at-driver path, which produces byte-identical
        shards at O(dataset) driver memory."""
        t0 = time.perf_counter()
        for n in (dead_nodes or ()):
            if self.nodes[n].alive:
                self.kill_node(n)
        dead = self.dead_node_ids()
        alive = surviving_node_ids(self.num_nodes, dead)
        if not alive:
            raise DeadNodeError("no surviving nodes to remesh onto")
        report = RemeshReport(
            dead_nodes=dead, node_ids=alive,
            plan=plan_remesh(self.num_nodes, dead, chips_per_host=1,
                             prefer_model=1),
            streamed=streaming)
        # measure THIS remesh's driver staging peak, not lifetime history
        self.driver_memory.reset_reserved_hwm()
        for name in sorted(self.catalog):
            sset = self.catalog[name]
            remesh_set = (self._remesh_set_streaming if streaming
                          else self._remesh_set_gather)
            if remesh_set(sset, alive, report):
                self.stats.update_replica(name, self._replica_info(sset))
                report.resharded.append(name)
            else:
                report.lost.append(name)
        report.driver_peak_bytes = self.driver_memory.reserved_hwm
        self.stats.note_event()  # topology event: membership + layout changed
        report.seconds = time.perf_counter() - t0
        return report

    # -- accounting -----------------------------------------------------------
    def memory_report(self) -> Dict[int, Dict[str, Dict[str, int]]]:
        return {n: node.pool.memory_report()
                for n, node in self.nodes.items() if node.alive}

    def pressure_report(self) -> Dict[int, Dict[str, float]]:
        """Every alive node's MemoryManager pressure snapshot, plus the
        driver's own staging accounting under key ``-1``."""
        rep = {n: node.memory.pressure_report()
               for n, node in self.nodes.items() if node.alive}
        rep[-1] = self.driver_memory.pressure_report()
        return rep

    def shuffle(self, name: str, num_reducers: int, dtype: np.dtype,
                page_size: Optional[int] = None,
                admission: Optional[bool] = None,
                columnar: bool = False,
                partition_fn: Optional[Callable[[np.ndarray],
                                                np.ndarray]] = None
                ) -> "ClusterShuffle":
        """Shuffle factory — the backend-neutral entry point (the proc
        backend exposes the same signature, so callers can hold a
        ``Cluster`` of either backend and not care)."""
        return ClusterShuffle(self, name, num_reducers, dtype,
                              page_size=page_size, admission=admission,
                              columnar=columnar, partition_fn=partition_fn)

    def shutdown(self) -> None:
        """Stop the transfer engine's workers (benchmarks that build many
        clusters call this; tests can rely on idle-exit instead)."""
        if self._transfer is not None:
            self._transfer.shutdown()
            self._transfer = None


# ---------------------------------------------------------------------------
# Distributed shuffle (paper §8 across nodes)
# ---------------------------------------------------------------------------
class ClusterShuffle:
    """Map-side: each node's ``ShuffleService`` writes one virtual shuffle
    buffer per *global* reducer into the node-local pool (concurrent-write
    job data). Reduce-side: reducer ``r`` pulls partition ``r`` from every map
    node through the transfer path, after which the map output's lifetime is
    ended and its pages dropped.

    Placement is the scheduler's: ``finish_maps`` publishes per-partition
    byte counts to the statistics DB, ``place_reducers_locally`` then pins
    each reducer to the byte-heaviest map node (default placement is the
    round-robin baseline over alive nodes). ``pull_async`` runs pulls as
    transfer-engine jobs so they overlap finalization and each other, and
    ``reexecute_stragglers`` re-runs a slow mapper's work on a node holding a
    replica of its shard."""

    def __init__(self, cluster: Cluster, name: str, num_reducers: int,
                 dtype: np.dtype, page_size: Optional[int] = None,
                 scheduler: Optional[ClusterScheduler] = None,
                 partition_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 admission: Optional[bool] = None,
                 columnar: bool = False):
        self.cluster = cluster
        self.name = name
        self.num_reducers = num_reducers
        self.dtype = np.dtype(dtype)
        self.page_size = page_size or cluster.page_size
        self.scheduler = scheduler or cluster.scheduler
        # columnar mode: map output lands in per-partition columnar
        # sets via the fused hash-partition + CRC pass (``map_columns``), the
        # reducer pull moves column blocks and re-verifies the chained
        # per-partition CRC32, and ``stream_partition`` yields ``(columns,
        # n)`` views instead of record arrays. The per-partition CRC chain
        # assumes one mapper thread per node (writers on one node interleave
        # block append order otherwise).
        self.columnar = columnar
        # keys -> reducer partition override; the join path routes a shuffled
        # side by the *stationary* side's storage scheme so matching keys
        # land on the nodes whose build shards already sit there
        self.partition_fn = partition_fn
        # admission control: map writers pace their job-data page
        # writes against the worker node's staging grant, reducer pulls pace
        # each staged chunk against the destination's grant, and placement
        # re-routes reducers whose planned node refuses admission past the
        # deadline. Defaults to the cluster-wide knob.
        self.admission = (cluster.admission if admission is None
                          else admission)
        self.placement: Optional[Dict[int, int]] = None
        # reducer -> (refused_node, placed_node) when admission diverted it
        self.diversions: Dict[int, Tuple[int, int]] = {}
        # (straggler, refused_holder, placed_holder) for every backup task
        # whose byte-local holder refused admission (carried bugfix)
        self.backup_diversions: List[Tuple[int, int, int]] = []
        self._services: Dict[int, ShuffleService] = {}
        self._svc_lock = tracked_lock("shuffle.svc")  # threaded mappers race creation
        self._pulled: Dict[int, Tuple[str, int]] = {}  # reducer -> (set, node)
        self._deferred_release: set = set()  # reducers whose map-side drop waits
        # worker node -> shard-map work items it performed, for straggler
        # re-execution: (sset, shard_id, key_fn, transform, batch)
        self._work: Dict[int, List[tuple]] = {}

    def reducer_node(self, reducer: int) -> int:
        if self.placement is not None and reducer in self.placement:
            return self.placement[reducer]
        alive = self.cluster.alive_node_ids()
        return alive[reducer % len(alive)]

    def assign_placement(self, placement: Dict[int, int]) -> None:
        self.placement = dict(placement)

    def place_reducers_locally(self) -> Dict[int, int]:
        """Adopt the scheduler's locality-aware placement (call after
        ``finish_maps`` — it needs the published byte statistics). With
        admission on, each reducer's chosen node must also admit the
        partition's landing bytes within the cluster's deadline; refused
        reducers are diverted to the next-best byte-locality candidate and
        the diversions recorded on ``self.diversions``."""
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

    def _service(self, node_id: int):
        with self._svc_lock:
            if node_id not in self._services:
                if self.columnar:
                    self._services[node_id] = ColumnarShuffleService(
                        self.cluster.node(node_id).pool,
                        f"{self.name}/map{node_id}", self.num_reducers,
                        self.dtype, page_size=self.page_size,
                        attrs_factory=columnar_job_data_attrs)
                else:
                    self._services[node_id] = ShuffleService(
                        self.cluster.node(node_id).pool,
                        f"{self.name}/map{node_id}", self.num_reducers,
                        self.dtype, page_size=self.page_size,
                        attrs_factory=job_data_attrs)
            return self._services[node_id]

    def partition_of_keys(self, keys: np.ndarray) -> np.ndarray:
        if self.partition_fn is not None:
            return self.partition_fn(keys)
        return reducer_hash(keys, self.num_reducers)

    def _paced_reservation(self, node_id: int, nbytes: int):
        """Admission-paced staging grant against ``node_id`` (None when
        admission is off or the node has no manager). Writers holding a
        grant proceed; writers without headroom block until peers release
        or the timeout forces them through — bounded in-flight bytes,
        never dropped records."""
        if not self.admission:
            return None
        node = self.cluster.nodes.get(node_id)
        memory = node.memory if node is not None else None
        if memory is None:
            return None
        return memory.try_reserve(
            nbytes, urgency="required",
            timeout=self.cluster.admission_timeout_s)

    def map_batch(self, node_id: int, records: np.ndarray,
                  key_fn: Callable[[np.ndarray], np.ndarray]) -> None:
        """Partition ``records`` on node ``node_id`` into its local virtual
        shuffle buffers, one contiguous slice per reducer (dispatch plan).
        The write is paced against the node's admission grant: concurrent
        mappers feeding one pressured node throttle instead of stampeding
        its pool."""
        if len(records) == 0:
            return
        if self.columnar:
            # row-API compatibility for columnar shuffles (straggler replay
            # re-feeds shard records through here): split once, then the
            # fused column path
            self.map_columns(node_id, records_to_columns(records),
                             len(records), key_fn(records))
            return
        parts = self.partition_of_keys(key_fn(records))
        order, counts, offsets = dispatch_plan(parts, self.num_reducers)
        routed = records[order]
        svc = self._service(node_id)
        # writer identity = (node, thread): concurrent mapper threads feeding
        # one node each get their own virtual shuffle buffers (the service
        # hands out disjoint small pages), so threaded map writers are safe
        worker = (node_id, threading.get_ident())
        reservation = self._paced_reservation(node_id, routed.nbytes)
        try:
            for r in range(self.num_reducers):
                chunk = routed[offsets[r]:offsets[r + 1]]
                if len(chunk):
                    svc.get_buffer(worker, r).add_batch(chunk)
        finally:
            if reservation is not None:
                reservation.release()

    def map_columns(self, node_id: int, columns: Dict[str, np.ndarray],
                    n: int, keys: np.ndarray) -> None:
        """Columnar map hot path: one fused hash-partition + gather +
        incremental-CRC pass (``core.columnar.fused_partition_crc``)
        routes a column batch, then each partition's contiguous column slice
        is memcpy'd into that reducer's column blocks — no row
        materialization anywhere on the map side. ``keys`` is the (view of
        the) key column the reducer hash runs over; a ``partition_fn``
        override (the join path's scheme routing) takes the unfused
        dispatch-plan route with the same chained CRC."""
        if not self.columnar:
            raise ValueError("map_columns requires columnar=True")
        if n == 0:
            return
        svc = self._service(node_id)
        worker = (node_id, threading.get_ident())
        nbytes = n * self.dtype.itemsize
        reservation = self._paced_reservation(node_id, nbytes)
        try:
            if self.partition_fn is None:
                # reducer hash -> narrow ids -> dispatch plan, then gather
                # each partition's rows STRAIGHT into its landing pages
                # (np.take with the page region as out) with the per-field
                # CRC chains run over the landed bytes — the fused pass with
                # zero intermediate copies (the ``fused_partition_crc``
                # kernel materializing a routed block serves the non-landing
                # callers and the roofline bench)
                h = route_partition_ids(keys, self.num_reducers)
                parts = (h.astype(np.uint8) if self.num_reducers <= 256
                         else h.astype(np.int64))
                order, counts, offsets = dispatch_plan(parts,
                                                       self.num_reducers)
                svc.add_gathered(worker, columns, order, offsets)
            else:
                parts = self.partition_fn(np.asarray(keys)[:n])
                order, counts, offsets = dispatch_plan(parts,
                                                       self.num_reducers)
                routed = {f: np.take(np.asarray(col)[:n], order, axis=0)
                          for f, col in columns.items()}
                for r in range(self.num_reducers):
                    lo, hi = int(offsets[r]), int(offsets[r + 1])
                    if hi > lo:
                        svc.partition_crcs[r] = columns_crc32(
                            routed, self.dtype, lo, hi,
                            svc.partition_crcs[r])
                svc.add_routed(worker, routed, offsets)
        finally:
            if reservation is not None:
                reservation.release()

    def map_shard(self, sset: ShardedSet, shard_id: int,
                  key_fn: Callable[[np.ndarray], np.ndarray],
                  transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                  batch: int = 65536,
                  key_field: Optional[str] = None) -> int:
        """Run the map side for one shard on the node that holds its bytes
        (the primary owner, or a replica holder when the owner is down).
        Returns the worker node id; the work item is remembered so a
        straggler's shards can be replayed elsewhere.

        Columnar fast path: when this shuffle is columnar, the shard's
        primary is alive and stored columnar, and no record transform is
        requested, blocks stream straight off the shard's pages into the
        fused ``map_columns`` pass — ``key_field`` names the key column so
        keys never require row materialization (without it the key batch is
        materialized per block through ``key_fn``, the rest still moves as
        columns)."""
        if self.columnar and transform is None:
            info = sset.shards[shard_id]
            node = self.cluster.nodes[info.node_id]
            if (node.alive and node.pool is not None
                    and info.set_name in node.pool.paging.sets):
                ls = node.pool.get_set(info.set_name)
                if is_columnar(ls):
                    total = 0
                    for cols, n in iter_column_blocks(node.pool, ls,
                                                      sset.dtype):
                        keys = (cols[key_field] if key_field is not None
                                else key_fn(columns_to_records(
                                    cols, sset.dtype, n)))
                        self.map_columns(info.node_id, cols, n, keys)
                        total += n
                    self._work.setdefault(info.node_id, []).append(
                        (sset, shard_id, key_fn, transform, batch, total))
                    return info.node_id
        worker, records = self.cluster.read_shard_from(sset, shard_id)
        if transform is not None:
            records = transform(records)
        for i in range(0, len(records), batch):
            self.map_batch(worker, records[i:i + batch], key_fn)
        self._work.setdefault(worker, []).append(
            (sset, shard_id, key_fn, transform, batch, len(records)))
        return worker

    def map_sharded(self, sset: ShardedSet,
                    key_fn: Callable[[np.ndarray], np.ndarray],
                    batch: int = 65536,
                    step_timer: Optional[StepTimer] = None) -> None:
        """Run the map side over every shard of a sharded set, reading
        through each holder's pool (sequential read service). With a
        ``step_timer``, per-shard map times feed the straggler detector
        (attributed to the node that executed the work, which for a dead
        owner's shard is its replica holder) and flagged mappers are
        re-executed from replica holders; a single map pass per host counts
        (``min_samples=1``)."""
        for n in sorted(sset.shards):
            t0 = time.perf_counter()
            worker = self.map_shard(sset, n, key_fn, batch=batch)
            if step_timer is not None:
                step_timer.record(worker, time.perf_counter() - t0)
        if step_timer is not None:
            self.reexecute_stragglers(step_timer.stragglers(min_samples=1))

    # -- straggler re-execution (ROADMAP follow-up) ---------------------------
    def discard_map_output(self, node_id: int) -> None:
        """Throw away everything node ``node_id`` mapped (its job-data pages
        are lifetime-ended and dropped) — the straggler's partial output must
        not double-count once a backup re-executes its shards."""
        svc = self._services.pop(node_id, None)
        if svc is None:
            return
        svc.finish_writes()
        for r in range(self.num_reducers):
            svc.release_partition(r)

    def reexecute_stragglers(self,
                             stragglers: Sequence[int]) -> List[Tuple[int, int]]:
        """Re-execute every shard a straggler mapped on a node that already
        holds a copy (``scheduler.backup_source``: the alive primary when the
        straggler was only a backup, else a replica holder — paper §7's
        backup tasks applied to execution). Call between the map phase and
        ``finish_maps`` — the byte statistics published at finalization then
        reflect the re-executed layout. The slow output stands (no discard)
        when a shard has no other surviving copy, or when the node's service
        holds records fed through the raw ``map_batch`` API (untracked work
        cannot be replayed, and dropping it would lose records). Returns
        ``[(straggler, backup), ...]``.

        With admission on, each backup's landing node is chosen through
        ``scheduler.backup_source_admitted`` (carried bugfix): the holder
        must admit the shard's re-execution bytes just like reducer
        placement admits a partition's, so a pressured replica holder is
        passed over for the next surviving copy; diversions are recorded on
        ``self.backup_diversions`` as ``(straggler, refused, placed)``."""
        redone: List[Tuple[int, int]] = []
        for s in stragglers:
            items = self._work.get(s)
            svc = self._services.get(s)
            if not items or svc is None:
                continue
            tracked = sum(it[5] for it in items)
            if sum(svc.partition_records) != tracked:
                continue  # mixed provenance: raw map_batch records present
            sources = []
            for (sset, shard_id, *_rest) in items:
                if self.admission:
                    src, diversion = self.scheduler.backup_source_admitted(
                        sset, shard_id, exclude=s,
                        deadline_s=self.cluster.admission_deadline_s)
                    if src is not None and diversion is not None:
                        self.backup_diversions.append((s,) + diversion)
                else:
                    src = self.scheduler.backup_source(sset, shard_id,
                                                       exclude=s)
                sources.append(src)
            if any(src is None for src in sources):
                continue  # nowhere else to run it; slow output stands
            self.discard_map_output(s)
            self._work.pop(s, None)
            for (sset, shard_id, key_fn, transform, batch, _n), \
                    (holder, set_name) in zip(items, sources):
                records = self.cluster.nodes[holder].read_records(
                    set_name, sset.dtype)
                if transform is not None:
                    records = transform(records)
                for i in range(0, len(records), batch):
                    self.map_batch(holder, records[i:i + batch], key_fn)
                self._work.setdefault(holder, []).append(
                    (sset, shard_id, key_fn, transform, batch, len(records)))
                redone.append((s, holder))
        return redone

    # -- map finalization ------------------------------------------------------
    def _finish_node(self, node_id: int, svc: ShuffleService) -> None:
        svc.finish_writes()
        for r in range(self.num_reducers):
            self.cluster.stats.record_shuffle_bytes(
                self.name, r, node_id, svc.partition_bytes[r])
        # publish the node's memory pressure alongside its byte counts: the
        # scheduler discounts locality on nodes already spilling (their map
        # output would fault back in page by page anyway)
        node = self.cluster.nodes[node_id]
        if node.memory is not None:
            self.cluster.stats.record_node_pressure(
                node_id, node.memory.pressure_score())

    def finish_maps(self) -> None:
        """Seal every map node's shuffle buffers and publish per-partition
        byte counts plus memory pressure to the statistics DB (the
        scheduler's placement inputs)."""
        for node_id, svc in sorted(self._services.items()):
            self._finish_node(node_id, svc)

    def finish_maps_async(self, engine: Optional[TransferEngine] = None) -> list:
        """Finalize each map node as an engine job; reducer pulls submitted
        ``after=`` these futures overlap finalization across nodes."""
        engine = engine or self.cluster.transfer
        return [engine.submit(self._finish_node, node_id, svc,
                              label=f"{self.name}/finish{node_id}")
                for node_id, svc in sorted(self._services.items())]

    # -- reduce-side pulls -----------------------------------------------------
    def pull(self, reducer: int) -> np.ndarray:
        """Reduce-side fetch: stream partition ``reducer`` from every map
        node into the reducer node's pool small-page by small-page (staging
        O(small page), charged to the destination's MemoryManager — never
        the whole partition, so a pull works even when the partition exceeds
        pool headroom), then release the map-side pages (lifetime ended —
        paper §6's cheapest victims). Spilled map output faults back in
        transparently as its pages are pinned.

        Columnar shuffles stage through ``pull_columns`` (raw block moves +
        CRC re-verification) and materialize rows only here, for the
        row-API consumer."""
        if self.columnar:
            cols, n = self.pull_columns(reducer)
            return columns_to_records(cols, self.dtype, n)
        dst_node = self.cluster.node(self.reducer_node(reducer))
        dst = dst_node.node_id
        reduce_set = f"{self.name}/reduce{reducer}"
        dst_pool = dst_node.pool
        ls = dst_pool.create_set(reduce_set, self.page_size, job_data_attrs())
        writer = SequentialWriter(dst_pool, ls, self.dtype)
        for node_id, svc in sorted(self._services.items()):
            for chunk in svc.iter_partition(reducer):
                # paced against the destination's grant (concurrent pulls
                # into one reducer node throttle each other); falls back to
                # the always-grant charge with admission off
                reservation = (self._paced_reservation(dst, chunk.nbytes)
                               or dst_node.memory.reserve(chunk.nbytes))
                try:
                    writer.append_batch(chunk)
                finally:
                    reservation.release()
                if node_id == dst:
                    self.cluster.add_local_bytes(chunk.nbytes)
                else:
                    self.cluster.add_net_bytes(chunk.nbytes)
            svc.release_partition(reducer)
        writer.close()
        self._pulled[reducer] = (reduce_set, dst)
        return dst_node.read_records(reduce_set, self.dtype)

    def pull_columns(self, reducer: int, materialize: bool = True,
                     verify: bool = True
                     ) -> Tuple[Dict[str, np.ndarray], int]:
        """Columnar reduce-side fetch: stream partition ``reducer``'s column
        blocks from every map node to the reducer's node (block moves — no
        per-record decode on either end), re-verifying each map node's
        chained per-partition per-field CRC32 as the blocks drain
        (byte-identical shuffle output is checked, not assumed; pass
        ``verify=False`` to skip the second CRC pass when the caller
        verifies the output itself). ``materialize=True`` additionally lands
        the blocks in a columnar reduce set on the reducer's node so the
        partition survives ``release``-then-reread; streaming consumers
        (the vectorized aggregate) pass ``False`` and read the returned
        arrays directly. Returns the partition as concatenated
        ``(columns, n)``."""
        if not self.columnar:
            raise ValueError("pull_columns requires columnar=True")
        dst_node = self.cluster.node(self.reducer_node(reducer))
        dst = dst_node.node_id
        writer = None
        reduce_set = None
        if materialize:
            reduce_set = f"{self.name}/reduce{reducer}"
            dst_pool = dst_node.pool
            ls = dst_pool.create_set(reduce_set, self.page_size,
                                     columnar_job_data_attrs())
            writer = ColumnarWriter(dst_pool, ls, self.dtype)
        services = sorted(self._services.items())
        # the services already know the partition's exact size: preallocate
        # the output columns once and charge admission once, instead of a
        # per-block copy + reserve + final concat
        total = sum(svc.partition_records[reducer] for _, svc in services)
        fields = _field_layout(self.dtype)
        out = {name: np.empty(total, fdt) for name, fdt, _, _ in fields}
        reservation = (self._paced_reservation(dst, total * self.dtype.itemsize)
                       or dst_node.memory.reserve(total * self.dtype.itemsize))
        # streaming fast path copies raw column bytes block -> out through
        # flat uint8 views (no per-block dtype view construction)
        out_flat = {name: out[name].view(np.uint8).reshape(-1)
                    for name, _, _, _ in fields}
        pos = 0
        local_bytes = net_bytes = 0
        layout = ColumnLayout.for_page(self.dtype, self.page_size)
        try:
            for node_id, svc in services:
                crcs = [0] * len(svc.partition_crcs[reducer]) if verify \
                    else None
                pos0 = pos
                ls = svc.partition_sets[reducer]
                pool = svc.pool
                ls.infer_from_service("sequential-read", pool.clock)
                for pid in sorted(ls.pages):
                    page = ls.pages[pid]
                    view = pool.pin(page)
                    try:
                        n = int(view[:8].view(np.int64)[0])
                        if not n:
                            continue
                        if writer is not None or verify:
                            cols, n = read_block(view, layout)
                            if writer is not None:
                                writer.append_columns(cols, n)
                            if verify:
                                columns_crc32(cols, self.dtype, 0, n, crcs)
                        for name, _, _, w in fields:
                            off = layout.field_offs[name]
                            out_flat[name][pos * w:(pos + n) * w] = \
                                view[off:off + n * w]
                        pos += n
                    finally:
                        pool.unpin(page)
                nbytes = (pos - pos0) * self.dtype.itemsize
                if node_id == dst:
                    local_bytes += nbytes
                else:
                    net_bytes += nbytes
                if verify and crcs != svc.partition_crcs[reducer]:
                    want = "/".join(f"{c:#010x}"
                                    for c in svc.partition_crcs[reducer])
                    got = "/".join(f"{c:#010x}" for c in crcs)
                    raise ValueError(
                        f"{self.name}: partition {reducer} bytes from map "
                        f"node {node_id} fail CRC re-verification "
                        f"({got} != {want})")
        except BaseException:
            # a failed verify must not strand a half-built reduce set on
            # the destination — drop it so the caller can re-pull once the
            # (still intact, release is deferred) map output is repaired
            if writer is not None:
                writer.close()
                dst_node.pool.drop_set(dst_node.pool.get_set(reduce_set))
            raise
        finally:
            reservation.release()
        if local_bytes:
            self.cluster.add_local_bytes(local_bytes)
        if net_bytes:
            self.cluster.add_net_bytes(net_bytes)
        if writer is not None:
            writer.close()
        # map-side release is deferred to ``release_reducer``: the drop
        # stays off the pull critical path, and a CRC failure above leaves
        # the map output intact for a re-pull.
        self._deferred_release.add(reducer)
        self._pulled[reducer] = (reduce_set, dst)
        return out, pos

    def pull_columns_async(self, reducer: int, after: Sequence = (),
                           materialize: bool = True, verify: bool = True):
        """``pull_async``'s columnar twin: submit ``pull_columns(reducer)``
        to the transfer engine with the same lazy destination/byte
        declarations."""
        return self.cluster.transfer.submit(
            self.pull_columns, reducer, materialize, verify, after=after,
            label=f"{self.name}/pull{reducer}",
            dest=lambda: self.reducer_node(reducer),
            nbytes=lambda: sum(self.cluster.stats.shuffle_partition_bytes(
                self.name, reducer).values()))

    def stream_partition(self, reducer: int, dst_node: int) -> Iterator:
        """Stream partition ``reducer`` straight off every map node's shuffle
        service, small-page by small-page, with byte accounting against
        ``dst_node`` as the consumer — no reducer-set staging at all. This is
        the join path's probe feed: chunks go directly into the join tables.
        Row shuffles yield record arrays; columnar shuffles yield
        ``(columns, n)`` block views. Yielded arrays are views valid only
        until the next iteration (copy to retain); call ``release_partition``
        once the consumer is done."""
        for node_id, svc in sorted(self._services.items()):
            for chunk in svc.iter_partition(reducer):
                if self.columnar:
                    nbytes = chunk[1] * self.dtype.itemsize
                else:
                    nbytes = chunk.nbytes
                if node_id == dst_node:
                    self.cluster.add_local_bytes(nbytes)
                else:
                    self.cluster.add_net_bytes(nbytes)
                yield chunk

    def release_partition(self, reducer: int) -> None:
        """End the map-side lifetime of one partition on every map node
        (what ``pull`` does implicitly; ``stream_partition`` consumers call
        it explicitly once their join/aggregate has drained the chunks)."""
        for svc in self._services.values():
            svc.release_partition(reducer)

    def pull_async(self, reducer: int, after: Sequence = ()):
        """Submit ``pull(reducer)`` to the transfer engine; returns its
        future. Safe to run concurrently with other pulls: the buffer pools
        are internally locked and each pull touches its own partition.
        The job declares its destination node and landing bytes (resolved
        lazily — placement may itself be a pending engine job), so the
        engine's per-destination cap keeps overlapped pulls from stampeding
        one reducer node."""
        return self.cluster.transfer.submit(
            self.pull, reducer, after=after, label=f"{self.name}/pull{reducer}",
            dest=lambda: self.reducer_node(reducer),
            nbytes=lambda: sum(self.cluster.stats.shuffle_partition_bytes(
                self.name, reducer).values()))

    def release_reducer(self, reducer: int) -> None:
        """Drop a pulled reduce partition once the reducer has consumed it
        (plus the map-side partition pages whose release ``pull_columns``
        deferred)."""
        if reducer in self._deferred_release:
            self._deferred_release.discard(reducer)
            self.release_partition(reducer)
        name, dst = self._pulled.pop(reducer, (None, None))
        if name is None:
            return
        pool = self.cluster.node(dst).pool
        if name in pool.paging.sets:
            ls = pool.get_set(name)
            ls.end_lifetime(pool.clock)
            pool.drop_set(ls)


# ---------------------------------------------------------------------------
# End-to-end hash aggregation (paper §9's Spark comparison)
# ---------------------------------------------------------------------------
def cluster_hash_aggregate(cluster: Cluster, sset: ShardedSet,
                           key_field: str, val_field: str,
                           num_reducers: Optional[int] = None,
                           num_root_partitions: int = 4,
                           hash_page_size: int = 1 << 16,
                           scheduler: Optional[ClusterScheduler] = None,
                           async_pull: bool = True,
                           step_timer: Optional[StepTimer] = None,
                           force_shuffle: bool = False,
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """SELECT key, SUM(val) GROUP BY key over a sharded set, scheduled by the
    ``ClusterScheduler``:

    * input already partitioned on ``key_field`` (``stats.best_replica``
      finds a co-partitioned replica) → the shuffle is elided: every shard is
      aggregated in the pool that holds it and the merge is disjoint; zero
      bytes cross the network (paper §9.2.2's co-partitioned result).
    * otherwise → map-side shuffle by key hash; reducer ``r`` is placed on
      the node holding the most map output for partition ``r``; pulls run as
      overlapped transfer-engine jobs (``async_pull=False`` forces the
      synchronous path — results are identical).

    Reducer outputs are disjoint by construction (keys are routed by hash),
    so the merge is a concatenate + sort.

    Columnar sharded sets take the vectorized hot path: the map side
    streams each shard's blocks and feeds ``{key, val}`` column *views*
    through the fused partition+CRC pass (zero row materialization), pulls
    move column blocks, and the reduce is a ``segment_sum`` (``np.unique`` +
    ``np.add.at``) instead of per-record open-addressing inserts. Note the
    float accumulation order differs from ``HashService`` (exact equality
    holds for integer-valued sums)."""
    scheduler = scheduler or cluster.scheduler
    num_reducers = num_reducers or cluster.num_nodes
    pair = HashService.PAIR_DTYPE
    plan = scheduler.plan_aggregation(sset, key_field)

    def to_pairs(records: np.ndarray) -> np.ndarray:
        out = np.empty(len(records), pair)
        out["key"] = records[key_field]
        out["val"] = records[val_field]
        return out

    def aggregate(node: StorageNode, tag, pulled: np.ndarray):
        hs = HashService(node.pool, f"{sset.name}.agg/hash{tag}",
                         num_root_partitions=num_root_partitions,
                         page_size=hash_page_size)
        if len(pulled):
            hs.insert(pulled["key"], pulled["val"])
        k, v = hs.finalize()
        hs.close()
        node.pool.drop_set(hs.ls)
        return k, v

    def shard_blocks_columnar(target: ShardedSet, n: int):
        """The shard's block iterator when its alive primary is columnar
        (the zero-materialization feed), else None (row/replica fallback)."""
        info = target.shards[n]
        node = cluster.nodes[info.node_id]
        if (node.alive and node.pool is not None
                and info.set_name in node.pool.paging.sets):
            ls = node.pool.get_set(info.set_name)
            if is_columnar(ls):
                return info.node_id, iter_column_blocks(node.pool, ls,
                                                        target.dtype)
        return None

    keys_out: List[np.ndarray] = []
    vals_out: List[np.ndarray] = []
    if plan.shuffle_free and not force_shuffle:
        # co-partitioned: same key -> same shard, so shard-local aggregation
        # is complete and the merge disjoint. net_bytes does not move. The
        # scheduler may have routed us to a by-key replica of the same
        # logical data (heterogeneous replicas, paper §7/§9.2.2).
        target = (cluster.catalog.get(plan.target_name, sset)
                  if plan.target_name else sset)
        for n in sorted(target.shards):
            blocks = shard_blocks_columnar(target, n)
            if blocks is not None:
                # vectorized shard-local reduce straight off the column
                # blocks — segment_sum per block, then one more merge pass
                # over the (tiny) per-block partials
                _holder, it = blocks
                pk: List[np.ndarray] = []
                pv: List[np.ndarray] = []
                for cols, cnt in it:
                    bk, bv = segment_sum(cols[key_field], cols[val_field])
                    pk.append(bk)
                    pv.append(bv)
                k, v = (segment_sum(np.concatenate(pk), np.concatenate(pv))
                        if pk else (np.empty(0, np.int64),
                                    np.empty(0, np.float64)))
            else:
                holder, shard = cluster.read_shard_from(target, n)
                k, v = aggregate(cluster.node(holder), f"local{n}",
                                 to_pairs(shard))
            keys_out.append(k)
            vals_out.append(v)
    else:
        columnar = sharded_set_is_columnar(sset)
        sh = ClusterShuffle(cluster, f"{sset.name}.agg", num_reducers, pair,
                            scheduler=scheduler, columnar=columnar)
        for n in sorted(sset.shards):
            t0 = time.perf_counter()
            blocks = shard_blocks_columnar(sset, n) if columnar else None
            if blocks is not None:
                # fused map over {key, val} column views of each block; the
                # block writer memcpys raw bytes, so the views must already
                # carry the pair dtype's field types (cast is a no-op when
                # they match — the common case)
                worker, it = blocks
                kdt = pair.fields["key"][0]
                vdt = pair.fields["val"][0]
                total = 0
                for cols, cnt in it:
                    kc, vc = cols[key_field], cols[val_field]
                    if kc.dtype != kdt:
                        kc = kc.astype(kdt)
                    if vc.dtype != vdt:
                        vc = vc.astype(vdt)
                    sh.map_columns(worker, {"key": kc, "val": vc}, cnt, kc)
                    total += cnt
                sh._work.setdefault(worker, []).append(
                    (sset, n, lambda p: p["key"], to_pairs, 65536, total))
            else:
                worker = sh.map_shard(sset, n, key_fn=lambda p: p["key"],
                                      transform=to_pairs)
            if step_timer is not None:
                step_timer.record(worker, time.perf_counter() - t0)
        if step_timer is not None:
            sh.reexecute_stragglers(step_timer.stragglers(min_samples=1))
        if columnar:
            # the reduce consumes the pulled columns in place — skip the
            # reduce-set materialization, keep the CRC re-verification
            puller = lambda r: sh.pull_columns(r, materialize=False)
            puller_async = lambda r, after: sh.pull_columns_async(
                r, after=after, materialize=False)
        else:
            puller = sh.pull
            puller_async = lambda r, after: sh.pull_async(r, after=after)
        if async_pull:
            engine = cluster.transfer
            fin = sh.finish_maps_async(engine)
            placed = engine.submit(sh.place_reducers_locally, after=fin,
                                   label=f"{sh.name}/place")
            futures = [puller_async(r, after=[placed])
                       for r in range(num_reducers)]
            pulls = (fut.result() for fut in futures)
        else:
            sh.finish_maps()
            sh.place_reducers_locally()
            pulls = (puller(r) for r in range(num_reducers))
        for r, pulled in enumerate(pulls):
            if columnar:
                cols, cnt = pulled
                k, v = segment_sum(cols["key"][:cnt], cols["val"][:cnt])
            else:
                node = cluster.node(sh.reducer_node(r))
                k, v = aggregate(node, r, pulled)
            sh.release_reducer(r)
            keys_out.append(k)
            vals_out.append(v)
        cluster.stats.clear_shuffle(sh.name)
    keys = np.concatenate(keys_out)
    vals = np.concatenate(vals_out)
    order = np.argsort(keys)
    return keys[order], vals[order]
