"""Data pipeline = the sequential read/write service applied to training.

Tokenized shards are stored as locality-set pages in the unified buffer pool
(write-through user data, paper §3.1), optionally with heterogeneously
partitioned replicas (e.g. by length bucket) registered in the statistics
catalog. The loader stages batches through the pool — when the dataset
exceeds the pool budget, the data-aware paging policy (MRU for sequential
scans) decides residency, which is exactly the paper's Fig.-6/7 experiment.

Also hosts the straggler-mitigation hook: per-host shard ownership with
re-dispatch of a slow host's pending pages (runtime/ drives it).

Copy of the JAX package's ``data/pipeline.py`` over the port's own ``core``
and ``runtime`` (numpy and the standard library; no line of the logic
changes), so that the port's trainer stages its tokens through the port's
buffer pool. ``BatchLoader``'s wait for each batch is the program span
``pangea.data.fetch`` (``repro_torch.trace``).
"""
from __future__ import annotations

import threading
import queue
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import trace
from ..core.attributes import (AttributeSet, DurabilityType, ReadingPattern,
                               WritingPattern)
from ..core.buffer_pool import BufferPool
from ..core.locality_set import LocalitySet
from ..core.replication import (DistributedSet, PartitionScheme,
                                partition_set, random_dispatch,
                                register_replica)
from ..core.services import SequentialWriter, get_page_iterators
from ..core.statistics import ReplicaInfo, StatisticsDB


def user_data_attrs() -> AttributeSet:
    return AttributeSet(durability=DurabilityType.WRITE_THROUGH,
                        writing=WritingPattern.SEQUENTIAL_WRITE,
                        reading=ReadingPattern.SEQUENTIAL_READ)


@dataclass
class TokenDataset:
    """A tokenized dataset persisted as a locality set of sequence records."""

    pool: BufferPool
    ls: LocalitySet
    seq_len: int
    num_sequences: int

    @property
    def dtype(self) -> np.dtype:
        return np.dtype((np.int32, (self.seq_len,)))


def write_token_dataset(pool: BufferPool, name: str, tokens: np.ndarray,
                        page_size: int = 1 << 20) -> TokenDataset:
    """tokens: [N, seq_len] int32 -> write-through locality set."""
    n, seq_len = tokens.shape
    ls = pool.create_set(name, page_size, user_data_attrs())
    dt = np.dtype((np.int32, (seq_len,)))
    w = SequentialWriter(pool, ls, dt)
    w.append_batch(tokens.astype(np.int32))
    w.close()
    return TokenDataset(pool, ls, seq_len, n)


def synthetic_token_dataset(pool: BufferPool, name: str, *, vocab: int,
                            num_sequences: int, seq_len: int,
                            seed: int = 0) -> TokenDataset:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (num_sequences, seq_len), dtype=np.int32)
    return write_token_dataset(pool, name, toks)


class BatchLoader:
    """Sequential-read-service loader with background prefetch.

    Yields {"tokens": [B, T], "labels": [B, T]} numpy batches. The prefetch
    thread pulls pages through the buffer pool (pin → copy → unpin), so cold
    pages come back from the spill store transparently.
    """

    def __init__(self, ds: TokenDataset, batch_size: int,
                 num_workers: int = 1, prefetch: int = 2,
                 drop_last: bool = True, seed: Optional[int] = None):
        self.ds = ds
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.seed = seed

    def _record_stream(self) -> Iterator[np.ndarray]:
        its = get_page_iterators(self.ds.pool, self.ds.ls, self.ds.dtype,
                                 self.num_workers)
        for it in its:
            for recs in it:
                yield recs

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            buf: List[np.ndarray] = []
            have = 0
            try:
                for recs in self._record_stream():
                    buf.append(np.asarray(recs))
                    have += len(recs)
                    while have >= self.batch_size:
                        allr = np.concatenate(buf) if len(buf) > 1 else buf[0]
                        batch, rest = (allr[:self.batch_size],
                                       allr[self.batch_size:])
                        buf = [rest] if len(rest) else []
                        have = len(rest)
                        toks = batch
                        q.put({"tokens": toks,
                               "labels": np.concatenate(
                                   [toks[:, 1:],
                                    np.full((len(toks), 1), -100,
                                            np.int32)], axis=1)})
                if buf and not self.drop_last:
                    allr = np.concatenate(buf) if len(buf) > 1 else buf[0]
                    q.put({"tokens": allr,
                           "labels": np.concatenate(
                               [allr[:, 1:],
                                np.full((len(allr), 1), -100, np.int32)],
                               axis=1)})
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            # the consumer's wait for the pool's next batch
            with trace.span("pangea.data.fetch"):
                item = q.get()
            if item is stop:
                break
            yield item


# ---------------------------------------------------------------------------
# Heterogeneous dataset replicas (paper §7 applied to training data)
# ---------------------------------------------------------------------------
def register_dataset_replicas(
        stats: StatisticsDB, name: str, records: np.ndarray,
        num_nodes: int, schemes: Sequence[PartitionScheme]):
    """Partition a dataset under several schemes; register each replica and
    its conflicting-object guards. Training picks the replica co-partitioned
    with its sampling key (e.g. length buckets) via ``stats.best_replica``."""
    source = random_dispatch(name, records, num_nodes)
    stats.register_replica(name, ReplicaInfo(
        set_name=name, partition_key=None, num_partitions=num_nodes,
        num_nodes=num_nodes))
    regs = []
    for scheme in schemes:
        target = partition_set(source, f"{name}_by_{scheme.name}", scheme)
        regs.append(register_replica(source, target, scheme, stats, name))
    return source, regs


# ---------------------------------------------------------------------------
# Cluster-backed pipelines (runtime/cluster.py): the same staging path, but
# records live in N per-node buffer pools instead of one.
# ---------------------------------------------------------------------------
def token_record_dtype(seq_len: int) -> np.dtype:
    """Sequence records routed across the cluster by their id (stable hash
    placement regardless of content)."""
    return np.dtype([("seq_id", np.int64), ("tokens", np.int32, (seq_len,))])


def write_sharded_token_dataset(cluster, name: str, tokens: np.ndarray,
                                page_size: int = 1 << 18,
                                replication_factor: Optional[int] = None):
    """tokens: [N, seq_len] int32 -> a ShardedSet spread over every node's
    pool (with chain replicas when the cluster is configured for them)."""
    n, seq_len = tokens.shape
    recs = np.zeros(n, token_record_dtype(seq_len))
    recs["seq_id"] = np.arange(n)
    recs["tokens"] = tokens.astype(np.int32)
    return cluster.create_sharded_set(
        name, recs, key_fn=lambda r: r["seq_id"], page_size=page_size,
        replication_factor=replication_factor, partition_key="seq_id")


class DistributedBatchLoader:
    """Batch iterator over a sharded token dataset: streams each shard
    through the pool that holds it and yields the same {"tokens", "labels"}
    batches as the single-pool BatchLoader.

    Scheduler-driven: the shard read plan comes from the cluster
    scheduler (a dead owner's shard is read from a CRC-verified replica
    holder instead of failing), and up to ``prefetch`` shard reads run ahead
    as transfer-engine jobs, overlapping the consumer the way the
    single-pool ``BatchLoader``'s producer thread does."""

    def __init__(self, cluster, sset, batch_size: int, drop_last: bool = True,
                 prefetch: int = 2):
        self.cluster = cluster
        self.sset = sset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.prefetch = max(0, prefetch)

    def _read_reserved(self, node_id: int, cancelled: threading.Event):
        # charge the staged shard to the driver's MemoryManager while it sits
        # in the prefetch window, so loader pressure shows up in the same
        # high-water accounting as remesh streaming. ``cancelled`` is set
        # when the consumer abandons the stream: a worker still in flight
        # then skips (or immediately returns) its reservation, so nothing
        # can leak past the drain below.
        shard = self.cluster.read_shard(self.sset, node_id)
        if cancelled.is_set():
            return shard, None
        res = self.cluster.driver_memory.reserve(shard.nbytes)
        if cancelled.is_set():
            res.release()
            return shard, None
        return shard, res

    def _shard_stream(self) -> Iterator[np.ndarray]:
        # read_shard resolves each shard's source through the cluster
        # scheduler (primary, or a CRC-verified replica when the owner is
        # dead), so shard order is all the plan we need here
        order = sorted(self.sset.shards)
        cancelled = threading.Event()
        if self.prefetch == 0:
            for node_id in order:
                shard, res = self._read_reserved(node_id, cancelled)
                try:
                    yield shard
                finally:
                    if res is not None:
                        res.release()
            return
        engine = self.cluster.transfer
        window: List = []
        try:
            for node_id in order:
                window.append(engine.submit(self._read_reserved,
                                            node_id, cancelled,
                                            label=f"prefetch{node_id}"))
                if len(window) >= self.prefetch:
                    shard, res = window.pop(0).result()
                    try:
                        yield shard
                    finally:
                        if res is not None:
                            res.release()
            while window:
                shard, res = window.pop(0).result()
                try:
                    yield shard
                finally:
                    if res is not None:
                        res.release()
        finally:
            # consumer abandoned the iterator mid-stream: stop in-flight
            # workers from reserving, then release what already landed
            cancelled.set()
            for fut in window:
                try:
                    _shard, res = fut.result(timeout=30)
                except Exception:
                    continue
                if res is not None:
                    res.release()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        buf: List[np.ndarray] = []
        have = 0
        for shard in self._shard_stream():
            if len(shard) == 0:
                continue
            buf.append(shard["tokens"])
            have += len(shard)
            while have >= self.batch_size:
                allr = np.concatenate(buf) if len(buf) > 1 else buf[0]
                batch, rest = (allr[:self.batch_size],
                               allr[self.batch_size:])
                buf = [rest] if len(rest) else []
                have = len(rest)
                yield self._batch(batch)
        if have and not self.drop_last:
            allr = np.concatenate(buf) if len(buf) > 1 else buf[0]
            yield self._batch(allr)

    @staticmethod
    def _batch(toks: np.ndarray) -> Dict[str, np.ndarray]:
        labels = np.concatenate(
            [toks[:, 1:], np.full((len(toks), 1), -100, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}


def cluster_aggregate(cluster, name: str, records: np.ndarray,
                      key_field: str, val_field: str,
                      num_reducers: Optional[int] = None,
                      page_size: int = 1 << 18,
                      replication_factor: Optional[int] = None,
                      keep_dataset: bool = False,
                      partition_field: Optional[str] = None,
                      force_shuffle: bool = False):
    """The end-to-end hash-aggregation workload (paper §9's Spark
    comparison), driven through the cluster scheduler: stage ``records`` as a
    sharded locality set partitioned on ``partition_field`` (default: the
    aggregation key — the storage layer sees the query, so it stages the
    data co-partitioned and the scheduler elides the shuffle entirely, the
    paper's §9.2.2 result). Pass a different ``partition_field`` or
    ``force_shuffle=True`` to exercise the full shuffle path with
    locality-aware reducer placement. Returns ``(keys, summed_vals)`` sorted
    by key."""
    from ..runtime.cluster import cluster_hash_aggregate
    partition_field = partition_field or key_field
    sset = cluster.create_sharded_set(
        name, records, key_fn=lambda r: r[partition_field],
        page_size=page_size, replication_factor=replication_factor,
        partition_key=partition_field)
    try:
        return cluster_hash_aggregate(cluster, sset, key_field, val_field,
                                      num_reducers=num_reducers,
                                      force_shuffle=force_shuffle)
    finally:
        if not keep_dataset:
            cluster.drop_sharded_set(sset)


def cluster_join(cluster, name: str, build_records: np.ndarray,
                 probe_records: np.ndarray, key_field: str,
                 build_partition_field: Optional[str] = None,
                 probe_partition_field: Optional[str] = None,
                 page_size: int = 1 << 18,
                 replication_factor: Optional[int] = None,
                 keep_datasets: bool = False,
                 num_reducers: Optional[int] = None,
                 step_timer=None):
    """The end-to-end distributed equi-join (paper §9.2.2), driven through
    the cluster scheduler: stage both sides as sharded locality sets, then
    join on ``key_field`` moving only what the scheduler cannot prove is
    already in place.

    Both sides default to partitioning on the join key — the storage layer
    sees the query, stages the data co-partitioned, and the scheduler elides
    the shuffle entirely (``report.net_bytes == 0``, the paper's flagship
    result). Pass a different ``build_partition_field`` /
    ``probe_partition_field`` to stage a side non-co-partitioned: one
    non-co side shuffles *only that side* (routed by the co side's own
    scheme); both non-co shuffles both with byte-weighted, pressure-aware
    reducer placement. Straggler re-execution rides along via
    ``step_timer``, exactly as the aggregation path.

    Returns ``(records, report)``: the canonical-sorted joined records
    (byte-identical to the single-pool ``core.services.join_records``
    reference) and the ``runtime.join.JoinReport``."""
    from ..runtime.join import ClusterJoin

    def _staged(tag: str, records: np.ndarray, partition_field: str):
        return cluster.create_sharded_set(
            f"{name}.{tag}", records,
            key_fn=lambda r, f=partition_field: np.asarray(r[f]).astype(np.int64),
            page_size=page_size, replication_factor=replication_factor,
            partition_key=partition_field)

    build = _staged("build", build_records,
                    build_partition_field or key_field)
    probe = _staged("probe", probe_records,
                    probe_partition_field or key_field)
    try:
        return ClusterJoin(cluster, build, probe, key_field,
                           num_reducers=num_reducers,
                           step_timer=step_timer).execute()
    finally:
        if not keep_datasets:
            cluster.drop_sharded_set(build)
            cluster.drop_sharded_set(probe)
