"""Heterogeneous replication and recovery — paper §7.

Replicas of one logical dataset are kept under *different* partition schemes.
They do double duty:

* performance — a query picks the co-partitioned replica (no shuffle);
* fault tolerance — a lost node's pages of one replica are rebuilt by
  re-running the partitioner over the surviving pages of a *differently
  partitioned* replica.

The subtlety (paper §7): an object that lands on the same node in both the
source and target partitionings is a *conflicting object* — if that node dies,
neither copy survives. Conflicting objects are identified at partition time
and replicated separately to other nodes. For a random partitioning the
expected conflicting count is ``N/K`` (N objects, K nodes) — asserted by a
property test and reported by ``benchmarks/bench_recovery.py``.

This module operates on numpy record arrays per node. It is used three ways:
dataset shards (data pipeline), checkpoint tensor shards (checkpoint/), and
the paper-fidelity benchmarks.

Copy of the JAX package's ``core/replication.py``; nothing changes.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .statistics import ReplicaInfo, StatisticsDB

KeyFn = Callable[[np.ndarray], np.ndarray]  # records -> int64 keys


def _node_of(partition_ids: np.ndarray, num_partitions: int,
             num_nodes: int) -> np.ndarray:
    return partition_ids % num_nodes


def shard_checksum(records: np.ndarray) -> int:
    """CRC32 over a shard's raw record bytes. Recovery re-materializes shards
    page by page in primary order, so a byte-exact checksum match certifies
    the rebuilt shard (cluster runtime uses this after node recovery)."""
    return zlib.crc32(np.ascontiguousarray(records).tobytes()) & 0xFFFFFFFF


_CONTENT_MULT = np.uint64(0x9E3779B97F4A7C15)
_CONTENT_MIX = np.uint64(0xC2B2AE3D27D4EB4F)


def record_content_checksum(records: np.ndarray) -> int:
    """Order-independent, duplicate-sensitive 64-bit content fingerprint:
    the wrapping sum of per-record hashes. Because addition commutes, the
    fingerprint of a shard equals the sum of the fingerprints of any chunking
    of it — which is what lets the streaming remesh and the co-partitioned
    rebuild verify shards they assembled in a *different record order* than
    the original (``shard_checksum`` is order-exact and cannot)."""
    records = np.ascontiguousarray(records)
    n = len(records)
    if n == 0:
        return 0
    raw8 = records.view(np.uint8).reshape(n, -1)
    width = raw8.shape[1]
    # position-dependent odd multipliers (cumprod wraps mod 2**64)
    mults = np.full(width, _CONTENT_MULT, dtype=np.uint64)
    total = 0
    # fold in bounded chunks: the uint64 widening is 8x the record bytes, so
    # hashing a whole shard at once would cost ~16x its size in temporaries
    step = max(1, (1 << 20) // width)
    with np.errstate(over="ignore"):
        mults = np.cumprod(mults, dtype=np.uint64)
        for i in range(0, n, step):
            raw = raw8[i:i + step].astype(np.uint64)
            row = (raw * mults).sum(axis=1, dtype=np.uint64)
            row = (row ^ (row >> np.uint64(29))) * _CONTENT_MIX
            row ^= row >> np.uint64(32)
            total = (total + int(row.sum(dtype=np.uint64))) % (1 << 64)
    return total


def combine_content_checksums(parts: Sequence[int]) -> int:
    """Fingerprint of a concatenation/union from its chunks' fingerprints."""
    return int(sum(int(p) for p in parts) % (1 << 64))


def replica_nodes(node: int, num_nodes: int, factor: int) -> List[int]:
    """Chain placement: the ``factor`` replica holders for ``node``'s shard are
    the next distinct nodes in ring order — never the primary itself, so any
    single-node loss leaves at least one copy (paper §7's separate-node rule
    for conflicting objects, generalized to page-level shard replicas)."""
    if factor >= num_nodes:
        raise ValueError(f"replication factor {factor} needs more than "
                         f"{num_nodes} nodes")
    return [(node + 1 + r) % num_nodes for r in range(factor)]


@dataclass
class PartitionScheme:
    """A partitioner: key function + partition count + node mapping."""

    name: str
    key_fn: KeyFn
    num_partitions: int
    num_nodes: int

    def partition_of_keys(self, keys: np.ndarray) -> np.ndarray:
        """Partition id from bare int64 keys — the join path routes a
        shuffled side by the *other* side's scheme, whose key field may have
        a different name, so the hash must be reachable without records."""
        h = np.asarray(keys).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        return (h % np.uint64(self.num_partitions)).astype(np.int64)

    def partition_of(self, records: np.ndarray) -> np.ndarray:
        return self.partition_of_keys(self.key_fn(records))

    def slot_of_keys(self, keys: np.ndarray) -> np.ndarray:
        """Scheme slot (index into a sharded set's ``node_ids``) per key."""
        return _node_of(self.partition_of_keys(keys), self.num_partitions,
                        self.num_nodes)

    def node_of_records(self, records: np.ndarray) -> np.ndarray:
        return _node_of(self.partition_of(records), self.num_partitions,
                        self.num_nodes)


@dataclass
class DistributedSet:
    """A locality set's distributed view: records per node (host metadata of
    the real per-node page sets)."""

    name: str
    scheme: Optional[PartitionScheme]  # None = randomly dispatched source set
    shards: Dict[int, np.ndarray] = field(default_factory=dict)

    def total_records(self) -> int:
        return sum(len(v) for v in self.shards.values())

    def all_records(self) -> np.ndarray:
        parts = [self.shards[n] for n in sorted(self.shards)]
        return np.concatenate(parts) if parts else np.empty(0)


def random_dispatch(name: str, records: np.ndarray, num_nodes: int,
                    seed: int = 0) -> DistributedSet:
    """Create a randomly dispatched source set (paper: "the lineitem source
    set is a randomly dispatched set")."""
    rng = np.random.default_rng(seed)
    nodes = rng.integers(0, num_nodes, size=len(records))
    shards = {n: records[nodes == n] for n in range(num_nodes)}
    return DistributedSet(name, None, shards)


@dataclass
class ReplicaRegistration:
    source: DistributedSet
    target: DistributedSet
    scheme: PartitionScheme
    # conflicting objects, replicated onto OTHER nodes: guard_node -> records
    conflict_guards: Dict[int, np.ndarray] = field(default_factory=dict)
    num_conflicting: int = 0


def partition_set(source: DistributedSet, target_name: str,
                  scheme: PartitionScheme) -> DistributedSet:
    """The ``partitionSet`` API (paper §7): run the partitioner over the
    source to produce a target set placed by the scheme."""
    target_shards: Dict[int, List[np.ndarray]] = {n: [] for n in range(scheme.num_nodes)}
    for node, recs in source.shards.items():
        if len(recs) == 0:
            continue
        tnodes = scheme.node_of_records(recs)
        for tn in np.unique(tnodes):
            target_shards[int(tn)].append(recs[tnodes == tn])
    shards = {n: (np.concatenate(v) if v else source.all_records()[:0])
              for n, v in target_shards.items()}
    return DistributedSet(target_name, scheme, shards)


def register_replica(source: DistributedSet, target: DistributedSet,
                     scheme: PartitionScheme,
                     stats: Optional[StatisticsDB] = None,
                     logical_name: Optional[str] = None) -> ReplicaRegistration:
    """The ``registerReplica`` API: record the replica relationship AND
    identify + separately replicate conflicting objects (paper §7)."""
    reg = ReplicaRegistration(source, target, scheme)
    guards: Dict[int, List[np.ndarray]] = {}
    total_conflicts = 0
    num_nodes = scheme.num_nodes
    for node, recs in source.shards.items():
        if len(recs) == 0:
            continue
        tnodes = scheme.node_of_records(recs)
        conflict_mask = tnodes == node  # same node in source AND target
        conflicts = recs[conflict_mask]
        total_conflicts += len(conflicts)
        if len(conflicts):
            guard_node = replica_nodes(node, num_nodes, 1)[0]  # a different node
            guards.setdefault(guard_node, []).append(conflicts)
    reg.conflict_guards = {n: np.concatenate(v) for n, v in guards.items()}
    reg.num_conflicting = total_conflicts
    if stats is not None and logical_name is not None:
        stats.register_replica(logical_name, ReplicaInfo(
            set_name=target.name, partition_key=scheme.name,
            num_partitions=scheme.num_partitions, num_nodes=scheme.num_nodes))
    return reg


def fail_node(dset: DistributedSet, node: int) -> None:
    """Simulate a node crash: its shard of this set is lost."""
    if node in dset.shards:
        dset.shards[node] = dset.shards[node][:0]


def recover_target_shard(reg: ReplicaRegistration, failed_node: int) -> np.ndarray:
    """Rebuild the target set's lost shard (paper §7 recovery):

    1. surviving nodes re-run the registered partitioner over their remaining
       source pages, re-dispatching objects whose target node is the failed
       node's replacement (here: the same logical node id, restored);
    2. conflicting objects — lost in both layouts — come from the guard
       replicas.
    """
    scheme = reg.scheme
    pieces: List[np.ndarray] = []
    for node, recs in reg.source.shards.items():
        if node == failed_node or len(recs) == 0:
            continue  # failed node's source pages are gone too
        tnodes = scheme.node_of_records(recs)
        sel = recs[tnodes == failed_node]
        if len(sel):
            pieces.append(sel)
    # conflicting objects: replicated separately on guard nodes
    for guard_node, recs in reg.conflict_guards.items():
        if guard_node == failed_node or len(recs) == 0:
            continue
        tnodes = scheme.node_of_records(recs)
        sel = recs[tnodes == failed_node]
        if len(sel):
            pieces.append(sel)
    recovered = (np.concatenate(pieces) if pieces
                 else reg.source.all_records()[:0])
    reg.target.shards[failed_node] = recovered
    return recovered


def recover_source_shard(reg: ReplicaRegistration, failed_node: int,
                         source_placement: Callable[[np.ndarray], np.ndarray]
                         ) -> np.ndarray:
    """Rebuild the *source* set's lost shard from the target replica: every
    object of the target whose source placement was the failed node.

    ``source_placement`` maps records -> original source node (for a randomly
    dispatched source this must be a recorded dispatch map; for a partitioned
    source it is its scheme's node mapping).
    """
    pieces: List[np.ndarray] = []
    for node, recs in reg.target.shards.items():
        if node == failed_node or len(recs) == 0:
            continue
        snodes = source_placement(recs)
        sel = recs[snodes == failed_node]
        if len(sel):
            pieces.append(sel)
    for guard_node, recs in reg.conflict_guards.items():
        if guard_node == failed_node or len(recs) == 0:
            continue
        snodes = source_placement(recs)
        sel = recs[snodes == failed_node]
        if len(sel):
            pieces.append(sel)
    recovered = (np.concatenate(pieces) if pieces
                 else reg.target.all_records()[:0])
    reg.source.shards[failed_node] = recovered
    return recovered


def expected_conflicts(n_objects: int, n_nodes: int) -> float:
    """Paper §7: E[#conflicting] = N/K for a random source→target mapping."""
    return n_objects / n_nodes
