"""Pangea "statistics database" — paper §3.2 / §7 / §9.2.2.

The manager node's catalog: which locality sets exist, which replicas of each
logical dataset exist under which partition scheme, plus access statistics.
Query planners (and the checkpoint restorer) ask it for the replica whose
partitioning best matches an operation — the paper's "select a Pangea replica
that is the best for the query execution".

Copy of the JAX package's ``core/statistics.py``; nothing changes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class ReplicaInfo:
    set_name: str
    partition_key: Optional[str]      # None = randomly dispatched (source set)
    num_partitions: int
    num_nodes: int
    page_size: int = 0
    extra: dict = field(default_factory=dict)


class StatisticsDB:
    def __init__(self):
        # logical dataset -> list of physical replicas
        self._replicas: Dict[str, List[ReplicaInfo]] = {}
        self._access_counts: Dict[str, int] = {}
        # shuffle -> partition -> node -> bytes of map output held there
        # (the locality signal behind scheduler reducer placement)
        self._shuffle_bytes: Dict[str, Dict[int, Dict[int, int]]] = {}
        # node -> (memory pressure score in [0, 1], event seq at recording)
        # (published by the shuffle finalizer from each node's MemoryManager;
        # the scheduler penalizes placement onto nodes that are already
        # spilling). ``_event_seq`` counts topology/job boundaries — a score
        # recorded before the latest boundary is stale and schedulers fall
        # back to the node's live pressure (bugfix: back-to-back jobs
        # used to plan against the previous job's finalization snapshot).
        self._node_pressure: Dict[int, tuple] = {}
        self._event_seq = 0

    def register_replica(self, logical_name: str, info: ReplicaInfo) -> None:
        self._replicas.setdefault(logical_name, []).append(info)

    def update_replica(self, logical_name: str, info: ReplicaInfo) -> None:
        """Replace the registered entry with the same ``set_name`` (used when a
        set is re-sharded after an elastic remesh), or append if new."""
        replicas = self._replicas.setdefault(logical_name, [])
        for i, r in enumerate(replicas):
            if r.set_name == info.set_name:
                replicas[i] = info
                return
        replicas.append(info)

    # -- shuffle placement statistics (scheduler input) -----------------------
    def record_shuffle_bytes(self, shuffle: str, partition: int, node: int,
                             nbytes: int) -> None:
        """Record (idempotently) how many map-output bytes for ``partition``
        live on ``node``; re-recording after straggler re-execution simply
        overwrites the stale figure."""
        self._shuffle_bytes.setdefault(shuffle, {}) \
            .setdefault(partition, {})[node] = nbytes

    def shuffle_partition_bytes(self, shuffle: str,
                                partition: int) -> Dict[int, int]:
        return dict(self._shuffle_bytes.get(shuffle, {}).get(partition, {}))

    def total_shuffle_bytes(self, shuffle: str) -> int:
        return sum(b for part in self._shuffle_bytes.get(shuffle, {}).values()
                   for b in part.values())

    def clear_shuffle(self, shuffle: str) -> None:
        self._shuffle_bytes.pop(shuffle, None)
        # a finished job is an event boundary: its finalization-time pressure
        # snapshots no longer describe the cluster the next job plans against
        self.note_event()

    # -- topology/job event boundaries (pressure staleness) --------------------
    def note_event(self) -> None:
        """A topology or job event happened (node killed/recovered, set
        created/re-sharded, shuffle finished): previously recorded pressure
        snapshots are now stale."""
        self._event_seq += 1

    @property
    def event_seq(self) -> int:
        return self._event_seq

    def current_epoch(self) -> int:
        """Bound-method form of ``event_seq`` — handed to each node's page
        log as its ``epoch_fn``, so every durable log record is stamped with
        the topology/job event counter and replay can be fenced against the
        catalog (stale entries from before a drop/rebuild must not
        resurrect)."""
        return self._event_seq

    # -- per-node memory pressure (scheduler placement penalty) ----------------
    def record_node_pressure(self, node: int, score: float) -> None:
        self._node_pressure[node] = (max(0.0, min(1.0, float(score))),
                                     self._event_seq)

    def node_pressure(self, node: int) -> float:
        """Last recorded score regardless of age (freshness-agnostic view;
        placement uses ``node_pressure_fresh`` + a live fallback)."""
        return self._node_pressure.get(node, (0.0, 0))[0]

    def node_pressure_fresh(self, node: int) -> Optional[float]:
        """The recorded score, or None when it predates the last
        topology/job event (or was never recorded) — the caller should read
        the node's live ``MemoryManager.pressure_score()`` instead."""
        rec = self._node_pressure.get(node)
        if rec is None or rec[1] < self._event_seq:
            return None
        return rec[0]

    def node_pressure_map(self) -> Dict[int, float]:
        return {n: score for n, (score, _seq) in self._node_pressure.items()}

    def replicas_of(self, logical_name: str) -> List[ReplicaInfo]:
        return list(self._replicas.get(logical_name, []))

    def record_access(self, set_name: str) -> None:
        self._access_counts[set_name] = self._access_counts.get(set_name, 0) + 1

    def access_count(self, set_name: str) -> int:
        return self._access_counts.get(set_name, 0)

    def best_replica(self, logical_name: str,
                     desired_key: Optional[str]) -> Optional[ReplicaInfo]:
        """Pick the replica partitioned on ``desired_key`` if one exists
        (enables co-partitioned, shuffle-free joins — paper §9.2.2); fall back
        to any replica (source set first)."""
        replicas = self._replicas.get(logical_name, [])
        if not replicas:
            return None
        for r in replicas:
            if desired_key is not None and r.partition_key == desired_key:
                self.record_access(r.set_name)
                return r
        # prefer the unpartitioned source set as the generic fallback
        for r in replicas:
            if r.partition_key is None:
                self.record_access(r.set_name)
                return r
        self.record_access(replicas[0].set_name)
        return replicas[0]
