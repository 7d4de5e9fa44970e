"""The cluster runtime (copies of the JAX package's numpy/stdlib modules:
scheduling, transfer, the cluster, the distributed join) and the serving tier
on top of it."""
from .watchdog import CollectiveWatchdog, HostMonitor, StepTimer
from .elastic import plan_remesh, surviving_mesh_shape, surviving_node_ids
from .scheduler import AggregationPlan, ClusterScheduler, JoinPlan
from .transfer import TransferEngine, TransferError, TransferFuture, copy_set
from .cluster import (Cluster, ClusterShuffle, DeadNodeError, RecoveryReport,
                      RemeshReport, ShardInfo, ShardedSet, StorageNode,
                      cluster_hash_aggregate, dispatch_plan)
from .join import ClusterJoin, JoinReport, scheme_slot_of_keys
from .serving import (KVShard, ServingTier, Session, TieredSlabStore,
                      expected_page_slab, token_value)

__all__ = ["CollectiveWatchdog", "HostMonitor", "StepTimer", "plan_remesh",
           "surviving_mesh_shape", "surviving_node_ids", "AggregationPlan",
           "ClusterScheduler", "JoinPlan", "TransferEngine", "TransferError",
           "TransferFuture", "copy_set", "Cluster", "ClusterShuffle",
           "DeadNodeError", "RecoveryReport", "RemeshReport", "ShardInfo",
           "ShardedSet", "StorageNode", "cluster_hash_aggregate",
           "dispatch_plan", "ClusterJoin", "JoinReport",
           "scheme_slot_of_keys", "KVShard", "ServingTier", "Session",
           "TieredSlabStore", "expected_page_slab", "token_value"]
