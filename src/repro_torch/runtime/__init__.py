"""The cluster runtime under the serving tier (copies of the JAX package's
numpy/stdlib modules) and the serving tier itself. ``runtime/join.py`` is
not ported yet."""
from .watchdog import CollectiveWatchdog, HostMonitor, StepTimer
from .elastic import plan_remesh, surviving_mesh_shape, surviving_node_ids
from .scheduler import AggregationPlan, ClusterScheduler, JoinPlan
from .transfer import TransferEngine, TransferError, TransferFuture, copy_set
from .cluster import (Cluster, ClusterShuffle, DeadNodeError, RecoveryReport,
                      RemeshReport, ShardInfo, ShardedSet, StorageNode,
                      cluster_hash_aggregate, dispatch_plan)
from .serving import (KVShard, ServingTier, Session, TieredSlabStore,
                      expected_page_slab, token_value)

__all__ = ["CollectiveWatchdog", "HostMonitor", "StepTimer", "plan_remesh",
           "surviving_mesh_shape", "surviving_node_ids", "AggregationPlan",
           "ClusterScheduler", "JoinPlan", "TransferEngine", "TransferError",
           "TransferFuture", "copy_set", "Cluster", "ClusterShuffle",
           "DeadNodeError", "RecoveryReport", "RemeshReport", "ShardInfo",
           "ShardedSet", "StorageNode", "cluster_hash_aggregate",
           "dispatch_plan", "KVShard", "ServingTier", "Session",
           "TieredSlabStore", "expected_page_slab", "token_value"]
