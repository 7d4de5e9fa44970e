"""Pangea core, as the port has it: locality sets, the unified buffer pool,
data-aware paging (Alg. 1 / Eq. 1), heterogeneous replication and the
pushed-down services and the durable page log (copies of the JAX package's
numpy modules), and the device KV page pool."""
from .attributes import (AttributeSet, CurrentOperation, DurabilityType,
                         EvictionStrategy, Lifetime, Location, ReadingPattern,
                         WritingPattern, eviction_ratio, select_strategy,
                         spilling_cost)
from .buffer_pool import BufferPool, PoolExhaustedError, SpillStore
from .kvcache import HBMExhaustedError, HostSlabStore, PagedKVCache, SeqState
from .locality_set import LocalitySet, Page
from .memory_manager import (AdmissionController, MemoryManager,
                             MemoryReservation, derive_staging_cap)
from .pagelog import PageLog
from .paging import PagingSystem, eviction_overhead
from .replication import (DistributedSet, PartitionScheme, ReplicaRegistration,
                          combine_content_checksums, expected_conflicts,
                          fail_node, partition_set, random_dispatch,
                          record_content_checksum, recover_source_shard,
                          recover_target_shard, register_replica,
                          replica_nodes, shard_checksum)
from .services import (HashService, JoinService, PageIterator,
                       SequentialWriter, ShuffleService, VirtualShuffleBuffer,
                       as_record_bytes, canonical_join_sort, from_record_bytes,
                       get_page_iterators, job_data_attrs, join_output_dtype,
                       join_records, join_service, read_all)
from .statistics import ReplicaInfo, StatisticsDB
from .tlsf import TLSF

__all__ = [
    "AdmissionController", "derive_staging_cap",
    "AttributeSet", "BufferPool", "CurrentOperation", "DistributedSet",
    "DurabilityType", "EvictionStrategy", "HBMExhaustedError", "HashService",
    "HostSlabStore",
    "Lifetime", "LocalitySet", "Location", "MemoryManager",
    "MemoryReservation", "Page", "PageLog", "PagedKVCache",
    "PageIterator", "PagingSystem", "PartitionScheme", "PoolExhaustedError",
    "ReadingPattern", "ReplicaInfo", "ReplicaRegistration", "SeqState",
    "SequentialWriter",
    "ShuffleService", "SpillStore", "StatisticsDB", "TLSF",
    "VirtualShuffleBuffer", "WritingPattern", "eviction_overhead",
    "eviction_ratio", "expected_conflicts", "fail_node", "get_page_iterators",
    "as_record_bytes", "from_record_bytes", "job_data_attrs", "JoinService",
    "canonical_join_sort", "join_output_dtype", "join_records",
    "join_service", "partition_set", "random_dispatch", "read_all",
    "replica_nodes", "shard_checksum", "record_content_checksum",
    "combine_content_checksums",
    "recover_source_shard", "recover_target_shard", "register_replica",
    "select_strategy", "spilling_cost",
]
