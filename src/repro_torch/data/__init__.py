"""The data pipeline: token datasets staged through the buffer pool."""
from .pipeline import (BatchLoader, DistributedBatchLoader, TokenDataset,
                       cluster_aggregate, cluster_join,
                       register_dataset_replicas, synthetic_token_dataset,
                       token_record_dtype, user_data_attrs,
                       write_sharded_token_dataset, write_token_dataset)

__all__ = ["BatchLoader", "DistributedBatchLoader", "TokenDataset",
           "cluster_aggregate", "cluster_join", "register_dataset_replicas",
           "synthetic_token_dataset", "token_record_dtype", "user_data_attrs",
           "write_sharded_token_dataset", "write_token_dataset"]
