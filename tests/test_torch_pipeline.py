"""The port's data pipeline (``repro_torch.data.pipeline``) on the CPU.

Every test of the JAX package's ``tests/test_pipeline.py`` is mirrored here
on the port, with the pipeline cases of ``tests/test_cluster.py``
(``cluster_aggregate``, the sharded token dataset) and of
``tests/test_scheduler.py`` (the shuffle-free aggregate, the prefetching
loader over a lost node). The cross-package tests stage the same tokens
through both packages' pools and clusters and hold the batches, the spill
accounting and the aggregates together, byte for byte.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import BufferPool, PartitionScheme, StatisticsDB
from repro_torch.data.pipeline import (BatchLoader, DistributedBatchLoader,
                                       cluster_aggregate,
                                       register_dataset_replicas,
                                       synthetic_token_dataset,
                                       write_sharded_token_dataset)
from repro_torch.runtime import rpc as port_rpc
from repro_torch.runtime.cluster import Cluster

torch.set_num_threads(2)

PAIR = np.dtype([("key", np.int64), ("val", np.float64)])


@pytest.fixture(autouse=True)
def _port_isolation():
    port_rpc.reset_counters()
    yield


def _pairs(n, key_range, seed=0):
    rng = np.random.default_rng(seed)
    recs = np.zeros(n, PAIR)
    recs["key"] = rng.integers(0, key_range, n)
    recs["val"] = rng.random(n)
    return recs


def _cluster(replication_factor=1, cls=Cluster, **kw):
    kw.setdefault("node_capacity", 16 << 20)
    kw.setdefault("page_size", 1 << 16)
    return cls(4, replication_factor=replication_factor, **kw)


def _oracle(recs):
    uk, inv = np.unique(recs["key"], return_inverse=True)
    out = np.zeros(len(uk))
    np.add.at(out, inv, recs["val"])
    return uk, out


# -- tests/test_pipeline.py ----------------------------------------------------
def test_loader_batches_and_labels():
    pool = BufferPool(32 << 20)
    ds = synthetic_token_dataset(pool, "d", vocab=500, num_sequences=48,
                                 seq_len=16)
    batches = list(BatchLoader(ds, batch_size=16))
    assert len(batches) == 3
    for b in batches:
        assert b["tokens"].shape == (16, 16)
        assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()
        assert (b["labels"][:, -1] == -100).all()


def test_loader_through_spill():
    pool = BufferPool(1 << 20)
    ds = synthetic_token_dataset(pool, "big", vocab=500, num_sequences=4096,
                                 seq_len=64)
    assert pool.stats["spill_bytes"] > 0
    n = 0
    seen = set()
    for b in BatchLoader(ds, batch_size=128):
        n += len(b["tokens"])
        seen.add(int(b["tokens"][0, 0]))
    assert n == 4096


def test_dataset_replicas_registered_and_recoverable():
    stats = StatisticsDB()
    rec = np.zeros(5000, dtype=[("doc", np.int64), ("bucket", np.int64)])
    rec["doc"] = np.arange(5000)
    rec["bucket"] = np.arange(5000) % 7
    schemes = [PartitionScheme("doc", lambda r: r["doc"], 64, 8),
               PartitionScheme("bucket", lambda r: r["bucket"], 64, 8)]
    source, regs = register_dataset_replicas(stats, "corpus", rec, 8, schemes)
    assert len(stats.replicas_of("corpus")) == 3  # source + 2 replicas
    best = stats.best_replica("corpus", "bucket")
    assert best.set_name == "corpus_by_bucket"
    for reg in regs:
        assert reg.target.total_records() == 5000


# -- the pipeline cases of tests/test_cluster.py ----------------------------------
def test_pipeline_cluster_aggregate_cleans_up():
    cluster = _cluster()
    recs = _pairs(20_000, 500, seed=7)
    keys, vals = cluster_aggregate(cluster, "sales", recs, "key", "val")
    assert len(keys) == len(np.unique(recs["key"]))
    assert "sales" not in cluster.catalog
    for node in cluster.nodes.values():  # staged data dropped after the job
        assert not any(n.startswith("sales/") for n in node.pool.paging.sets)
    cluster.shutdown()


def test_sharded_token_dataset_roundtrip():
    cluster = _cluster()
    rng = np.random.default_rng(15)
    toks = rng.integers(0, 1000, (512, 32), dtype=np.int32)
    sset = write_sharded_token_dataset(cluster, "tok", toks)
    batches = list(DistributedBatchLoader(cluster, sset, batch_size=64))
    assert len(batches) == 8
    seen = np.concatenate([b["tokens"] for b in batches])
    assert np.array_equal(np.sort(seen[:, 0]), np.sort(toks[:, 0]))
    for b in batches:
        assert b["labels"].shape == b["tokens"].shape
        assert (b["labels"][:, -1] == -100).all()
        assert np.array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    cluster.shutdown()


# -- the pipeline cases of tests/test_scheduler.py --------------------------------
def test_pipeline_cluster_aggregate_is_shuffle_free_by_default():
    cluster = _cluster(replication_factor=0)
    recs = _pairs(15_000, 700, seed=5)
    keys, vals = cluster_aggregate(cluster, "s", recs, "key", "val")
    assert cluster.net_bytes == 0
    uk, oracle = _oracle(recs)
    assert np.array_equal(keys, uk)
    np.testing.assert_allclose(vals, oracle, rtol=1e-9)
    # and the shuffle path is still reachable on demand
    k2, v2 = cluster_aggregate(cluster, "s2", recs, "key", "val",
                               force_shuffle=True)
    assert cluster.net_bytes > 0
    np.testing.assert_allclose(v2, oracle, rtol=1e-9)
    cluster.shutdown()


def test_distributed_loader_prefetches_and_survives_node_loss():
    cluster = _cluster(replication_factor=1)
    rng = np.random.default_rng(16)
    toks = rng.integers(0, 1000, (512, 32), dtype=np.int32)
    sset = write_sharded_token_dataset(cluster, "tok", toks)
    cluster.kill_node(1)  # loader must read node 1's shard from its replica
    loader = DistributedBatchLoader(cluster, sset, batch_size=64, prefetch=2)
    batches = list(loader)
    assert len(batches) == 8
    seen = np.concatenate([b["tokens"] for b in batches])
    assert np.array_equal(np.sort(seen[:, 0]), np.sort(toks[:, 0]))
    cluster.shutdown()


# -- both packages side by side ------------------------------------------------------
@pytest.mark.parametrize("pool_bytes", [32 << 20, 1 << 20])
def test_loader_batches_and_pool_stats_equal_the_reference(pool_bytes):
    """The same synthetic dataset through both packages' pools (roomy, and
    small enough to spill): the same batches byte for byte and the same
    pool accounting."""
    from repro.core import BufferPool as RefBufferPool
    from repro.data.pipeline import BatchLoader as RefBatchLoader
    from repro.data.pipeline import \
        synthetic_token_dataset as ref_synthetic_token_dataset
    out = []
    for pool_cls, make, loader in (
            (BufferPool, synthetic_token_dataset, BatchLoader),
            (RefBufferPool, ref_synthetic_token_dataset, RefBatchLoader)):
        pool = pool_cls(pool_bytes)
        ds = make(pool, "t", vocab=1000, num_sequences=4096, seq_len=64,
                  seed=3)
        batches = [(b["tokens"].tobytes(), b["labels"].tobytes())
                   for b in loader(ds, batch_size=384, drop_last=False)]
        out.append((batches, dict(pool.stats)))
    assert out[0][0] == out[1][0]
    assert len(out[0][0]) == 11                  # 10 full batches + the rest
    assert out[0][1] == out[1][1]
    # write-through pages always persist; only the small pool evicts
    assert out[0][1]["spill_bytes"] > 0
    assert (out[0][1]["evictions"] > 0) == (pool_bytes == 1 << 20)


def test_cluster_pipelines_equal_the_reference():
    """``cluster_aggregate`` (co-partitioned and forced shuffle) and the
    sharded token dataset read back by ``DistributedBatchLoader`` over a lost
    node give the same results and move the same network bytes in both
    packages."""
    from repro.data.pipeline import \
        DistributedBatchLoader as RefDistributedBatchLoader
    from repro.data.pipeline import cluster_aggregate as ref_cluster_aggregate
    from repro.data.pipeline import \
        write_sharded_token_dataset as ref_write_sharded_token_dataset
    from repro.runtime.cluster import Cluster as RefCluster
    recs = _pairs(12_000, 600, seed=21)
    toks = np.random.default_rng(22).integers(0, 1000, (384, 16),
                                              dtype=np.int32)
    out = []
    for cls, aggregate, write, loader in (
            (Cluster, cluster_aggregate, write_sharded_token_dataset,
             DistributedBatchLoader),
            (RefCluster, ref_cluster_aggregate,
             ref_write_sharded_token_dataset, RefDistributedBatchLoader)):
        cluster = _cluster(cls=cls)
        k1, v1 = aggregate(cluster, "a", recs, "key", "val")
        net_co = cluster.net_bytes
        k2, v2 = aggregate(cluster, "b", recs, "key", "val",
                           force_shuffle=True)
        sset = write(cluster, "tok", toks)
        cluster.kill_node(2)
        batches = [b["tokens"].tobytes()
                   for b in loader(cluster, sset, batch_size=32)]
        out.append((k1.tobytes(), v1.tobytes(), net_co, k2.tobytes(),
                    v2.tobytes(), cluster.net_bytes, batches))
        cluster.shutdown()
    assert out[0] == out[1]
    assert out[0][5] > out[0][2]            # the forced shuffle moved bytes
    assert len(out[0][6]) == 12
