"""The port's scheduler-driven distributed equi-join
(``repro_torch.runtime.join``) on the CPU.

Every test of the JAX package's ``tests/test_join.py`` is mirrored here on
the port: a co-partitioned join moves 0 network bytes, a non-co join
shuffles only the non-co side, and every execution mode (forced build-side
spill, dead-owner replica reads, straggler re-execution) is byte-identical
to the single-pool ``join_records`` reference after the canonical sort.
Both packages stage the sides through their own
``data/pipeline.cluster_join``. The cross-package tests run the same joins
on both packages' clusters and hold the outputs byte for byte, and the
reports' bytes, together.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import BufferPool, SequentialWriter
from repro_torch.core.services import (JoinService, canonical_join_sort,
                                       join_output_dtype, join_records)
from repro_torch.data.pipeline import cluster_join
from repro_torch.runtime import rpc as port_rpc
from repro_torch.runtime.cluster import Cluster
from repro_torch.runtime.join import ClusterJoin, scheme_slot_of_keys
from repro_torch.runtime.watchdog import StepTimer

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_isolation():
    port_rpc.reset_counters()
    yield


BUILD = np.dtype([("key", np.int64), ("rid", np.int64), ("bval", np.float64)])
PROBE = np.dtype([("key", np.int64), ("rid", np.int64), ("pval", np.float64)])


def _records(dtype, n, key_range, seed=0, val_field="bval", zipf=None):
    rng = np.random.default_rng(seed)
    recs = np.zeros(n, dtype)
    if zipf is None:
        recs["key"] = rng.integers(0, key_range, n)
    else:
        recs["key"] = rng.zipf(zipf, n).astype(np.int64) % key_range
    recs["rid"] = np.arange(n)
    recs[val_field] = rng.random(n)
    return recs


def _sides(nb=4_000, np_=12_000, bkeys=1_500, pkeys=2_000, seed=0, zipf=None):
    build = _records(BUILD, nb, bkeys, seed=seed, val_field="bval", zipf=zipf)
    probe = _records(PROBE, np_, pkeys, seed=seed + 1, val_field="pval",
                     zipf=zipf)
    return build, probe


def _reference(brecs, precs):
    """Single-pool join over the same records — the byte-identity oracle."""
    pool = BufferPool(128 << 20)
    bls = pool.create_set("ref.b", 1 << 16)
    w = SequentialWriter(pool, bls, BUILD)
    if len(brecs):
        w.append_batch(brecs)
    w.close()
    pls = pool.create_set("ref.p", 1 << 16)
    w = SequentialWriter(pool, pls, PROBE)
    if len(precs):
        w.append_batch(precs)
    w.close()
    return join_records(pool, bls, pls, BUILD, PROBE, "key", "key")


def _oracle(brecs, precs):
    """Brute-force numpy join (independent of any pool machinery)."""
    out_dtype = join_output_dtype(BUILD, PROBE, "key", "key")
    rows = []
    for p in precs:
        for b in brecs[brecs["key"] == p["key"]]:
            rows.append((p["key"], b["rid"], b["bval"], p["rid"], p["pval"]))
    return canonical_join_sort(np.array(rows, out_dtype))


def _cluster(replication_factor=0, **kw):
    kw.setdefault("node_capacity", 32 << 20)
    kw.setdefault("page_size", 1 << 16)
    return Cluster(4, replication_factor=replication_factor, **kw)


# -- single-pool join service -------------------------------------------------
def test_join_service_matches_bruteforce_oracle():
    brecs, precs = _sides(nb=300, np_=900, bkeys=80, pkeys=120)
    ref = _reference(brecs, precs)
    oracle = _oracle(brecs, precs)
    assert ref.dtype == oracle.dtype
    assert ref.tobytes() == oracle.tobytes()


def test_join_records_empty_sides():
    brecs, precs = _sides(nb=200, np_=400)
    assert len(_reference(brecs[:0], precs)) == 0
    assert len(_reference(brecs, precs[:0])) == 0
    empty = _reference(brecs[:0], precs[:0])
    assert empty.dtype == join_output_dtype(BUILD, PROBE, "key", "key")


def test_join_service_build_spills_through_pool():
    """A build side several times the pool budget spills (pages evicted to
    the spill store) and probes fault the pages back — same answer."""
    pool = BufferPool(192 << 10, policy="data-aware")
    brecs, precs = _sides(nb=30_000, np_=2_000, bkeys=500, pkeys=500)
    js = JoinService(pool, "spilljoin", BUILD, PROBE, "key", "key",
                     page_size=1 << 13)
    for i in range(0, len(brecs), 4096):
        js.build_batch(brecs[i:i + 4096])
    js.finish_build()
    assert pool.spill.write_ops > 0          # the build did not fit
    out = canonical_join_sort(js.probe_batch(precs))
    js.close()
    assert out.tobytes() == _reference(brecs, precs).tobytes()


# -- plan_join ----------------------------------------------------------------
def test_plan_join_co_partitioned_elides_all_shuffles():
    cluster = _cluster()
    brecs, precs = _sides()
    b = cluster.create_sharded_set("b", brecs, key_fn=lambda r: r["key"],
                                   partition_key="key")
    p = cluster.create_sharded_set("p", precs, key_fn=lambda r: r["key"],
                                   partition_key="key")
    plan = cluster.scheduler.plan_join(b, p, "key")
    assert plan.shuffle_free and plan.shuffle_sides == ()


def test_plan_join_shuffles_only_the_non_co_side():
    cluster = _cluster()
    brecs, precs = _sides()
    b = cluster.create_sharded_set("b", brecs, key_fn=lambda r: r["key"],
                                   partition_key="key")
    p = cluster.create_sharded_set("p", precs, key_fn=lambda r: r["rid"],
                                   partition_key="rid")
    plan = cluster.scheduler.plan_join(b, p, "key")
    assert plan.shuffle_sides == ("probe",) and plan.anchor == "build"
    # and symmetrically when the probe side is the co one
    plan2 = cluster.scheduler.plan_join(p, b, "key")
    assert plan2.shuffle_sides == ("build",) and plan2.anchor == "probe"


def test_plan_join_misaligned_co_sides_move_only_the_smaller():
    """Both sides partitioned on the key but onto different layouts: the
    byte-heavier side anchors, the smaller one is re-shuffled to match."""
    cluster = _cluster()
    brecs, precs = _sides(nb=2_000, np_=12_000)
    small = cluster.create_sharded_set("small", brecs,
                                       key_fn=lambda r: r["key"],
                                       partition_key="key",
                                       node_ids=[0, 1])
    big = cluster.create_sharded_set("big", precs,
                                     key_fn=lambda r: r["key"],
                                     partition_key="key")
    plan = cluster.scheduler.plan_join(small, big, "key")
    assert plan.shuffle_sides == ("build",) and plan.anchor == "probe"


def test_scheme_slot_routing_matches_storage_placement():
    cluster = _cluster()
    brecs, _ = _sides()
    b = cluster.create_sharded_set("b", brecs, key_fn=lambda r: r["key"],
                                   partition_key="key")
    slots = scheme_slot_of_keys(brecs["key"], b.scheme)
    routed = np.asarray(b.node_ids)[slots]
    assert np.array_equal(routed, b.node_of_records(brecs))


# -- distributed execution vs the single-pool reference -----------------------
def test_co_partitioned_cluster_join_moves_zero_network_bytes():
    cluster = _cluster()
    brecs, precs = _sides()
    out, report = cluster_join(cluster, "j", brecs, precs, "key")
    assert report.shuffle_free
    assert report.net_bytes == 0
    assert cluster.net_bytes == 0
    assert out.tobytes() == _reference(brecs, precs).tobytes()


def test_one_side_join_shuffles_only_probe_bytes():
    cluster = _cluster()
    brecs, precs = _sides(zipf=1.3)
    out, report = cluster_join(cluster, "j", brecs, precs, "key",
                               probe_partition_field="rid")
    assert report.plan.shuffle_sides == ("probe",)
    assert set(report.shuffled_bytes) == {"probe"}   # build never moved
    assert report.shuffled_bytes["probe"] == len(precs) * PROBE.itemsize
    assert 0 < report.net_bytes <= report.shuffled_bytes["probe"]
    assert out.tobytes() == _reference(brecs, precs).tobytes()


def test_both_sides_shuffled_join_matches_reference():
    cluster = _cluster()
    brecs, precs = _sides(zipf=1.3)
    out, report = cluster_join(cluster, "j", brecs, precs, "key",
                               build_partition_field="rid",
                               probe_partition_field="rid")
    assert report.plan.shuffle_sides == ("build", "probe")
    assert set(report.shuffled_bytes) == {"build", "probe"}
    assert report.net_bytes > 0
    assert out.tobytes() == _reference(brecs, precs).tobytes()


def test_join_routes_through_registered_co_partitioned_replica():
    """A by-key replica registered for a non-co handle makes the join
    shuffle-free even when queried through the non-co set — the paper's
    'select a Pangea replica that is the best for the query'."""
    cluster = _cluster()
    brecs, precs = _sides()
    b = cluster.create_sharded_set("orders", brecs,
                                   key_fn=lambda r: r["rid"],
                                   partition_key="rid")
    by_key = cluster.create_sharded_set("orders_by_key", brecs,
                                        key_fn=lambda r: r["key"],
                                        partition_key="key")
    cluster.register_replica_set("orders", by_key)
    p = cluster.create_sharded_set("lineitems", precs,
                                   key_fn=lambda r: r["key"],
                                   partition_key="key")
    plan = cluster.scheduler.plan_join(b, p, "key")
    assert plan.shuffle_free and plan.build_name == "orders_by_key"
    base_net = cluster.net_bytes
    out, report = ClusterJoin(cluster, b, p, "key").execute()
    assert cluster.net_bytes == base_net
    assert out.tobytes() == _reference(brecs, precs).tobytes()


# -- edge cases ---------------------------------------------------------------
def test_join_empty_partitions_and_disjoint_keys():
    cluster = _cluster()
    brecs, precs = _sides(nb=40, np_=6_000, bkeys=8)
    precs["key"] += 1_000_000                 # no key overlaps the build side
    out, report = cluster_join(cluster, "j", brecs, precs, "key",
                               probe_partition_field="rid")
    assert len(out) == 0
    assert out.dtype == join_output_dtype(BUILD, PROBE, "key", "key")
    assert out.tobytes() == _reference(brecs, precs).tobytes()


def test_join_with_empty_build_side():
    cluster = _cluster()
    brecs, precs = _sides(nb=200, np_=3_000)
    out, _ = cluster_join(cluster, "j", brecs[:0], precs, "key")
    assert len(out) == 0
    out2, _ = cluster_join(cluster, "j2", brecs, precs[:0], "key")
    assert len(out2) == 0


def test_skewed_build_spill_still_byte_identical():
    """Zipf-skewed keys concentrate one node's build
    shard past its pool budget; the build spills through the eviction policy
    (no OOM) and the result is still byte-identical to the reference."""
    cluster = _cluster(node_capacity=192 << 10, page_size=1 << 13)
    brecs, precs = _sides(nb=30_000, np_=8_000, bkeys=64, pkeys=64, zipf=1.2)
    out, report = cluster_join(cluster, "j", brecs, precs, "key",
                               page_size=1 << 13)
    spills = sum(node.pool.spill.write_ops
                 for node in cluster.nodes.values() if node.alive)
    assert spills > 0                         # the build side really spilled
    assert out.tobytes() == _reference(brecs, precs).tobytes()


def test_join_through_dead_owner_replica():
    cluster = _cluster(replication_factor=1)
    brecs, precs = _sides()
    b = cluster.create_sharded_set("b", brecs, key_fn=lambda r: r["key"],
                                   partition_key="key")
    p = cluster.create_sharded_set("p", precs, key_fn=lambda r: r["key"],
                                   partition_key="key")
    cluster.kill_node(2)
    out, report = ClusterJoin(cluster, b, p, "key").execute()
    assert report.shuffle_free
    assert out.tobytes() == _reference(brecs, precs).tobytes()


def test_one_side_join_through_dead_owner_replica():
    cluster = _cluster(replication_factor=1)
    brecs, precs = _sides()
    b = cluster.create_sharded_set("b", brecs, key_fn=lambda r: r["key"],
                                   partition_key="key")
    p = cluster.create_sharded_set("p", precs, key_fn=lambda r: r["rid"],
                                   partition_key="rid")
    cluster.kill_node(1)
    out, report = ClusterJoin(cluster, b, p, "key").execute()
    assert report.plan.shuffle_sides == ("probe",)
    assert out.tobytes() == _reference(brecs, precs).tobytes()


def test_join_with_straggler_reexecution_matches_reference():
    cluster = _cluster(replication_factor=1)
    brecs, precs = _sides()
    timer = StepTimer(hosts=list(cluster.nodes), min_samples=1)
    for n in cluster.nodes:   # pre-bias the EWMA so node 0 is flagged
        for _ in range(8):
            timer.record(n, 20.0 if n == 0 else 1e-4)
    out, report = cluster_join(cluster, "j", brecs, precs, "key",
                               probe_partition_field="rid",
                               replication_factor=1, step_timer=timer)
    assert report.stragglers_redone            # work moved off the straggler
    assert all(s == 0 and b != 0 for s, b in report.stragglers_redone)
    assert out.tobytes() == _reference(brecs, precs).tobytes()


def test_both_sides_placement_uses_combined_byte_statistics():
    """place_join_reducers lands reducer r on the node with the most
    combined build+probe bytes — never worse than round-robin on the
    combined map."""
    cluster = _cluster()
    brecs, precs = _sides(nb=6_000, np_=18_000, zipf=1.3)
    b = cluster.create_sharded_set("b", brecs, key_fn=lambda r: r["rid"],
                                   partition_key="rid")
    p = cluster.create_sharded_set("p", precs, key_fn=lambda r: r["rid"],
                                   partition_key="rid")
    join = ClusterJoin(cluster, b, p, "key")
    out, report = join.execute()
    assert out.tobytes() == _reference(brecs, precs).tobytes()
    # moved bytes never exceed what a full both-sides shuffle of every
    # map-output byte would have cost
    total = sum(report.shuffled_bytes.values())
    assert report.net_bytes <= total


# -- the same joins on both packages' clusters -------------------------------------
@pytest.mark.parametrize("mode", ["co", "one_side", "both", "dead_owner"])
def test_join_output_and_report_equal_the_reference(mode):
    from repro.data.pipeline import cluster_join as ref_cluster_join
    from repro.runtime.cluster import Cluster as RefCluster
    brecs, precs = _sides(nb=2_000, np_=6_000, seed=5)
    fields = {"co": {}, "dead_owner": {},
              "one_side": {"probe_partition_field": "rid"},
              "both": {"build_partition_field": "rid",
                       "probe_partition_field": "rid"}}[mode]
    results = []
    for cls, join in ((Cluster, cluster_join),
                      (RefCluster, ref_cluster_join)):
        cluster = cls(4, replication_factor=1, node_capacity=32 << 20,
                      page_size=1 << 16)
        if mode == "dead_owner":
            cluster.kill_node(2)
        out, report = join(cluster, "j", brecs, precs, "key", **fields)
        results.append((out.dtype, out.tobytes(), report.net_bytes,
                        report.shuffled_bytes, report.build_rows,
                        report.probe_rows, report.output_rows,
                        report.plan.shuffle_sides, report.plan.anchor,
                        cluster.net_bytes))
        cluster.shutdown()
    assert results[0] == results[1]
    assert results[0][1] == _reference(brecs, precs).tobytes()
    if mode == "co":
        assert results[0][2] == 0
