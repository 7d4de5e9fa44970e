"""Cluster quickstart on the PyTorch port: the paper's system in ~90 lines.

The script of examples/cluster_quickstart.py over ``repro_torch``: a 4-node
cluster, one unified buffer pool per node owned by its ``MemoryManager``; a
sharded locality set with chain replicas and a distributed hash
aggregation; a co-partitioned join that moves ZERO network bytes (paper
§9.2.2); the aggregation again over a columnar-scheme set, bit for bit;
a node killed and its shards recovered from replicas with checksums; and a
``backend="proc"`` shuffle (one OS process per node) that survives a
SIGKILL between map and reduce, then closes with nothing leaked.

The cluster runtime is host code (numpy pools, sockets, shared memory):
nothing of this script computes on the device. ``--device`` is resolved as
in the other examples, so a request for CUDA on a machine without it
raises; the node processes never touch CUDA.

  PYTHONPATH=src python examples/torch_cluster_quickstart.py --device cpu

It prints the JAX example's lines, then one JSON line of the numbers it
printed; ``main(argv)`` returns that dict.
"""
import argparse
import json

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.services import columnar_job_data_attrs
from repro_torch.data.pipeline import cluster_aggregate, cluster_join
from repro_torch.runtime.cluster import Cluster, cluster_hash_aggregate

REC = np.dtype([("key", np.int64), ("val", np.float64)])
ITEM = np.dtype([("key", np.int64), ("rid", np.int64), ("qty", np.float64)])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = dict(device=str(dev))
    cluster = Cluster(num_nodes=4, node_capacity=32 << 20,
                      page_size=1 << 17, replication_factor=1)

    rng = np.random.default_rng(0)
    records = np.zeros(200_000, REC)
    records["key"] = rng.integers(0, 5_000, len(records))
    records["val"] = rng.random(len(records))

    # --- distributed dataset + aggregation ---------------------------------
    sset = cluster.create_sharded_set("sales", records,
                                      key_fn=lambda r: r["key"])
    per_node = {n: info.num_records for n, info in sorted(sset.shards.items())}
    print(f"sharded {len(records)} records across 4 pools: {per_node}")

    keys, sums = cluster_aggregate(cluster, "sales_agg", records,
                                   "key", "val")
    print(f"group-by produced {len(keys)} groups; "
          f"shuffle moved {cluster.net_bytes / 1e6:.2f} MB across nodes")
    out.update(records=len(records),
               shard_records={str(n): c for n, c in per_node.items()},
               groups=len(keys), shuffle_net_bytes=cluster.net_bytes)

    # --- co-partitioned join: the scheduler moves NOTHING ------------------
    customers = np.zeros(5_000, REC)
    customers["key"] = np.arange(5_000)
    customers["val"] = rng.random(5_000)
    orders = np.zeros(60_000, ITEM)
    orders["key"] = rng.integers(0, 5_000, len(orders))
    orders["rid"] = np.arange(len(orders))
    orders["qty"] = rng.random(len(orders))
    base_net = cluster.net_bytes
    joined, report = cluster_join(cluster, "cust_orders",
                                  customers, orders, "key",
                                  replication_factor=0)
    assert report.shuffle_free and report.net_bytes == 0
    assert cluster.net_bytes == base_net           # zero bytes crossed nodes
    print(f"co-partitioned join matched {len(joined)} rows moving "
          f"{report.net_bytes} network bytes (plan: shuffle "
          f"{list(report.plan.shuffle_sides) or 'nothing'})")

    hwm = max(node.memory.pressure_report()["reserved_hwm"]
              for node in cluster.nodes.values())
    print(f"peak per-node staging during the join: {hwm / 1e3:.0f} KB "
          f"(reserve-charged, spills instead of OOM-ing when over budget)")
    out.update(joined_rows=len(joined), join_net_bytes=report.net_bytes,
               join_reserved_hwm_bytes=hwm)

    # --- columnar variant: same query, same bytes, vectorized kernels ------
    cents = np.zeros(len(records), REC)
    cents["key"] = records["key"]
    cents["val"] = np.floor(records["val"] * 100)
    row_k, row_v = cluster_aggregate(cluster, "sales_row", cents,
                                     "key", "val", force_shuffle=True)
    col_set = cluster.create_sharded_set(
        "sales_columnar", cents, key_fn=lambda r: r["key"],
        attrs_factory=columnar_job_data_attrs)
    col_k, col_v = cluster_hash_aggregate(cluster, col_set, "key", "val",
                                          force_shuffle=True)
    order = np.argsort(col_k)
    assert np.array_equal(row_k, col_k[order])
    assert np.array_equal(row_v, col_v[order])
    print(f"columnar aggregate over {len(cents)} records identical to the "
          f"row scheme ({len(col_k)} groups, bit-for-bit)")
    out.update(columnar_records=len(cents), columnar_groups=len(col_k))

    # --- kill a node, recover from replicas --------------------------------
    cluster.kill_node(2)
    survived = cluster.read_sharded(sset)  # scheduler reroutes dead-owner
    assert np.array_equal(np.sort(survived["key"]), np.sort(records["key"]))
    print("reads with node 2 down served from CRC-verified replicas")
    report = cluster.recover_node(2)
    assert report.ok, report.checksum_failures
    print(f"recovered node 2: {report.shards_recovered} shards, "
          f"{report.replicas_rebuilt} replicas re-replicated, "
          f"{report.bytes_transferred / 1e6:.2f} MB in "
          f"{report.seconds * 1e3:.1f} ms, checksums OK")
    out.update(shards_recovered=report.shards_recovered,
               replicas_rebuilt=report.replicas_rebuilt,
               recovery_bytes=report.bytes_transferred,
               recovery_ms=report.seconds * 1e3)

    restored = cluster.read_sharded(sset)
    assert np.array_equal(np.sort(restored["key"]), np.sort(records["key"]))
    print("restored dataset byte-identical to the original")
    cluster.shutdown()

    # --- the same API on real OS processes ---------------------------------
    proc = Cluster(num_nodes=4, backend="proc", node_capacity=32 << 20,
                   page_size=1 << 16, replication_factor=2)
    psset = proc.create_sharded_set("sales", records,
                                    key_fn=lambda r: r["key"])
    shuffle = proc.shuffle("agg", num_reducers=8, dtype=REC)
    shuffle.map_sharded(psset, key_field="key")
    shuffle.finish_maps()
    proc.kill_node(1)                    # SIGKILL, mid-shuffle
    shuffle.place_reducers_locally()
    drained = np.concatenate([shuffle.pull(r) for r in range(8)])
    assert np.array_equal(np.sort(drained, order=("key", "val")),
                          np.sort(records, order=("key", "val")))
    print("proc backend: node 1 SIGKILLed between map and reduce; "
          "replica re-execution drained a byte-identical shuffle")
    report = proc.close()
    assert report.ok, report
    print(f"proc backend closed clean: {len(report.orphan_processes)} "
          f"orphan processes, {len(report.leaked_segments)} leaked segments")
    out.update(proc_drained_records=len(drained),
               orphan_processes=len(report.orphan_processes),
               leaked_segments=len(report.leaked_segments))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
