"""Serving-tier quickstart on the PyTorch port: paged-KV decode over the
monolithic pool, with each shard's page pool on the GPU.

The script of examples/serving_quickstart.py over ``repro_torch``: a 4-node
cluster and a ``ServingTier`` on top of it. Sequences shard across nodes by
session affinity, prefills are admitted through the cluster's admission
front end, and each shard's ``PagedKVCache`` (its pool on ``--device``)
spills device -> host -> remote node as sequences outgrow their pages.
Mid-stream the node holding a session is killed: the session fails over
to its replica and keeps decoding, its committed KV pages byte-identical,
and no reservation leaks on any surviving node.

Decode attention over the restored pool runs twice: ``impl="xla"`` as the
JAX example calls it, and ``impl="kernel"``, the paged CUDA kernel with one
launch a shard (its plain version on a CPU pool); the two must agree
within 2e-5, the JAX package's paged tolerance.

  PYTHONPATH=src python examples/torch_serving_quickstart.py --device cpu

It prints the JAX example's lines, then one JSON line of the numbers it
printed; ``main(argv)`` returns that dict.
"""
import argparse
import json

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.runtime.cluster import Cluster
from repro_torch.runtime.serving import ServingTier

PAGED_TOL = 2e-5


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cluster = Cluster(num_nodes=4, node_capacity=8 << 20,
                      page_size=1 << 14, replication_factor=1,
                      admission=True)
    # 4 device slots + a 2 KiB host budget per shard: a long sequence pushes
    # slabs through all three spill levels
    tier = ServingTier(cluster, hbm_pages_per_node=4,
                       host_budget_bytes=2048, device=dev)

    # --- continuous-batching admission -------------------------------------
    plan = tier.admit({1: 10, 2: 6, 3: 8})
    homes = {s: sess.node for s, sess in sorted(tier.sessions.items())}
    print(f"admitted 3 sequences; session homes {homes}, "
          f"{len(plan.diversions)} diverted off pressured nodes")

    tier.decode([1, 2, 3], steps=8)
    shard = tier._shards[tier.sessions[1].node]
    print(f"decoded 8 steps/seq; spill stats on seq 1's shard: "
          f"{shard.store.stats}")
    spill = dict(shard.store.stats)

    # --- kill the primary mid-stream ---------------------------------------
    victim = tier.sessions[1].node
    pre = [s.copy() for s in tier.sequence_slabs(1)]
    pre_len = tier.sessions[1].length
    cluster.kill_node(victim)
    print(f"killed node {victim} (home of seq 1) mid-stream")

    tier.decode([1, 2, 3], steps=4)
    assert tier.stats["failovers"] >= 1
    now = tier.sequence_slabs(1)
    for k in range(pre_len // tier.page_tokens):
        assert now[k].tobytes() == pre[k].tobytes(), "KV page diverged"
    assert all(tier.verify(s) for s in (1, 2, 3))
    print(f"seq 1 resumed on node {tier.sessions[1].node}: committed pages "
          f"byte-identical, all sequences verify against the KV oracle")

    # --- attention over the restored pool ----------------------------------
    out = tier.attend([1, 2, 3], impl="xla")
    print(f"decode attention over the serving pool: "
          f"{sorted((s, v.shape) for s, v in out.items())}")
    shards = sorted({tier.sessions[s].node for s in (1, 2, 3)})
    kern = tier.attend([1, 2, 3], impl="kernel")
    err = max(float(np.abs(kern[s] - out[s]).max()) for s in out)
    assert err <= PAGED_TOL, f"attend: kernel vs xla {err} > {PAGED_TOL}"
    result = dict(device=str(dev), homes={str(s): n for s, n in homes.items()},
                  diverted=len(plan.diversions), spill_stats=spill,
                  killed=victim, resumed_on=tier.sessions[1].node,
                  failovers=tier.stats["failovers"],
                  attend_shapes={str(s): list(v.shape)
                                 for s, v in sorted(out.items())},
                  attend_shards=shards, attend_max_abs_err=err)

    for s in (1, 2, 3):
        tier.finish(s)
    for nid, rep in cluster.pressure_report().items():
        assert rep["reserved"] == 0, (nid, rep)
    tier.close()
    cluster.shutdown()
    print("clean: no leaked reservations on any surviving node")
    result["leaked_reservations"] = 0
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
