"""Elastic scaling: after failures, pick the largest viable mesh from the
survivors and restart from checkpoint (restore is mesh-agnostic — shards are
reassembled then resharded to the new mesh's PartitionSpecs).

Copy of the JAX package's ``runtime/elastic.py``; nothing changes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def surviving_node_ids(total_hosts: int,
                       dead_hosts: Sequence[int]) -> List[int]:
    """The shrunk placement domain after unrecoverable losses: the alive node
    ids in order. Sharded sets are re-partitioned over exactly this list by
    the cluster's remesh-degrade path."""
    dead = set(dead_hosts)
    return [h for h in range(total_hosts) if h not in dead]


def remesh_partition_plan(old_num_partitions: int, old_domain_size: int,
                          survivors: Sequence[int]) -> Tuple[int, int]:
    """How a sharded set re-partitions onto the shrunk membership: keep the
    per-node partition density of the old layout, scaled to the survivor
    count. Returns ``(partitions_per_node, new_num_partitions)``."""
    per_node = max(1, old_num_partitions // max(1, old_domain_size))
    return per_node, per_node * len(survivors)


def surviving_mesh_shape(n_alive: int,
                         prefer_model: int = 16) -> Tuple[int, int]:
    """Largest (data, model) grid with model | prefer_model using <= n_alive
    chips. Keeps the model axis a power-of-two divisor of the preferred TP
    degree so checkpoint layouts stay divisible."""
    model = prefer_model
    while model > 1:
        data = n_alive // model
        if data >= 1:
            return (data, model)
        model //= 2
    return (max(n_alive, 1), 1)


def plan_remesh(total_hosts: int, dead_hosts: Sequence[int],
                chips_per_host: int = 4,
                prefer_model: int = 16) -> dict:
    """Failure-response plan: new mesh + which checkpoint layout to restore
    from + which dataset shards must be re-dispatched (the paper's recovery,
    at the training-runtime level)."""
    alive = total_hosts - len(set(dead_hosts))
    chips = alive * chips_per_host
    data, model = surviving_mesh_shape(chips, prefer_model)
    return {
        "alive_hosts": alive,
        "mesh_shape": (data, model),
        "utilized_chips": data * model,
        "idle_chips": chips - data * model,
        "restore_layout": "row" if data >= model else "col",
        "redispatch_shards": sorted(set(dead_hosts)),
    }
