"""Scheduler-driven distributed equi-join — paper §9.2.2's flagship workload.

The monolithic-storage payoff in one operator: because the storage layer's
statistics database knows every replica's partitioning, the scheduler
(``ClusterScheduler.plan_join``) can prove which sides of a join do NOT need
to move:

* **co-partitioned** — both sides (or registered replicas of them) are
  partitioned on the join key onto the same layout: no shuffle at all, every
  node joins its own shard pair, ``net_bytes == 0``;
* **one side shuffled** — one side anchors the join in place; the other is
  routed by the *anchor's own storage scheme* (not the generic shuffle hash),
  so matching keys land exactly where the anchor's shards already sit;
* **both sides shuffled** — neither side is partitioned on the key; both
  repartition to a common hash layout and reducer placement follows the
  combined byte statistics with the usual memory-pressure discount.

Execution rides the existing machinery end to end: the moving side goes
through ``ClusterShuffle`` (map-side virtual shuffle buffers, straggler
re-execution from replica holders, dead owners read through CRC-verified
replicas), and the shuffled partitions stream partition-by-partition through
``ShuffleService.iter_partition`` directly into the single-node
``JoinService`` hash tables (``core/services.py``) — no reducer-set staging.
Build-side batches are reserve-charged against the executing node's
``MemoryManager``, so an over-capacity build spills through the pool's
eviction policy instead of OOM-ing, and probes fault the spilled build pages
back in transparently.

Results are canonical-sorted (``canonical_join_sort``), which makes every
execution mode byte-identical to the single-pool ``join_records`` reference.

Copy of the JAX package's ``runtime/join.py``; nothing changes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..core.columnar import iter_column_blocks
from ..core.services import JoinService, canonical_join_sort, is_columnar
from .scheduler import ClusterScheduler, JoinPlan
from .watchdog import StepTimer


def scheme_slot_of_keys(keys: np.ndarray, scheme) -> np.ndarray:
    """The scheme slot (index into a set's ``node_ids``) each join key routes
    to — lets a shuffled side be routed by the *other* side's partitioner
    even when its key field has a different name."""
    return scheme.slot_of_keys(keys)


@dataclass
class JoinReport:
    """What one distributed join did: the scheduler's plan plus the movement
    and pressure its execution actually caused."""

    plan: JoinPlan
    net_bytes: int = 0              # bytes this join moved across nodes
    shuffled_bytes: Dict[str, int] = field(default_factory=dict)  # per side
    build_rows: int = 0
    probe_rows: int = 0
    output_rows: int = 0
    stragglers_redone: List[Tuple[int, int]] = field(default_factory=list)
    # reducer -> (refused_node, placed_node): partitions whose byte-locality
    # node refused admission past the deadline and were re-routed
    diversions: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    seconds: float = 0.0

    @property
    def shuffle_free(self) -> bool:
        return self.plan.shuffle_free


def _batches(records: np.ndarray, batch: int = 65536) -> Iterator[np.ndarray]:
    for i in range(0, len(records), batch):
        yield records[i:i + batch]


class ClusterJoin:
    """Execute one equi-join over two sharded sets, as planned by the
    cluster scheduler. ``build``'s rows feed the hash tables, ``probe``'s
    rows stream through them; both dtypes must carry ``key_field``. The
    scheduler decides only *placement and movement* — roles never swap, so
    the output layout (and byte-identity with the single-pool reference) is
    independent of which plan executes."""

    def __init__(self, cluster, build, probe, key_field: str,
                 scheduler: Optional[ClusterScheduler] = None,
                 page_size: int = 1 << 16,
                 num_reducers: Optional[int] = None,
                 step_timer: Optional[StepTimer] = None,
                 batch: int = 65536):
        self.cluster = cluster
        self.build = build
        self.probe = probe
        self.key_field = key_field
        self.scheduler = scheduler or cluster.scheduler
        self.page_size = page_size
        self.num_reducers = num_reducers
        self.step_timer = step_timer
        self.batch = batch
        self._name = f"{build.name}-join-{probe.name}"

    # -- shared executor -------------------------------------------------------
    def _run_join(self, node, tag: str, build_dtype, probe_dtype,
                  build_chunks: Iterable, probe_chunks: Iterable) -> np.ndarray:
        """One node-local hash join: build chunks reserve-charged into pool
        pages (spillable), probe chunks streamed through the table. Chunks
        are polymorphic over the storage scheme: a record array goes
        through ``build_batch``/``probe_batch``, a ``(columns, n)`` block
        tuple through the columnar twins — probe blocks run the searchsorted
        match on the raw key column and gather output per column, with no
        probe-side row materialization."""
        js = JoinService(node.pool, f"{self._name}/tbl{tag}", build_dtype,
                         probe_dtype, self.key_field, self.key_field,
                         page_size=self.page_size)
        for chunk in build_chunks:
            if isinstance(chunk, tuple):
                cols, n = chunk
                with node.memory.reserve(n * js.build_dtype.itemsize):
                    js.build_columns(cols, n)
            else:
                with node.memory.reserve(chunk.nbytes):
                    js.build_batch(chunk)
        js.finish_build()
        outs = []
        for chunk in probe_chunks:
            if isinstance(chunk, tuple):
                cols, n = chunk
                with node.memory.reserve(n * js.probe_dtype.itemsize):
                    out = js.probe_columns(cols, n)
            else:
                with node.memory.reserve(chunk.nbytes):
                    out = js.probe_batch(chunk)
            if len(out):
                outs.append(out)
        empty = np.empty(0, js.out_dtype)
        js.close()
        return np.concatenate(outs) if outs else empty

    def _map_moving_side(self, sh, sset, report: JoinReport) -> None:
        """The aggregation path's map side, verbatim: each shard maps on the
        node holding its bytes (replica holders for dead owners), per-shard
        times feed the straggler detector, and flagged mappers re-execute
        from replica holders before byte statistics are published. On a
        columnar shuffle, ``key_field`` routes each shard's blocks through
        the fused partition+CRC pass without materializing rows."""
        for n in sorted(sset.shards):
            t0 = time.perf_counter()
            worker = sh.map_shard(sset, n,
                                  key_fn=lambda r: r[self.key_field],
                                  key_field=self.key_field)
            if self.step_timer is not None:
                self.step_timer.record(worker, time.perf_counter() - t0)
        if self.step_timer is not None:
            report.stragglers_redone.extend(sh.reexecute_stragglers(
                self.step_timer.stragglers(min_samples=1)))

    def _columnar_shard_blocks(self, t, n: int):
        """``(holder, block_iterator)`` when shard ``n``'s alive primary is
        stored columnar (the zero-materialization feed), else None — dead
        owners and row shards take the record read path."""
        info = t.shards[n]
        node = self.cluster.nodes[info.node_id]
        if (node.alive and node.pool is not None
                and info.set_name in node.pool.paging.sets):
            ls = node.pool.get_set(info.set_name)
            if is_columnar(ls):
                return info.node_id, iter_column_blocks(node.pool, ls,
                                                        t.dtype)
        return None

    # -- the three plans -------------------------------------------------------
    def _co_partitioned(self, bt, pt, report: JoinReport) -> List[np.ndarray]:
        """Both sides aligned on the key: node-local shard-pair joins, zero
        network bytes (replica fallback for a dead owner is the only thing
        that can move data, and it is counted when it does). Columnar shard
        pairs stream block-by-block straight into the join tables — the
        probe side never materializes rows at all."""
        outs = []
        for n in sorted(bt.shards):
            bfast = self._columnar_shard_blocks(bt, n)
            pfast = self._columnar_shard_blocks(pt, n)
            if (bfast is not None and pfast is not None
                    and bfast[0] == pfast[0]):
                node = self.cluster.node(bfast[0])
                outs.append(self._run_join(node, f"co{n}", bt.dtype,
                                           pt.dtype, bfast[1], pfast[1]))
                continue
            bholder, brecs = self.cluster.read_shard_from(bt, n)
            pholder, precs = self.cluster.read_shard_from(pt, n)
            if pholder != bholder:
                # dead-owner fallback put the two shards on different
                # holders; the probe shard crosses to the build holder
                self.cluster.add_net_bytes(precs.nbytes)
            node = self.cluster.node(bholder)
            outs.append(self._run_join(node, f"co{n}", bt.dtype, pt.dtype,
                                       _batches(brecs, self.batch),
                                       _batches(precs, self.batch)))
        return outs

    def _one_side(self, bt, pt, plan: JoinPlan,
                  report: JoinReport) -> List[np.ndarray]:
        """Anchor side stays put; the moving side shuffles routed by the
        anchor's scheme, then streams partition-by-partition into join
        tables built from the anchor's local shards."""
        from .cluster import (ClusterShuffle,  # local: cluster imports scheduler
                              sharded_set_is_columnar)
        anchor_t, moving_t = (bt, pt) if plan.anchor == "build" else (pt, bt)
        moving_side = plan.shuffle_sides[0]
        sh = ClusterShuffle(
            self.cluster, f"{self._name}.sh", len(anchor_t.node_ids),
            moving_t.dtype, page_size=self.page_size,
            scheduler=self.scheduler,
            partition_fn=lambda keys: scheme_slot_of_keys(
                keys, anchor_t.scheme),
            columnar=sharded_set_is_columnar(moving_t))
        self._map_moving_side(sh, moving_t, report)
        sh.finish_maps()
        report.shuffled_bytes[moving_side] = \
            self.cluster.stats.total_shuffle_bytes(sh.name)
        outs = []
        for r, nid in enumerate(anchor_t.node_ids):
            afast = self._columnar_shard_blocks(anchor_t, nid)
            if afast is not None:
                aholder = afast[0]
                anchor_chunks: Iterable = afast[1]
            else:
                aholder, arecs = self.cluster.read_shard_from(anchor_t, nid)
                anchor_chunks = _batches(arecs, self.batch)
            node = self.cluster.node(aholder)
            moving_chunks = sh.stream_partition(r, dst_node=aholder)
            if plan.anchor == "build":
                out = self._run_join(node, f"r{r}", bt.dtype, pt.dtype,
                                     anchor_chunks, moving_chunks)
            else:
                out = self._run_join(node, f"r{r}", bt.dtype, pt.dtype,
                                     moving_chunks, anchor_chunks)
            sh.release_partition(r)
            outs.append(out)
        self.cluster.stats.clear_shuffle(sh.name)
        return outs

    def _both_sides(self, bt, pt, report: JoinReport) -> List[np.ndarray]:
        """Neither side is partitioned on the key: repartition both to a
        common hash layout; reducer placement follows the combined build +
        probe byte statistics with the pressure discount."""
        from .cluster import ClusterShuffle, sharded_set_is_columnar
        R = self.num_reducers or len(self.cluster.alive_node_ids())
        shb = ClusterShuffle(self.cluster, f"{self._name}.b", R, bt.dtype,
                             page_size=self.page_size,
                             scheduler=self.scheduler,
                             columnar=sharded_set_is_columnar(bt))
        shp = ClusterShuffle(self.cluster, f"{self._name}.p", R, pt.dtype,
                             page_size=self.page_size,
                             scheduler=self.scheduler,
                             columnar=sharded_set_is_columnar(pt))
        self._map_moving_side(shb, bt, report)
        self._map_moving_side(shp, pt, report)
        shb.finish_maps()
        shp.finish_maps()
        report.shuffled_bytes["build"] = \
            self.cluster.stats.total_shuffle_bytes(shb.name)
        report.shuffled_bytes["probe"] = \
            self.cluster.stats.total_shuffle_bytes(shp.name)
        if self.cluster.admission:
            pplan = self.scheduler.place_join_reducers_admitted(
                shb.name, shp.name, R,
                deadline_s=self.cluster.admission_deadline_s)
            placement = pplan.placement
            report.diversions = dict(pplan.diversions)
        else:
            placement = self.scheduler.place_join_reducers(shb.name,
                                                           shp.name, R)
        shb.assign_placement(placement)
        shp.assign_placement(placement)
        outs = []
        for r in range(R):
            dst = placement[r]
            node = self.cluster.node(dst)
            out = self._run_join(node, f"r{r}", bt.dtype, pt.dtype,
                                 shb.stream_partition(r, dst_node=dst),
                                 shp.stream_partition(r, dst_node=dst))
            shb.release_partition(r)
            shp.release_partition(r)
            outs.append(out)
        self.cluster.stats.clear_shuffle(shb.name)
        self.cluster.stats.clear_shuffle(shp.name)
        return outs

    # -- entry point -----------------------------------------------------------
    def execute(self) -> Tuple[np.ndarray, JoinReport]:
        """Plan, execute, and canonical-sort the join. Returns the joined
        records (``join_output_dtype`` layout) and the execution report."""
        t0 = time.perf_counter()
        plan = self.scheduler.plan_join(self.build, self.probe,
                                        self.key_field)
        report = JoinReport(plan=plan)
        bt = self.cluster.catalog.get(plan.build_name, self.build)
        pt = self.cluster.catalog.get(plan.probe_name, self.probe)
        report.build_rows = sum(i.num_records for i in bt.shards.values())
        report.probe_rows = sum(i.num_records for i in pt.shards.values())
        base_net = self.cluster.net_bytes
        if plan.shuffle_free:
            outs = self._co_partitioned(bt, pt, report)
        elif len(plan.shuffle_sides) == 1:
            outs = self._one_side(bt, pt, plan, report)
        else:
            outs = self._both_sides(bt, pt, report)
        outs = [o for o in outs if len(o)]
        if outs:
            out = canonical_join_sort(np.concatenate(outs))
        else:
            from ..core.services import join_output_dtype
            out = np.empty(0, join_output_dtype(bt.dtype, pt.dtype,
                                                self.key_field,
                                                self.key_field))
        report.output_rows = len(out)
        report.net_bytes = self.cluster.net_bytes - base_net
        report.seconds = time.perf_counter() - t0
        return out, report


def cluster_join(cluster, build, probe, key_field: str,
                 **kw) -> Tuple[np.ndarray, JoinReport]:
    """One-call form over existing sharded sets (``data/pipeline.py``'s
    ``cluster_join`` stages records first and then calls this)."""
    return ClusterJoin(cluster, build, probe, key_field, **kw).execute()
