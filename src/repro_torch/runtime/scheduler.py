"""Cluster scheduler — placement policy extracted from the cluster mechanics.

The paper's monolithic-storage argument (§1, §9.2.2) is that because one
storage layer sees everything — replica partitionings in the statistics
database, map-output locality, liveness — it can make the placement decisions
that layered stacks (Spark over Alluxio over HDFS) each make blindly. This
module owns those decisions; ``runtime/cluster.py`` owns the mechanics and
asks the scheduler where to put things:

* **Reducer placement** (``place_reducers``) — reducer ``r`` lands on the
  node already holding the most map-output bytes for partition ``r``
  (``StatisticsDB.shuffle_partition_bytes``), instead of the naive ``r % N``;
  a node's bytes are discounted by its published memory pressure, so a node
  that is already spilling deliberately trades network bytes for not paging.
  Absent pressure, ties prefer the baseline node so placement is never worse
  than round-robin.
* **Shuffle elision** (``plan_aggregation``) — when the input sharded set is
  already partitioned on the aggregation key (``stats.best_replica`` finds a
  co-partitioned replica), the shuffle is skipped outright: every node
  aggregates its own shard and the merge is disjoint. net_bytes == 0.
* **Join planning** (``plan_join``) — the §9.2.2 flagship: an equi-join
  shuffles *only the non-co-partitioned side* (or neither, when a
  co-partitioned replica pair is registered), routing the moving side by the
  stationary side's own storage scheme; when both sides must move, reducer
  placement follows the combined byte statistics with the same pressure
  discount as aggregation.
* **Admission-checked placement** (``place_reducers_admitted`` /
  ``place_join_reducers_admitted``) — before a reducer is pinned, the
  chosen node's ``MemoryManager`` must *admit* the partition's landing bytes
  (``AdmissionController.admit_placement``); a node that refuses past the
  deadline loses the partition to the next-best byte-locality candidate, and
  the diversion is recorded in the returned ``PlacementPlan``. Placement
  also reads pressure through ``node_pressure_current`` — the recorded
  snapshot while fresh, the node's live score once any topology/job event
  has made the snapshot stale.
* **Read-source selection** (``read_sources``) — reads of a dead owner's
  shard are routed to a surviving CRC-verified replica holder rather than
  failing.
* **Straggler re-execution** (``backup_source``) — a mapper flagged by the
  ``watchdog.StepTimer`` gets its partitions re-executed on a node holding a
  replica of its shard (backup tasks from replica holders, paper §7 applied
  to execution; ``ClusterShuffle.reexecute_stragglers`` drives it).

Copy of the JAX package's ``runtime/scheduler.py``; nothing changes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.statistics import ReplicaInfo


# preference order among sources whose costs tie: a direct local copy, then
# local disk, then a network copy, then a full re-partition
_KIND_RANK = {"primary": 0, "pagelog": 1, "replica": 2, "rebuild": 3}


@dataclass
class RecoverySource:
    """One costed way to re-materialize a shard (scheduler recovery plan).

    ``kind`` is ``"primary"``/``"replica"`` for a direct page-for-page copy
    from a surviving set, ``"pagelog"`` for replaying the revived owner's
    own durable page log (zero network bytes, only local disk reads),
    or ``"rebuild"`` for re-running the partitioner over a heterogeneously
    partitioned replica of the same logical data
    (``core/replication.recover_target_shard``). ``cost_bytes`` is the bytes
    that must cross the network to execute it; ``disk_bytes`` the bytes that
    must come off the target's local disk (discounted by the scheduler's
    ``disk_byte_cost`` — disk is cheaper than the wire but not free);
    ``pressure`` is the source node's memory-pressure score (tie-breaker:
    don't read a shard off a node that is busy spilling)."""

    kind: str
    holder: Optional[int]
    set_name: Optional[str]
    cost_bytes: int
    pressure: float = 0.0
    replica_of: Optional[str] = None   # rebuild: the sharded set to read
    disk_bytes: int = 0                # pagelog: bytes replayed off local disk

    def effective_cost(self, disk_byte_cost: float) -> int:
        return self.cost_bytes + int(disk_byte_cost * self.disk_bytes)

    @property
    def sort_key(self) -> Tuple:
        return (self.cost_bytes, self.pressure, _KIND_RANK[self.kind],
                -1 if self.holder is None else self.holder)


@dataclass
class PlacementPlan:
    """An admission-checked reducer placement: the final assignment
    plus every diversion the admission loop made — ``diversions[r]`` is
    ``(refused_node, placed_node)`` for a reducer whose byte-locality choice
    refused admission past the deadline and was re-placed on the next-best
    candidate. ``refusals`` counts every candidate that refused along the
    way (a reducer may be refused by several nodes before landing)."""

    placement: Dict[int, int]
    diversions: Dict[int, Tuple[int, int]]
    refusals: int = 0

    @property
    def diverted(self) -> int:
        return len(self.diversions)


@dataclass
class AggregationPlan:
    """How an aggregation over a sharded set should execute."""

    co_partitioned: bool
    replica: Optional[ReplicaInfo] = None
    target_name: Optional[str] = None   # the sharded set to actually read

    @property
    def shuffle_free(self) -> bool:
        return self.co_partitioned


@dataclass
class JoinPlan:
    """How a two-sided equi-join should execute (paper §9.2.2).

    ``build_name``/``probe_name`` are the sharded sets to actually read —
    possibly co-partitioned replicas of the handles the query came in with
    (``stats.best_replica`` routing, same as ``plan_aggregation``).
    ``shuffle_sides`` lists which sides must move: empty when both sides are
    co-partitioned *and aligned* (same partition count, same placement
    domain), one side when the other can anchor the join in place, both only
    when neither side is partitioned on the key. ``anchor`` names the
    stationary side (``"build"``/``"probe"``) for the one-side case — the
    shuffled side is routed by the anchor's own storage scheme, so matching
    keys land exactly where the anchor's shards already sit."""

    key_field: str
    build_name: str
    probe_name: str
    shuffle_sides: Tuple[str, ...]      # () | 1 side | ("build", "probe")
    anchor: Optional[str] = None        # stationary side for one-side shuffles
    build_bytes: int = 0
    probe_bytes: int = 0

    @property
    def shuffle_free(self) -> bool:
        return not self.shuffle_sides


class ClusterScheduler:
    """Placement decisions over a ``Cluster`` (duck-typed: anything with
    ``nodes``, ``alive_node_ids()`` and ``stats``)."""

    #: relative price of a byte read from the recovery target's local disk
    #: versus a byte pulled over the network (recovery costing). At the
    #: default a warm log replay beats any remote copy of the same bytes but
    #: still loses to a copy already sitting in the target's pool, and a
    #: sufficiently small replica pull can out-cost a huge disk replay.
    disk_byte_cost: float = 0.25

    def __init__(self, cluster):
        self.cluster = cluster

    # -- reducer placement -----------------------------------------------------
    def baseline_placement(self, num_reducers: int) -> Dict[int, int]:
        """The original policy: round-robin over the alive membership."""
        alive = self.cluster.alive_node_ids()
        return {r: alive[r % len(alive)] for r in range(num_reducers)}

    def node_pressure_current(self, node_id: int) -> float:
        """The pressure score placement should trust *now*: the recorded
        snapshot while it is fresh, else the node's live
        ``MemoryManager.pressure_score()`` (bugfix — pressure is
        published at shuffle finalization, so back-to-back jobs used to plan
        against the previous job's snapshot; any topology/job event since
        the recording invalidates it)."""
        fresh = self.cluster.stats.node_pressure_fresh(node_id)
        if fresh is not None:
            return fresh
        return self.node_pressure_live(node_id)

    def _rank_candidates(self, shuffle_names: Sequence[str], r: int,
                         base: int) -> Tuple[List[int], int]:
        """Alive candidate nodes for reducer ``r``, best byte-locality first
        (pressure-discounted), plus the partition's total map-output bytes.
        Falls back to ``[base]`` when no byte statistics exist."""
        stats = self.cluster.stats
        by_node: Dict[int, int] = {}
        for name in shuffle_names:
            for n, b in stats.shuffle_partition_bytes(name, r).items():
                if self.cluster.nodes[n].alive:
                    by_node[n] = by_node.get(n, 0) + b
        total = sum(by_node.values())
        if not by_node:
            return [base], total
        score = {n: b * (1.0 - self.node_pressure_current(n))
                 for n, b in by_node.items()}
        ranked = sorted(score, key=lambda n: (score[n], n == base, -n),
                        reverse=True)
        return ranked, total

    def _place_by_bytes(self, shuffle_names: Sequence[str],
                        num_reducers: int) -> Dict[int, int]:
        """The placement core shared by aggregation and join shuffles:
        reducer ``r`` goes to the alive node holding the most map-output
        bytes for partition ``r``, summed over every named shuffle,
        pressure-discounted; ties fall back to the baseline node."""
        placement = self.baseline_placement(num_reducers)
        for r in range(num_reducers):
            ranked, _total = self._rank_candidates(shuffle_names, r,
                                                   placement[r])
            placement[r] = ranked[0]
        return placement

    def _place_admitted(self, shuffle_names: Sequence[str],
                        num_reducers: int,
                        deadline_s: float) -> PlacementPlan:
        """Admission-checked placement (the admission control loop's re-route
        step): walk each reducer's byte-locality ranking and pin it to the
        first candidate whose MemoryManager admits the partition's landing
        bytes within ``deadline_s``. A refusal past the deadline diverts the
        partition to the next-best candidate and is recorded in the plan;
        when every candidate refuses, the byte-heaviest keeps the reducer
        (someone must run it — the pool spills rather than fails).

        Candidates beyond the byte holders count too: a node holding zero
        map output but with admission headroom is a better home than a full
        byte-local node — it pays the partition's bytes on the wire once
        instead of spilling them through a saturated pool — so the ranking
        is extended with the remaining alive nodes, least-pressured first."""
        placement = self.baseline_placement(num_reducers)
        plan = PlacementPlan(placement=placement, diversions={})
        # a node that already refused during THIS planning pass gets only a
        # non-blocking probe for later reducers — without the memo, one
        # persistently pressured byte-heavy node would cost the full
        # deadline serially for every reducer planned onto it
        refused_once: set = set()
        # bytes this pass has already planned onto each node: admission is
        # probed against live occupancy, so without this a node with
        # headroom for ONE partition would be granted all of them and the
        # pulls would spill exactly the way always-grant does
        planned: Dict[int, int] = {}
        for r in range(num_reducers):
            ranked, total = self._rank_candidates(shuffle_names, r,
                                                  placement[r])
            ranked = ranked + sorted(
                (n for n in self.cluster.alive_node_ids()
                 if n not in ranked),
                key=lambda n: (self.node_pressure_live(n), n))
            chosen = ranked[0]
            for candidate in ranked:
                node = self.cluster.nodes[candidate]
                memory = node.memory if node.alive else None
                first_probe = candidate not in refused_once
                ask = total + planned.get(candidate, 0)
                if memory is None or memory.admission.admit_placement(
                        ask, deadline_s=deadline_s if first_probe else 0.0,
                        count=first_probe):
                    chosen = candidate
                    break
                refused_once.add(candidate)
                plan.refusals += 1
            placement[r] = chosen
            planned[chosen] = planned.get(chosen, 0) + total
            if chosen != ranked[0]:
                plan.diversions[r] = (ranked[0], chosen)
        return plan

    # -- serving-sequence placement -------------------------------------
    def place_sequences(self, asks: Dict[int, Tuple[int, int]],
                        deadline_s: float = 0.0) -> PlacementPlan:
        """Admission-checked placement for serving sequences: ``asks`` maps
        ``seq_id -> (affinity_node, kv_bytes)``. Session affinity makes the
        hashed home node the top candidate (its pool may already hold the
        session's KV pages); the ranking extends with the remaining alive
        nodes, least live pressure first, exactly like the reducer re-route
        loop. A refusal past ``deadline_s`` diverts the prefill to the next
        admitting node (``plan.diversions[seq] = (affinity, chosen)``); when
        every candidate refuses, the affinity node keeps the sequence — the
        serving pool degrades to spill, it does not drop a session."""
        plan = PlacementPlan(placement={}, diversions={})
        refused_once: set = set()
        planned: Dict[int, int] = {}
        for seq_id, (affinity, nbytes) in asks.items():
            ranked = ([affinity] if self.cluster.nodes[affinity].alive
                      else [])
            ranked = ranked + sorted(
                (n for n in self.cluster.alive_node_ids()
                 if n not in ranked),
                key=lambda n: (self.node_pressure_live(n), n))
            if not ranked:
                raise ValueError("no alive nodes to place sequences on")
            chosen = ranked[0]
            for candidate in ranked:
                node = self.cluster.nodes[candidate]
                memory = node.memory if node.alive else None
                first_probe = candidate not in refused_once
                ask = nbytes + planned.get(candidate, 0)
                if memory is None or memory.admission.admit_placement(
                        ask, deadline_s=deadline_s if first_probe else 0.0,
                        count=first_probe):
                    chosen = candidate
                    break
                refused_once.add(candidate)
                plan.refusals += 1
            plan.placement[seq_id] = chosen
            planned[chosen] = planned.get(chosen, 0) + nbytes
            if chosen != ranked[0]:
                plan.diversions[seq_id] = (ranked[0], chosen)
        return plan

    def place_reducers(self, shuffle_name: str,
                       num_reducers: int) -> Dict[int, int]:
        """Locality-aware placement: reducer ``r`` goes to the alive node
        holding the most map-output bytes for partition ``r``. Per-reducer
        cross-node traffic is ``total_bytes(r) - bytes_on(chosen)``, so the
        byte-heaviest choice minimizes it; ties fall back to the baseline
        node, which (absent pressure) makes the plan never worse than
        round-robin.

        Bytes are discounted by the node's published memory-pressure score
        (``StatisticsDB.node_pressure``, fed from each node's MemoryManager
        at map finalization): a node already spilling its pool would pay for
        reducer input with page faults, so locality there is worth less —
        at score 1.0 it is worth nothing and the reducer lands elsewhere.
        That is a deliberate trade of network bytes for fault avoidance, so
        under pressure the plan may ship more bytes than round-robin
        would."""
        return self._place_by_bytes([shuffle_name], num_reducers)

    def place_reducers_admitted(self, shuffle_name: str, num_reducers: int,
                                deadline_s: float = 0.05) -> PlacementPlan:
        """``place_reducers`` plus admission: each reducer's chosen node must
        admit the partition's landing bytes (``AdmissionController
        .admit_placement``) within ``deadline_s``, else the partition is
        diverted to the next-best byte-locality candidate and the diversion
        recorded in the returned plan."""
        return self._place_admitted([shuffle_name], num_reducers, deadline_s)

    def placement_net_bytes(self, shuffle_name: str,
                            placement: Dict[int, int]) -> int:
        """Predicted cross-node bytes for a reducer placement (what the
        benchmark reports next to the measured figure)."""
        stats = self.cluster.stats
        total = 0
        for r, node in placement.items():
            by_node = stats.shuffle_partition_bytes(shuffle_name, r)
            total += sum(b for n, b in by_node.items() if n != node)
        return total

    # -- shuffle elision -------------------------------------------------------
    def plan_aggregation(self, sset, key_field: str) -> AggregationPlan:
        """Co-partitioned input aggregates shard-locally with zero network
        bytes; otherwise shuffle, with reducer placement decided after the
        map phase (it needs the byte statistics maps produce).

        ``stats.best_replica`` is consulted for the *logical* dataset, so a
        heterogeneously partitioned replica set (same records, partitioned on
        ``key_field``, registered via ``Cluster.register_replica_set``) makes
        the query shuffle-free even when the set handed in is not — the
        paper's "select a Pangea replica that is the best for the query"."""
        target, co, replica = self._resolve_side(sset, key_field)
        return AggregationPlan(co_partitioned=co, replica=replica,
                               target_name=target.name)

    # -- join planning (paper §9.2.2: shuffle only the non-co side) ------------
    def _resolve_side(self, sset, key_field: str):
        """Route one query input through the replica catalog: prefer a
        co-partitioned replica of the same logical dataset (the paper's
        "select a Pangea replica that is the best for the query"). Shared by
        aggregation and join planning; returns ``(target_set, co,
        replica_info)``."""
        replica = self.cluster.stats.best_replica(sset.name, key_field)
        target = sset
        if (replica is not None and replica.partition_key == key_field
                and replica.set_name != sset.name):
            alt = self.cluster.catalog.get(replica.set_name)
            if alt is not None and alt.partition_key == key_field:
                target = alt
        co = (replica is not None and replica.partition_key == key_field
              and target.partition_key == key_field)
        return target, co, replica

    def set_bytes(self, sset) -> int:
        """Catalog-metadata size of a sharded set (what join planning costs
        sides by — no data is read to make the plan)."""
        return sum(info.num_records for info in sset.shards.values()) \
            * sset.dtype.itemsize

    @staticmethod
    def _aligned(a, b) -> bool:
        """Two sets partitioned on the same key route every key to the same
        node iff they share the partition count and the placement domain (the
        hash is deterministic, so that is the whole condition)."""
        return (a.scheme.num_partitions == b.scheme.num_partitions
                and list(a.node_ids) == list(b.node_ids))

    def plan_join(self, build_sset, probe_sset, key_field: str) -> JoinPlan:
        """Decide placement and movement for an equi-join on ``key_field``:

        * both sides co-partitioned and aligned → shuffle *neither*; every
          node joins its own build/probe shard pair (net_bytes == 0);
        * exactly one side co-partitioned → it anchors the join; only the
          non-co side is shuffled, routed by the anchor's storage scheme;
        * both co-partitioned but misaligned (different partition counts or
          placement domains) → the byte-heavier side anchors and only the
          *smaller* side moves;
        * neither co-partitioned → both sides shuffle to a common hash
          layout; reducer placement then follows the combined byte statistics
          with the usual memory-pressure discount
          (``place_join_reducers``)."""
        bt, bco, _ = self._resolve_side(build_sset, key_field)
        pt, pco, _ = self._resolve_side(probe_sset, key_field)
        bb, pb = self.set_bytes(bt), self.set_bytes(pt)
        plan = JoinPlan(key_field=key_field, build_name=bt.name,
                        probe_name=pt.name, shuffle_sides=(),
                        build_bytes=bb, probe_bytes=pb)
        if bco and pco and self._aligned(bt, pt):
            return plan
        if bco and pco:
            # both partitioned on the key, but not onto the same layout:
            # anchor the heavier side, move only the smaller one
            anchor = "build" if bb >= pb else "probe"
        elif bco:
            anchor = "build"
        elif pco:
            anchor = "probe"
        else:
            plan.shuffle_sides = ("build", "probe")
            return plan
        plan.anchor = anchor
        plan.shuffle_sides = ("probe",) if anchor == "build" else ("build",)
        return plan

    def place_join_reducers(self, build_shuffle: str, probe_shuffle: str,
                            num_reducers: int) -> Dict[int, int]:
        """Reducer placement for a both-sides-shuffled join: reducer ``r``
        lands on the alive node holding the most *combined* build+probe
        map-output bytes for partition ``r``, discounted by published memory
        pressure — ``place_reducers`` over two byte maps that must
        co-locate."""
        return self._place_by_bytes([build_shuffle, probe_shuffle],
                                    num_reducers)

    def place_join_reducers_admitted(self, build_shuffle: str,
                                     probe_shuffle: str, num_reducers: int,
                                     deadline_s: float = 0.05
                                     ) -> PlacementPlan:
        """``place_join_reducers`` with the same admission check and
        re-routing as ``place_reducers_admitted`` (the landing ask is the
        combined build+probe partition bytes)."""
        return self._place_admitted([build_shuffle, probe_shuffle],
                                    num_reducers, deadline_s)

    # -- read-source selection -------------------------------------------------
    def _holds(self, node_id: int, set_name: str) -> bool:
        """An alive node physically holding the set (a freshly revived node
        mid-recovery is alive but empty — it must not serve reads yet)."""
        node = self.cluster.nodes[node_id]
        return (node.alive and node.pool is not None
                and set_name in node.pool.paging.sets)

    def read_sources(self, sset, node_id: int) -> List[Tuple[int, str]]:
        """Candidate locations for shard ``node_id`` of ``sset``, best first:
        the primary when its owner is alive and holds it, then every alive
        replica holder. The cluster walks these in order, CRC-verifying
        replica reads."""
        info = sset.shards[node_id]
        sources: List[Tuple[int, str]] = []
        if self._holds(node_id, info.set_name):
            sources.append((node_id, info.set_name))
        sources.extend((holder, rep_name)
                       for holder, rep_name in info.replicas
                       if self._holds(holder, rep_name))
        return sources

    # -- recovery source costing (ROADMAP "Recovery source costing") -----------
    def node_pressure_live(self, node_id: int) -> float:
        """Current MemoryManager pressure score of an alive node (0 for dead
        nodes — they have no pool to pressure)."""
        node = self.cluster.nodes.get(node_id)
        memory = node.memory if node is not None and node.alive else None
        if memory is None:
            return 0.0
        return memory.pressure_score()

    def _shard_bytes(self, sset, info) -> int:
        return info.num_records * sset.dtype.itemsize

    def recovery_plan(self, sset, shard_id: int,
                      target_node: int) -> List[RecoverySource]:
        """Every way to re-materialize ``sset``'s shard ``shard_id`` onto
        ``target_node``, cheapest first. Candidates:

        * the alive primary / each alive replica holder — a page-for-page
          copy; costs the shard's bytes when the holder is remote, zero when
          the bytes are already on the target;
        * the target's own durable page log — when the target IS the
          shard's owner and its replayed log still indexes the set at a
          non-stale epoch, the shard can be adopted from local disk; zero
          network bytes, the replay bytes priced at ``disk_byte_cost`` each;
        * a heterogeneously partitioned replica of the same logical dataset
          (``Cluster.register_replica_set``) — rebuild by re-running the
          partitioner over its readable shards
          (``core/replication.recover_target_shard``); costs every remote
          byte of that replica set, since each shard must be scanned. An
          alt shard unreadable *because it sat on the failed node itself* is
          still viable when a conflicting-object guard covers it.

        Ties break toward the source node with the lowest live memory
        pressure: reading a shard off a node that is busy spilling faults
        its pool on every page."""
        info = sset.shards[shard_id]
        shard_bytes = self._shard_bytes(sset, info)
        plan: List[RecoverySource] = []
        if self._holds(shard_id, info.set_name):
            plan.append(RecoverySource(
                kind="primary", holder=shard_id, set_name=info.set_name,
                cost_bytes=0 if shard_id == target_node else shard_bytes,
                pressure=self.node_pressure_live(shard_id)))
        log_bytes = self._pagelog_bytes(sset, info, shard_id, target_node)
        if log_bytes is not None:
            plan.append(RecoverySource(
                kind="pagelog", holder=target_node, set_name=info.set_name,
                cost_bytes=0, disk_bytes=log_bytes,
                pressure=self.node_pressure_live(target_node)))
        for holder, rep_name in info.replicas:
            if not self._holds(holder, rep_name):
                continue
            plan.append(RecoverySource(
                kind="replica", holder=holder, set_name=rep_name,
                cost_bytes=0 if holder == target_node else shard_bytes,
                pressure=self.node_pressure_live(holder)))
        guard_fn = getattr(self.cluster, "conflict_guard", None)
        for rinfo in self.cluster.stats.replicas_of(sset.name):
            alt = self.cluster.catalog.get(rinfo.set_name)
            if alt is None or alt is sset or alt.name == sset.name:
                continue
            cost = 0
            readable = True
            pressures = [0.0]
            for n, ainfo in alt.shards.items():
                sources = self.read_sources(alt, n)
                if not sources:
                    # paper-§7 conflicting objects: the alt's shard on the
                    # failed node is the one shard the rebuild can substitute
                    # — the guard copy holds exactly the records both
                    # partitionings routed there, which are exactly the ones
                    # this target shard needs from it
                    guard = (guard_fn(sset.name, alt.name, n)
                             if guard_fn is not None else None)
                    if guard is not None and n == shard_id:
                        if guard.holder != target_node:
                            cost += guard.num_records * sset.dtype.itemsize
                        pressures.append(
                            self.node_pressure_live(guard.holder))
                        continue
                    readable = False
                    break
                holder = sources[0][0]
                if holder != target_node:
                    cost += self._shard_bytes(alt, ainfo)
                pressures.append(self.node_pressure_live(holder))
            if readable:
                plan.append(RecoverySource(
                    kind="rebuild", holder=None, set_name=None,
                    cost_bytes=cost, pressure=max(pressures),
                    replica_of=alt.name))
        plan.sort(key=lambda s: (s.effective_cost(self.disk_byte_cost),
                                 s.pressure, _KIND_RANK[s.kind],
                                 -1 if s.holder is None else s.holder))
        return plan

    def _pagelog_bytes(self, sset, info, shard_id: int,
                       target_node: int) -> Optional[int]:
        """Bytes the recovery target could replay from its local page log
        for this shard, or None when the log has nothing usable. The target
        must BE the shard's owner (logs are per-node — no other node's log
        ever held these pages), alive with the durable tier configured, and
        the replayed entries must carry an epoch at least the cataloged
        shard's (the revival fence: log state from before a drop/re-shard
        must not resurrect)."""
        if target_node != shard_id:
            return None
        node = self.cluster.nodes.get(target_node)
        memory = node.memory if node is not None and node.alive else None
        if memory is None:
            return None
        log = memory.pagelog
        if log is None or not log.entries_for(info.set_name):
            return None
        if log.set_epoch(info.set_name) < getattr(info, "epoch", 0):
            return None
        return log.set_bytes(info.set_name)

    def remesh_read_source(self, sset, shard_id: int,
                           survivors: Sequence[int]) -> List[Tuple[int, str]]:
        """Source ordering for the streaming remesh's per-shard scan: the
        usual ``read_sources`` candidates, re-ranked so that a holder inside
        the surviving domain (its slice of the re-partition stays local) and
        under the least memory pressure streams the shard."""
        surv = set(survivors)
        ranked = sorted(
            self.read_sources(sset, shard_id),
            key=lambda hs: (hs[0] not in surv,
                            self.node_pressure_live(hs[0]),
                            hs[0] != shard_id, hs[0]))
        return ranked

    # -- straggler re-execution ------------------------------------------------
    def backup_source(self, sset, shard_id: int,
                      exclude: int) -> Optional[Tuple[int, str]]:
        """Where a straggler's map work for ``shard_id`` should re-execute:
        the first surviving copy *not* on the straggler (the alive primary
        when the straggler was only a backup, else a replica holder). None
        when no such copy exists — the slow output must stand."""
        for holder, set_name in self.read_sources(sset, shard_id):
            if holder != exclude:
                return holder, set_name
        return None

    def backup_source_admitted(self, sset, shard_id: int, exclude: int,
                               deadline_s: float = 0.05
                               ) -> Tuple[Optional[Tuple[int, str]],
                                          Optional[Tuple[int, int]]]:
        """``backup_source`` with the admission check the admission loop missed
        (carried bugfix): re-executing a straggler's map work lands the
        shard's scan plus its map output on the chosen holder, so that
        holder's MemoryManager must admit the bytes exactly like reducer
        placement admits a partition's landing bytes. A holder that refuses
        past the deadline loses the backup task to the next surviving copy;
        when every candidate refuses, the first keeps it (someone must run
        it — the pool spills rather than fails, same terminal rule as
        ``_place_admitted``). Returns ``(source, diversion)`` where
        ``diversion`` is ``(refused_holder, placed_holder)`` or None."""
        candidates = [(h, s) for h, s in self.read_sources(sset, shard_id)
                      if h != exclude]
        if not candidates:
            return None, None
        ask = self._shard_bytes(sset, sset.shards[shard_id])
        for holder, set_name in candidates:
            memory = self.cluster.nodes[holder].memory
            if memory is None or memory.admission.admit_placement(
                    ask, deadline_s=deadline_s):
                diversion = (None if holder == candidates[0][0]
                             else (candidates[0][0], holder))
                return (holder, set_name), diversion
        return candidates[0], None
