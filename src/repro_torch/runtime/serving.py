"""Distributed paged-KV serving tier.

The analytics paths already run everything through one monolithic manager per
node — admission, paging, spill, replication, recovery.  This module points
the same machinery at the serving workload: many sequences whose KV caches
contend for device memory.

* **Sharding + session affinity** — every active sequence is a KV locality
  set inside one node's ``KVShard`` (a ``PagedKVCache`` holding that node's
  device page pool).  The home node is hashed from the sequence id over the
  full membership, so a session keeps landing on the node that already
  holds its pages.
* **Continuous-batching admission** — prefills probe the home node's
  ``try_reserve`` with ``urgency="low"`` (speculative: never waits).
  Refused prefills go through ``ClusterScheduler.place_sequences`` and are
  diverted to admitting nodes (``PlacementPlan.diversions``), falling back
  to the affinity node when everyone refuses — the pool spills, it does not
  drop sessions.  In-flight decode allocates new pages with
  ``urgency="required"`` (paced, never refused), exactly the shuffle
  pipeline's contract.
* **Three-level spill** — device pages evicted by Eq. 1 land in the shard's
  ``TieredSlabStore``: level 2 charges the node's ``MemoryManager`` (host
  pool); past the host budget, slabs overflow to a *remote* node's pool
  through the ``TransferEngine`` (level 3) and fault back on demand.
* **Failover** — every committed page slab is replicated to the session's
  replica node as a raw blob (``Cluster.store_bytes``, physically in the
  replica's pool — its own OS process on ``backend="proc"``).  When the
  serving node dies mid-stream the session rebuilds on the replica holder
  and resumes decode byte-identically; with no live replica it raises the
  same ``DeadNodeError("... must re-run")`` contract the shuffle honors.

KV content is a deterministic function of ``(seq_id, position)``
(``expected_page_slab``), so byte-identity across spill levels, backends,
and failovers is checkable, not just plausible.

Copy of the JAX package's ``runtime/serving.py``. What changes: every
``KVShard``'s pool is the port's ``PagedKVCache`` on the tier's ``device``
(``"cuda"`` unless the caller passes ``"cpu"``), and ``attend`` calls the
port's paged attention on that pool in place. Host slabs stay numpy. The
pool is fp32 (the reference's default) or bf16 (the configs'
``kv_cache_dtype``); a bf16 tier's slabs, blobs, oracle and ``attend``
results are the bf16 bytes as ``np.uint16``, the pager's rule.
Device tensors live in the driver process only: node processes of the
``proc`` backend never touch torch. Two quirks of the reference's
``TieredSlabStore`` are fixed here (ROADMAP, queue 3, items 7 and 8): a
level-3 copy of a slab that changed while it flew is dropped, not adopted,
and the ``during_spill`` hook fires on the spilling thread before the copy
leaves, not on the transfer worker.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.kvcache import (HostSlabStore, PagedKVCache, host_array,
                             host_dtype, host_to_tensor, pool_dtype,
                             tensor_to_host)
from ..kernels.paged_attention.ops import paged_attention
from ..core.sanitizer import tracked_rlock
from .cluster import DeadNodeError
from .scheduler import ClusterScheduler, PlacementPlan


def token_value(seq_id: int, t: int):
    """Deterministic KV fill for token ``t`` of a sequence — the serving
    tier's byte-identity oracle."""
    return ((seq_id * 7919 + t * 104729) % 997) / 997.0


def expected_page_slab(seq_id: int, page_index: int, length: int, *,
                       num_layers: int, page_tokens: int, kv_heads: int,
                       head_dim: int, dtype=np.float32) -> np.ndarray:
    """Reference slab ``[L, page, 2, KH, D]`` for one logical page of a
    sequence at ``length`` committed tokens (zeros past the length), in the
    host form of the pool ``dtype`` (fp32, or bf16 bits as ``np.uint16``;
    ``kvcache.host_array``)."""
    t = page_index * page_tokens + np.arange(page_tokens)
    vals = (((seq_id * 7919 + t * 104729) % 997) / 997.0)
    vals = host_array(np.where(t < length, vals, 0.0), dtype)
    slab = np.zeros((num_layers, page_tokens, 2, kv_heads, head_dim),
                    vals.dtype)
    slab[:] = vals[None, :, None, None, None]
    return slab


class TieredSlabStore(HostSlabStore):
    """Levels 2 and 3 of one shard's KV spill hierarchy.

    ``put`` (an HBM eviction) charges the home node's ``MemoryManager``
    with a paced ``urgency="required"`` grant — host slabs are real memory
    the monolithic manager must see.  Past ``host_budget_bytes`` the oldest
    slabs overflow to a remote node's pool through the cluster's
    ``TransferEngine`` (async; the host copy is only dropped once the
    transfer confirms, so a spill-target death mid-transfer loses nothing).
    ``take`` faults remote slabs back; a dead level-3 holder raises
    ``DeadNodeError`` out of the restore, which the serving tier turns into
    a replica failover.
    """

    def __init__(self, tier: "ServingTier", node_id: int):
        self.tier = tier
        self.node_id = node_id
        # guards the slab maps/order/byte counter only; admission waits,
        # reservation releases, and cluster RPCs all happen outside it
        self._lock = tracked_rlock("serving.slabstore")
        self._local: Dict[int, Tuple[np.ndarray, object]] = {}
        self._order: List[int] = []          # FIFO overflow order
        # pid -> (future, target, the slab object being shipped)
        self._inflight: Dict[int, Tuple[object, int, np.ndarray]] = {}
        self._remote: Dict[int, int] = {}    # pid -> level-3 holder node
        self.host_bytes = 0
        self.stats = {"remote_spills": 0, "remote_fetches": 0,
                      "spill_failures": 0, "host_puts": 0}

    def _blob(self, page_id: int) -> str:
        return f"kvspill/{self.node_id}/{page_id}"

    def _charge(self, nbytes: int):
        memory = self.tier._memory(self.node_id)
        if memory is None or not self.tier.cluster.admission:
            return None
        try:
            return memory.try_reserve(
                nbytes, urgency="required",
                timeout=self.tier.cluster.admission_timeout_s)
        except DeadNodeError:
            return None   # node dying under us; failover will rebuild

    # -- HostSlabStore interface ---------------------------------------------
    def put(self, page_id: int, slab: np.ndarray) -> None:
        self._reap()
        # admission can wait (urgency="required" paces); never under _lock
        res = self._charge(slab.nbytes)
        with self._lock:
            prior = self._local.pop(page_id, None)
            if prior is not None:
                # superseding a live slab: drop the old entry's accounting
                # (the old code leaked its reservation and double-counted
                # host_bytes, and left a duplicate FIFO slot behind)
                self._order.remove(page_id)
                self.host_bytes -= prior[0].nbytes
            self._local[page_id] = (slab, res)
            self._order.append(page_id)
            self.host_bytes += slab.nbytes
            self.stats["host_puts"] += 1
        if prior is not None and prior[1] is not None:
            prior[1].release()   # notifies admission waiters: outside _lock
        self._maybe_overflow()

    def take(self, page_id: int) -> Optional[np.ndarray]:
        self._reap()
        with self._lock:
            entry = self._local.pop(page_id, None)
            if entry is not None:
                self._order.remove(page_id)
                self.host_bytes -= entry[0].nbytes
            holder = None if entry is not None else self._remote.get(page_id)
        if entry is not None:
            slab, res = entry
            if res is not None:
                res.release()
            # an in-flight remote copy is orphaned; _reap drops the blob
            return slab
        if holder is not None:
            self.tier._fire("during_restore")
            data = self.tier.cluster.load_bytes(holder, self._blob(page_id))
            with self._lock:
                self._remote.pop(page_id, None)
            self.tier.cluster.drop_bytes(holder, self._blob(page_id))
            self.stats["remote_fetches"] += 1
            return np.frombuffer(data, self.tier.host_dtype).reshape(
                self.tier.slab_shape).copy()
        return None

    def peek(self, page_id: int) -> Optional[np.ndarray]:
        self._reap()
        with self._lock:
            entry = self._local.get(page_id)
            holder = None if entry is not None else self._remote.get(page_id)
        if entry is not None:
            return entry[0]
        if holder is not None:
            data = self.tier.cluster.load_bytes(holder, self._blob(page_id))
            return np.frombuffer(data, self.tier.host_dtype).reshape(
                self.tier.slab_shape).copy()
        return None

    def discard(self, page_id: int) -> None:
        self._reap()
        with self._lock:
            entry = self._local.pop(page_id, None)
            if entry is not None:
                self._order.remove(page_id)
                self.host_bytes -= entry[0].nbytes
            holder = self._remote.pop(page_id, None)
        if entry is not None and entry[1] is not None:
            entry[1].release()
        if holder is not None:
            self.tier.cluster.drop_bytes(holder, self._blob(page_id))

    def __contains__(self, page_id: int) -> bool:
        with self._lock:
            return (page_id in self._local or page_id in self._inflight
                    or page_id in self._remote)

    def __len__(self) -> int:
        with self._lock:
            return len(self._local) + len(self._remote)

    # -- level-3 overflow -----------------------------------------------------
    def _maybe_overflow(self) -> None:
        budget = self.tier.host_budget_bytes
        if budget is None:
            return
        target = self.tier._spill_target(self.node_id)
        if target is None:
            return
        with self._lock:
            inflight = sum(self._local[p][0].nbytes for p in self._inflight
                           if p in self._local)
            excess = self.host_bytes - inflight - budget
            picked = []
            for pid in self._order:
                if excess <= 0:
                    break
                if pid in self._inflight or pid not in self._local:
                    continue
                picked.append(pid)
                excess -= self._local[pid][0].nbytes
        if not picked:
            return
        # the spill's phase boundary, on the spilling thread and outside
        # _lock, once the target is chosen and before any copy leaves (the
        # reference fires it on the transfer worker, where a node it kills
        # may die after the caller has moved on)
        self.tier._fire("during_spill")
        with self._lock:
            for pid in picked:
                if pid in self._local and pid not in self._inflight:
                    self._spill_one(pid, target)

    def _spill_one(self, page_id: int, target: int) -> None:
        slab = self._local[page_id][0]
        fut = self.tier.cluster.transfer.submit(
            self._ship, page_id, target, slab,
            label=f"kvspill:{self.node_id}:{page_id}",
            dest=target, nbytes=slab.nbytes)
        self._inflight[page_id] = (fut, target, slab)

    def _ship(self, page_id: int, target: int, slab: np.ndarray) -> int:
        self.tier.cluster.store_bytes(target, self._blob(page_id),
                                      slab.tobytes())
        return target

    def _reap(self, refill: bool = True) -> None:
        """Settle finished level-3 copies. A copy of a slab that changed
        while it flew is dropped, and with ``refill`` the newer slab goes
        out again if the host is still over budget."""
        stale = False
        with self._lock:
            done = [(pid, fut, target, shipped)
                    for pid, (fut, target, shipped) in self._inflight.items()
                    if fut.done()]
            for pid, _fut, _target, _shipped in done:
                del self._inflight[pid]
        for pid, fut, target, shipped in done:
            try:
                fut.result(timeout=0)
            except Exception:
                # spill target died mid-transfer: the host copy is still
                # here, so nothing is lost — retry elsewhere on the next put
                self.stats["spill_failures"] += 1
                continue
            with self._lock:
                entry = self._local.get(pid)
                if (entry is not None and entry[0] is not shipped
                        and entry[0].tobytes() != shipped.tobytes()):
                    # taken, changed and put back while the copy flew: the
                    # copy is of the older slab, the host holds the newer
                    entry, stale = None, True
                if entry is not None:
                    del self._local[pid]
                    self._order.remove(pid)
                    self.host_bytes -= entry[0].nbytes
                    self._remote[pid] = target
            if entry is None:     # taken/discarded while the copy flew
                self.tier.cluster.drop_bytes(target, self._blob(pid))
                continue
            slab, res = entry
            if res is not None:
                res.release()
            self.stats["remote_spills"] += 1
        if stale and refill:
            self._maybe_overflow()

    def close(self) -> None:
        """Release every charge and drop every level-3 blob (remote blobs
        live on *other* nodes, so this works even when the home node is
        dead — failover cleanup rides it)."""
        for pid, (fut, _t, _s) in list(self._inflight.items()):
            try:
                fut.result(timeout=5.0)
            except Exception:
                pass
        self._reap(refill=False)
        self._inflight.clear()
        for pid in list(self._remote):
            self.tier.cluster.drop_bytes(self._remote.pop(pid),
                                         self._blob(pid))
        for slab, res in self._local.values():
            if res is not None:
                res.release()
        self._local.clear()
        self._order.clear()
        self.host_bytes = 0


class KVShard:
    """One node's slice of the serving tier: a driver-side ``PagedKVCache``
    holding that node's device page pool, spilling through the tiered
    store."""

    def __init__(self, tier: "ServingTier", node_id: int):
        self.node_id = node_id
        self.store = TieredSlabStore(tier, node_id)
        self.cache = PagedKVCache(
            num_layers=tier.num_layers, hbm_pages=tier.hbm_pages_per_node,
            page_size=tier.page_tokens, kv_heads=tier.kv_heads,
            head_dim=tier.head_dim, dtype=tier.dtype, host_store=self.store,
            device=tier.device)


@dataclass
class Session:
    seq_id: int
    node: int                     # current primary (home) node
    replica: Optional[int]        # replica holder (None = degraded)
    length: int = 0               # committed tokens (replica in sync)
    prompt_len: int = 0


class ServingTier:
    """The cluster-wide serving front end: admission, decode, spill,
    replication, and failover for paged-KV sequences."""

    def __init__(self, cluster, *, num_layers: int = 2, page_tokens: int = 4,
                 kv_heads: int = 2, head_dim: int = 4,
                 hbm_pages_per_node: int = 16,
                 host_budget_bytes: Optional[int] = None,
                 dtype=np.float32, replicate: bool = True,
                 prefill_deadline_s: Optional[float] = None,
                 device: DeviceLike = "cuda"):
        self.dtype = pool_dtype(dtype)            # float32 or bfloat16
        self.host_dtype = host_dtype(self.dtype)  # slabs and blobs on the host
        self.device = resolve_device(device)
        self.cluster = cluster
        self.scheduler = ClusterScheduler(cluster)
        self.num_layers = num_layers
        self.page_tokens = page_tokens
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.hbm_pages_per_node = hbm_pages_per_node
        self.host_budget_bytes = host_budget_bytes
        self.replicate = replicate
        self.prefill_deadline_s = (cluster.admission_deadline_s
                                   if prefill_deadline_s is None
                                   else prefill_deadline_s)
        self.sessions: Dict[int, Session] = {}
        self._shards: Dict[int, KVShard] = {}
        self._hooks: Dict[str, Callable[[], None]] = {}
        self.stats = {"admitted": 0, "diverted": 0, "prefill_refusals": 0,
                      "failovers": 0, "decode_steps": 0}

    # -- geometry -------------------------------------------------------------
    @property
    def slab_shape(self) -> Tuple[int, ...]:
        return (self.num_layers, self.page_tokens, 2, self.kv_heads,
                self.head_dim)

    @property
    def slab_nbytes(self) -> int:
        return int(np.prod(self.slab_shape)) * self.host_dtype.itemsize

    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_tokens)

    def _expected_slab(self, seq_id: int, page_index: int,
                       length: int) -> np.ndarray:
        return expected_page_slab(
            seq_id, page_index, length, num_layers=self.num_layers,
            page_tokens=self.page_tokens, kv_heads=self.kv_heads,
            head_dim=self.head_dim, dtype=self.dtype)

    # -- fault-injection hooks (tests SIGKILL nodes at phase boundaries) ------
    def add_fault_hook(self, phase: str, fn: Callable[[], None]) -> None:
        """Register a one-shot callback fired at a serving phase boundary:
        ``after_admit`` | ``mid_decode`` | ``during_restore`` |
        ``during_spill``."""
        self._hooks[phase] = fn

    def _fire(self, phase: str) -> None:
        fn = self._hooks.pop(phase, None)
        if fn is not None:
            fn()

    # -- topology helpers -----------------------------------------------------
    def _alive(self, node_id: int) -> bool:
        node = self.cluster.nodes.get(node_id)
        return bool(node is not None and node.alive)

    def _memory(self, node_id: int):
        node = self.cluster.nodes.get(node_id)
        return node.memory if node is not None and node.alive else None

    def _affinity(self, seq_id: int) -> int:
        """Session affinity: hash over the FULL membership (stable while
        nodes bounce), walking forward past dead nodes."""
        ids = sorted(self.cluster.nodes)
        h = zlib.crc32(f"seq{seq_id}".encode()) % len(ids)
        for k in range(len(ids)):
            node = ids[(h + k) % len(ids)]
            if self._alive(node):
                return node
        raise DeadNodeError("no alive nodes to serve on")

    def _next_alive(self, after: int, *exclude: int) -> Optional[int]:
        ids = sorted(self.cluster.nodes)
        start = ids.index(after) if after in ids else 0
        for k in range(1, len(ids) + 1):
            node = ids[(start + k) % len(ids)]
            if node not in exclude and node != after and self._alive(node):
                return node
        return None

    def _replica_for(self, primary: int) -> Optional[int]:
        return self._next_alive(primary) if self.replicate else None

    def _spill_target(self, home: int) -> Optional[int]:
        return self._next_alive(home)

    def _shard(self, node_id: int) -> KVShard:
        shard = self._shards.get(node_id)
        if shard is None:
            shard = self._shards[node_id] = KVShard(self, node_id)
        return shard

    def _drop_shard(self, node_id: int) -> None:
        shard = self._shards.pop(node_id, None)
        if shard is not None:
            shard.store.close()

    # -- admission (continuous-batching front end) ----------------------------
    def admit(self, prompts: Dict[int, int]) -> PlacementPlan:
        """Admit a batch of prefills: ``prompts`` maps ``seq_id -> prompt
        tokens``.  Each prefill probes its affinity node with a speculative
        ``urgency="low"`` grant; refused prefills are placed through
        ``place_sequences`` and may be diverted to admitting nodes.  Returns
        the placement plan (``plan.diversions`` names the re-routes)."""
        plan = PlacementPlan(placement={}, diversions={})
        asks: Dict[int, Tuple[int, int]] = {}
        for seq_id, prompt_len in prompts.items():
            if seq_id in self.sessions:
                raise ValueError(f"sequence {seq_id} already active")
            nbytes = self._pages_for(prompt_len) * self.slab_nbytes
            affinity = self._affinity(seq_id)
            if not self.cluster.admission:
                plan.placement[seq_id] = affinity    # always-grant baseline
                continue
            memory = self._memory(affinity)
            probe = None
            if memory is not None:
                try:
                    probe = memory.try_reserve(nbytes, urgency="low")
                except DeadNodeError:
                    probe = None
            if probe is not None:
                probe.release()   # probe only; prefill re-charges when it runs
                plan.placement[seq_id] = affinity
            else:
                self.stats["prefill_refusals"] += 1
                asks[seq_id] = (affinity, nbytes)
        if asks:
            routed = self.scheduler.place_sequences(
                asks, deadline_s=self.prefill_deadline_s)
            plan.placement.update(routed.placement)
            plan.diversions.update(routed.diversions)
            plan.refusals += routed.refusals
            self.stats["diverted"] += routed.diverted
        for seq_id, prompt_len in prompts.items():
            self._start_session(seq_id, prompt_len, plan.placement[seq_id])
            self.stats["admitted"] += 1
        return plan

    def _start_session(self, seq_id: int, prompt_len: int, node: int) -> None:
        last: Optional[DeadNodeError] = None
        for _attempt in range(len(self.cluster.nodes) + 1):
            if not self._alive(node):
                node = self._affinity(seq_id)
            try:
                self._prefill(seq_id, prompt_len, node)
                return
            except DeadNodeError as e:
                last = e
                self._abort_partial(seq_id, node)
                nxt = self._next_alive(node)
                if nxt is None:
                    break
                node = nxt
        raise last or DeadNodeError("no alive nodes to prefill on")

    def _prefill(self, seq_id: int, prompt_len: int, node: int) -> None:
        shard = self._shard(node)
        nbytes = self._pages_for(prompt_len) * self.slab_nbytes
        res = None
        if self.cluster.admission:
            memory = self._memory(node)
            if memory is None:
                raise DeadNodeError(f"node {node} died before prefill")
            res = memory.try_reserve(
                nbytes, urgency="required",
                timeout=self.cluster.admission_timeout_s)
        try:
            shard.cache.start_sequence(seq_id)
            sess = Session(seq_id, node, None, 0, prompt_len)
            self.sessions[seq_id] = sess
            self._fire("after_admit")
            shard.cache.ensure_capacity(seq_id, prompt_len)
            shard.cache.advance(seq_id, prompt_len)
            for k in range(self._pages_for(prompt_len)):
                shard.cache.write_page(
                    seq_id, k, self._expected_slab(seq_id, k, prompt_len))
            sess.replica = self._replica_for(node)
            self._replicate_all(sess)
            sess.length = prompt_len
            if not self._alive(node):
                raise DeadNodeError(f"node {node} died during prefill")
        finally:
            if res is not None:
                res.release()

    def _abort_partial(self, seq_id: int, node: int) -> None:
        """Unwind a prefill that died half way: free the partial locality
        set (or the whole shard if its node is gone) and the replica blobs."""
        sess = self.sessions.pop(seq_id, None)
        shard = self._shards.get(node)
        if shard is not None and not self._alive(node):
            self._drop_shard(node)
        elif shard is not None and seq_id in shard.cache.active_sequences():
            shard.cache.finish_sequence(seq_id)
        if sess is not None and sess.replica is not None:
            for k in range(self._pages_for(sess.prompt_len)):
                self.cluster.drop_bytes(sess.replica, self._rep_name(seq_id, k))

    # -- replication ----------------------------------------------------------
    def _rep_name(self, seq_id: int, page_index: int) -> str:
        return f"kvrep/{seq_id}/{page_index}"

    def _replicate_all(self, sess: Session) -> None:
        """Ship every current page slab of the sequence to its replica
        holder; on replica death, re-pick and retry once (degrading to
        no-replica only when no other node is alive)."""
        for _attempt in (0, 1):
            if sess.replica is None:
                return
            try:
                shard = self._shard(sess.node)
                npages = shard.cache.num_pages(sess.seq_id)
                for k in range(npages):
                    slab = shard.cache.read_page(sess.seq_id, k)
                    self.cluster.store_bytes(
                        sess.replica, self._rep_name(sess.seq_id, k),
                        slab.tobytes())
                return
            except DeadNodeError:
                sess.replica = self._replica_for(sess.node)
        sess.replica = None

    def _sync_replica(self, sess: Session, page_index: int,
                      slab: np.ndarray) -> None:
        if sess.replica is None:
            return
        try:
            self.cluster.store_bytes(
                sess.replica, self._rep_name(sess.seq_id, page_index),
                slab.tobytes())
        except DeadNodeError:
            sess.replica = self._replica_for(sess.node)
            self._replicate_all(sess)

    # -- decode ---------------------------------------------------------------
    def decode(self, seq_ids: List[int], steps: int = 1) -> Dict[int, int]:
        """Run ``steps`` decode iterations over the batch (continuous
        batching: each sequence advances independently, surviving node
        deaths via replica failover).  Returns ``seq_id -> new length``."""
        out = {}
        for _ in range(steps):
            for seq_id in seq_ids:
                out[seq_id] = self._decode_one(seq_id)
        return out

    def _decode_one(self, seq_id: int) -> int:
        last: Optional[DeadNodeError] = None
        for _attempt in range(len(self.cluster.nodes) + 1):
            sess = self.sessions[seq_id]
            if not self._alive(sess.node):
                self._failover(seq_id)
                continue
            try:
                self._decode_commit(sess)
                if not self._alive(sess.node):
                    raise DeadNodeError(
                        f"serving node {sess.node} died mid-decode")
                self.stats["decode_steps"] += 1
                return sess.length
            except DeadNodeError as e:
                last = e
                self._failover(seq_id)
        raise last or DeadNodeError(f"decode of sequence {seq_id} failed")

    def _decode_commit(self, sess: Session) -> None:
        seq_id = sess.seq_id
        shard = self._shard(sess.node)
        new_len = sess.length + 1
        needs_page = self._pages_for(new_len) > shard.cache.num_pages(seq_id)
        self._fire("mid_decode")
        res = None
        if needs_page and self.cluster.admission:
            memory = self._memory(sess.node)
            if memory is None:
                raise DeadNodeError(f"node {sess.node} died mid-decode")
            # in-flight decode must not stall out: forced through, paced
            # against the node's grant exactly like shuffle reducer pulls
            res = memory.try_reserve(
                self.slab_nbytes, urgency="required",
                timeout=self.cluster.admission_timeout_s)
        try:
            shard.cache.ensure_capacity(seq_id, new_len - sess.length)
            shard.cache.advance(seq_id, new_len - sess.length)
            p = (new_len - 1) // self.page_tokens
            slab = self._expected_slab(seq_id, p, new_len)
            shard.cache.write_page(seq_id, p, slab)
            self._sync_replica(sess, p, slab)
            sess.length = new_len
        finally:
            if res is not None:
                res.release()

    # -- failover -------------------------------------------------------------
    def _failover(self, seq_id: int) -> None:
        """Re-home a session whose primary died (or whose restore path
        failed): rebuild the sequence on the replica holder from its
        replicated page slabs and resume byte-identically.  Without a live
        replica the session honors the shuffle contract and demands a
        re-run."""
        sess = self.sessions[seq_id]
        old = sess.node
        shard = self._shards.get(old)
        if shard is not None and not self._alive(old):
            self._drop_shard(old)
        elif (shard is not None
              and seq_id in shard.cache.active_sequences()):
            shard.cache.finish_sequence(seq_id)
        rep = sess.replica
        if rep is None or not self._alive(rep):
            raise DeadNodeError(
                f"serving node {old} died with no live replica for "
                f"sequence {seq_id}; the session must re-run")
        npages = self._pages_for(sess.length)
        try:
            slabs = [np.frombuffer(
                self.cluster.load_bytes(rep, self._rep_name(seq_id, k)),
                self.host_dtype).reshape(self.slab_shape).copy()
                for k in range(npages)]
        except KeyError as e:
            raise DeadNodeError(
                f"replica of sequence {seq_id} is missing page {e}; "
                f"the session must re-run")
        new_shard = self._shard(rep)
        new_shard.cache.start_sequence(seq_id)
        new_shard.cache.ensure_capacity(seq_id, sess.length)
        new_shard.cache.advance(seq_id, sess.length)
        for k, slab in enumerate(slabs):
            new_shard.cache.write_page(seq_id, k, slab)
        sess.node = rep
        sess.replica = self._replica_for(rep)
        self._replicate_all(sess)
        for k in range(npages):      # the new primary stops holding blobs
            self.cluster.drop_bytes(rep, self._rep_name(seq_id, k))
        self.stats["failovers"] += 1

    # -- reads ----------------------------------------------------------------
    def _live_session(self, seq_id: int) -> Session:
        sess = self.sessions[seq_id]
        if not self._alive(sess.node):
            self._failover(seq_id)
            sess = self.sessions[seq_id]
        return sess

    def block_table(self, seq_id: int,
                    max_pages: Optional[int] = None) -> np.ndarray:
        sess = self._live_session(seq_id)
        shard = self._shard(sess.node)
        mp = (shard.cache.num_pages(seq_id) if max_pages is None
              else max_pages)
        return shard.cache.block_table(seq_id, mp)

    def sequence_slabs(self, seq_id: int) -> List[np.ndarray]:
        sess = self._live_session(seq_id)
        return self._shard(sess.node).cache.sequence_slabs(seq_id)

    def expected_slabs(self, seq_id: int) -> List[np.ndarray]:
        sess = self.sessions[seq_id]
        return [self._expected_slab(seq_id, k, sess.length)
                for k in range(self._pages_for(sess.length))]

    def verify(self, seq_id: int) -> bool:
        """Byte-identity of the session's KV against the deterministic
        oracle, across every spill level and after any failover."""
        got = self.sequence_slabs(seq_id)
        want = self.expected_slabs(seq_id)
        return (len(got) == len(want)
                and all(a.tobytes() == b.tobytes()
                        for a, b in zip(got, want)))

    def attend(self, seq_ids: List[int], layer: int = 0,
               impl: str = "xla") -> Dict[int, np.ndarray]:
        """Run paged decode attention for a batch (grouped by shard — each
        shard is one device pool, read in place).  The q vectors are
        deterministic too, so outputs are comparable across backends.
        ``impl="kernel"`` launches the CUDA paged kernel once a shard, at
        the tier's dtype (its plain version on a CPU pool); ``"xla"`` is the
        plain version. Results are ``[KH, D]`` arrays in the host form of
        the tier's dtype (bf16 as ``np.uint16`` bits)."""
        by_shard: Dict[int, List[int]] = {}
        for s in seq_ids:
            by_shard.setdefault(self._live_session(s).node, []).append(s)
        out: Dict[int, np.ndarray] = {}
        for node, seqs in by_shard.items():
            shard = self._shard(node)
            max_pages = max(shard.cache.num_pages(s) for s in seqs)
            tables = np.stack([shard.cache.block_table(s, max_pages)
                               for s in seqs])
            lengths = np.array([self.sessions[s].length for s in seqs],
                               np.int32)
            q = np.stack([np.full(
                (self.kv_heads, self.head_dim),
                host_array(token_value(s, self.sessions[s].length),
                           self.dtype)) for s in seqs])
            pool = shard.cache.kv[layer]
            r = paged_attention(host_to_tensor(q, self.dtype).to(pool.device),
                                pool, tables, lengths, impl=impl)
            r = tensor_to_host(r)
            for i, s in enumerate(seqs):
                out[s] = r[i]
        return out

    # -- lifecycle ------------------------------------------------------------
    def finish(self, seq_id: int) -> None:
        sess = self.sessions.pop(seq_id)
        shard = self._shards.get(sess.node)
        if (shard is not None and self._alive(sess.node)
                and seq_id in shard.cache.active_sequences()):
            shard.cache.finish_sequence(seq_id)
        elif shard is not None and not self._alive(sess.node):
            self._drop_shard(sess.node)
        if sess.replica is not None:
            for k in range(self._pages_for(sess.length)):
                self.cluster.drop_bytes(sess.replica,
                                        self._rep_name(seq_id, k))

    def close(self) -> None:
        for seq_id in list(self.sessions):
            self.finish(seq_id)
        for node_id in list(self._shards):
            self._drop_shard(node_id)
        if self.cluster._transfer is not None:
            self.cluster.transfer.drain(timeout=10.0)

    def pressure_report(self):
        return self.cluster.pressure_report()
