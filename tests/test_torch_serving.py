"""The port's distributed serving tier (``repro_torch.runtime.serving``) and
the cluster runtime under it, on the CPU.

Every test of the JAX package's ``tests/test_serving.py`` is mirrored here on
the port (``device="cpu"``), on both backends where the reference runs both.
The cross-package tests run one admit/decode/kill/finish script on the JAX
tier and on the port's tier over inproc clusters and hold them together:
equal stats, equal block tables, byte-identical slabs at every step, and
``attend`` within 2e-5 for every pair of ``impl`` (the JAX kernel runs as
interpreted Pallas on the CPU, the port's as its plain version). The same
script runs at a bf16 pool, where ``attend`` is held within 2e-2 (the JAX
package's bf16 tolerance) of the JAX tier's and of fp64 dense attention over
the oracle's K/V.
"""
import functools
import os
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import PagedKVCache
from repro_torch.core.kvcache import host_array, host_to_tensor
from repro_torch.core import sanitizer as port_sanitizer
from repro_torch.runtime import rpc as port_rpc
from repro_torch.runtime.cluster import Cluster, DeadNodeError
from repro_torch.runtime.serving import ServingTier, expected_page_slab

torch.set_num_threads(2)

BACKENDS = ("inproc", "proc")
ATOL = RTOL = 2e-5
TOL16 = 2e-2                  # the JAX package's bf16 tolerance


@pytest.fixture(autouse=True)
def _port_isolation(request):
    """The port keeps its own wire counters and sanitizer state: zeroed per
    test, as conftest does for the JAX package's."""
    port_rpc.reset_counters()
    if port_sanitizer.enabled():
        port_sanitizer.reset()
    yield
    if port_sanitizer.enabled():
        port_sanitizer.assert_clean(request.node.nodeid)


def _cluster(backend, tmp_path=None, **kw):
    kw.setdefault("node_capacity", 8 << 20)
    kw.setdefault("page_size", 1 << 14)
    kw.setdefault("replication_factor", 1)
    kw.setdefault("admission", True)
    if tmp_path is not None:
        kw.setdefault("spill_dir", os.path.join(str(tmp_path), "spill"))
    if backend == "proc":
        return Cluster(4, backend="proc", **kw)
    return Cluster(4, **kw)


def _teardown(cluster, backend):
    if backend == "proc":
        report = cluster.close()
        assert report.ok, report
    else:
        cluster.shutdown()


def _assert_clean(cluster):
    """No leaked reservations on any alive node (nor the driver)."""
    for nid, rep in cluster.pressure_report().items():
        assert rep["reserved"] == 0, (nid, rep)


def _settle(cluster, store):
    """Wait until no level-3 copy of ``store`` is in flight."""
    while store._inflight:
        cluster.transfer.drain(timeout=10.0)
        store._reap()


def _tier(cluster, **kw):
    kw.setdefault("hbm_pages_per_node", 4)
    kw.setdefault("host_budget_bytes", 2048)
    kw.setdefault("device", "cpu")
    return ServingTier(cluster, **kw)


# -- admission + diversion ----------------------------------------------------
def test_prefill_diverted_off_pressured_affinity_node(tmp_path):
    cluster = _cluster("inproc", tmp_path, node_capacity=1 << 20,
                       pressure_watermark=0.5)
    tier = _tier(cluster)
    seq = 11
    affinity = tier._affinity(seq)
    # ballast the affinity node past its watermark so the speculative
    # low-urgency probe AND the placement probe both refuse
    mm = cluster.nodes[affinity].memory
    ballast = mm.reserve(int(0.9 * (1 << 20)))
    mm.note_alloc(600 << 10)
    plan = tier.admit({seq: 8})
    assert plan.placement[seq] != affinity
    assert plan.diversions[seq][0] == affinity
    assert tier.stats["prefill_refusals"] == 1
    assert tier.verify(seq)
    ballast.release()
    mm.note_free(600 << 10)
    tier.close()
    _assert_clean(cluster)
    _teardown(cluster, "inproc")


def test_always_grant_baseline_never_diverts(tmp_path):
    cluster = _cluster("inproc", tmp_path, admission=False,
                       node_capacity=1 << 20)
    tier = _tier(cluster)
    plan = tier.admit({i: 8 for i in range(6)})
    assert plan.diversions == {}
    for i in range(6):
        assert plan.placement[i] == tier._affinity(i)
    tier.decode(list(range(6)), steps=4)
    assert all(tier.verify(i) for i in range(6))
    tier.close()
    _teardown(cluster, "inproc")


# -- three-level spill --------------------------------------------------------
def test_three_level_spill_round_trips_byte_identically(tmp_path):
    """A sequence bigger than the pool with a tiny host budget pushes slabs
    through all three levels; reading the whole sequence back (block_table
    restore) faults them home byte-identically."""
    cluster = _cluster("inproc", tmp_path)
    tier = _tier(cluster, hbm_pages_per_node=3, host_budget_bytes=1024)
    tier.admit({7: 20})           # 5 pages > 3 pool slots
    tier.decode([7], steps=12)    # 32 tokens = 8 pages
    shard = tier._shards[tier.sessions[7].node]
    assert shard.store.stats["host_puts"] > 0          # level 2 hit
    _settle(cluster, shard.store)
    assert shard.store.stats["remote_spills"] > 0      # level 3 hit
    table = tier.block_table(7)   # restores every page for the kernel
    assert (table >= 0).all()
    assert shard.store.stats["remote_fetches"] > 0     # level 3 faulted back
    assert tier.verify(7)
    tier.close()
    _assert_clean(cluster)
    _teardown(cluster, "inproc")


def test_host_slabs_charge_the_nodes_memory_manager(tmp_path):
    cluster = _cluster("inproc", tmp_path)
    tier = _tier(cluster, hbm_pages_per_node=2,
                 host_budget_bytes=None)   # level 2 only, uncapped
    tier.admit({3: 16})
    node = tier.sessions[3].node
    assert cluster.nodes[node].memory.reserved_bytes > 0   # slabs charged
    tier.finish(3)
    _assert_clean(cluster)                                  # and released
    tier.close()
    _teardown(cluster, "inproc")


# -- fault-injection sweep ----------------------------------------------------
PHASES = ("after_admit", "mid_decode", "during_restore", "during_spill")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("phase", PHASES)
def test_kill_at_phase_boundary_resumes_byte_identically(
        tmp_path, backend, phase):
    """kill_node/SIGKILL at each serving phase boundary: the session must
    resume on its replica with byte-identical block-table contents, and no
    reservation may leak on any surviving node."""
    cluster = _cluster(backend, tmp_path)
    # budget 0 forces every eviction to level 3 so restore/spill phases fire
    tier = _tier(cluster, hbm_pages_per_node=3,
                 host_budget_bytes=0 if phase in ("during_restore",
                                                  "during_spill") else 1024)
    seqs = {1: 10, 2: 6}
    if phase == "after_admit":
        # the hook fires inside the prefill of the first admitted sequence
        tier.add_fault_hook(
            "after_admit",
            lambda: cluster.kill_node(tier.sessions[1].node))
        tier.admit(seqs)
    else:
        tier.admit(seqs)
        tier.decode([1, 2], steps=4)
        tier.add_fault_hook(
            phase, lambda: cluster.kill_node(tier.sessions[1].node))
    pre = {s: [x.copy() for x in tier.sequence_slabs(s)] for s in seqs}
    pre_len = {s: tier.sessions[s].length for s in seqs}
    if phase == "during_restore":
        # a whole-sequence read faults level-3 slabs home: the hook fires
        # inside the restore itself (spilled state settled first so the
        # restore genuinely comes from the remote tier)
        cluster.transfer.drain(timeout=10.0)
        tier._shards[tier.sessions[1].node].store._reap()
        tier.block_table(1)
    tier.decode([1, 2], steps=6)
    if phase != "after_admit":
        assert tier.stats["failovers"] >= 1, tier.stats
    for s in seqs:
        assert tier.verify(s), f"seq {s} diverged after {phase} kill"
        # committed pre-kill prefix is byte-identical on the new home
        now = tier.sequence_slabs(s)
        full = pre_len[s] // tier.page_tokens   # pages full before the kill
        for k in range(full):
            assert now[k].tobytes() == pre[s][k].tobytes()
        assert (tier.block_table(s) >= 0).all()
    for s in seqs:
        tier.finish(s)
    _assert_clean(cluster)
    tier.close()
    # no envelope value was ever refused as non-JSON
    assert port_rpc.pickle_fallbacks() == 0
    _teardown(cluster, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sigkill_mid_decode_without_replica_demands_rerun(tmp_path, backend):
    """The shuffle contract, honored verbatim: a dead serving node with no
    live replica raises DeadNodeError demanding a re-run."""
    cluster = _cluster(backend, tmp_path, replication_factor=0)
    tier = _tier(cluster, replicate=False)
    tier.admit({5: 8})
    tier.decode([5], steps=2)
    cluster.kill_node(tier.sessions[5].node)
    with pytest.raises(DeadNodeError, match="re-run"):
        tier.decode([5], steps=1)
    tier.close()
    _teardown(cluster, backend)


def test_spill_target_death_mid_transfer_loses_nothing(tmp_path):
    """Killing the level-3 spill *target* while a slab transfer is in
    flight must not lose the slab: the host copy is only dropped after the
    transfer confirms."""
    cluster = _cluster("inproc", tmp_path)
    tier = _tier(cluster, hbm_pages_per_node=3, host_budget_bytes=0)
    tier.admit({9: 10})
    node = tier.sessions[9].node
    target = tier._spill_target(node)
    tier.add_fault_hook("during_spill", lambda: cluster.kill_node(target))
    tier.decode([9], steps=8)
    store = tier._shards[tier.sessions[9].node].store
    cluster.transfer.drain(timeout=10.0)
    store._reap()
    assert tier.verify(9)    # every slab still reachable, byte-identical
    tier.close()
    _assert_clean(cluster)
    _teardown(cluster, "inproc")


def test_replica_death_repicks_and_survives_primary_death_later(tmp_path):
    cluster = _cluster("inproc", tmp_path)
    tier = _tier(cluster)
    tier.admit({4: 8})
    tier.decode([4], steps=2)
    sess = tier.sessions[4]
    cluster.kill_node(sess.replica)          # replica dies first
    tier.decode([4], steps=2)                # re-picks + re-ships
    assert sess.replica is not None and tier._alive(sess.replica)
    cluster.kill_node(sess.node)             # then the primary
    tier.decode([4], steps=2)
    assert tier.stats["failovers"] >= 1
    assert tier.verify(4)
    tier.close()
    _assert_clean(cluster)
    _teardown(cluster, "inproc")


# -- attention over the serving pool ------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_attend_runs_kernel_and_xla_identically_after_failover(
        tmp_path, backend):
    cluster = _cluster(backend, tmp_path)
    tier = _tier(cluster)
    tier.admit({1: 6, 2: 9})
    tier.decode([1, 2], steps=3)
    cluster.kill_node(tier.sessions[1].node)
    tier.decode([1, 2], steps=2)
    xla = tier.attend([1, 2], impl="xla")
    ker = tier.attend([1, 2], impl="kernel")
    for s in (1, 2):
        assert xla[s].shape == (tier.kv_heads, tier.head_dim)
        np.testing.assert_allclose(xla[s], ker[s], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ker[s], _dense_attend(tier, s),
                                   rtol=RTOL, atol=ATOL)
    tier.close()
    _teardown(cluster, backend)


def _dense_attend(tier, seq_id, layer=0):
    """fp64 softmax attention of the session's q over its K/V as the oracle
    (``expected_slabs``) has them, not as the pool holds them."""
    from repro_torch.runtime.serving import token_value
    length = tier.sessions[seq_id].length
    kv = _floats(np.concatenate(tier.expected_slabs(seq_id), axis=1)
                 [layer, :length])
    k, v = kv[:, 0], kv[:, 1]
    q = np.full((tier.kv_heads, tier.head_dim),
                _floats(host_array(token_value(seq_id, length), tier.dtype)))
    s = np.einsum("hd,thd->ht", q, k) / np.sqrt(tier.head_dim)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    return np.einsum("ht,thd->hd", p, v)


def _floats(a):
    """A tier's host-form values as float64: bf16 bits (``np.uint16``), the
    JAX tier's ml_dtypes bfloat16 or fp32."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        a = (a.astype(np.uint32) << np.uint32(16)).view(np.float32)
    return a.astype(np.float64)


# -- property: random op interleavings vs unlimited-HBM reference -------------
_OPS = st.lists(
    st.tuples(st.integers(min_value=0, max_value=3),    # action
              st.integers(min_value=0, max_value=2),    # session slot
              st.integers(min_value=1, max_value=6)),   # tokens / steps
    min_size=4, max_size=24)


def _ref_extend(tier, ref, sid, old_len, new_len):
    """Mirror a tier prefill/decode into the reference cache."""
    ref.ensure_capacity(sid, new_len - old_len)
    ref.advance(sid, new_len - old_len)
    first = old_len // tier.page_tokens     # tail page may be rewritten
    for k in range(first, -(-new_len // tier.page_tokens)):
        ref.write_page(sid, k, tier._expected_slab(sid, k, new_len))


def _assert_matches_ref(tier, ref, sid):
    assert tier.sessions[sid].length == ref.seq_length(sid)
    mine = tier.sequence_slabs(sid)
    theirs = ref.sequence_slabs(sid)
    assert len(mine) == len(theirs)
    for k, (a, b) in enumerate(zip(mine, theirs)):
        assert a.tobytes() == b.tobytes(), (sid, k)


@settings(max_examples=10, deadline=None)
@given(ops=_OPS)
def test_random_interleavings_match_unlimited_hbm_reference(ops):
    """Any interleaving of admit/decode/read/finish over the spilling tier
    (3 pool slots, 512-byte host budget => all three spill levels exercised)
    stays byte-identical to a reference PagedKVCache with an unlimited pool
    that never evicts, spills, or restores."""
    cluster = Cluster(3, node_capacity=8 << 20, page_size=1 << 14,
                      replication_factor=1, admission=True)
    tier = ServingTier(cluster, hbm_pages_per_node=3, host_budget_bytes=512,
                       device="cpu")
    ref = PagedKVCache(num_layers=tier.num_layers, hbm_pages=512,
                       page_size=tier.page_tokens, kv_heads=tier.kv_heads,
                       head_dim=tier.head_dim, device="cpu")
    try:
        lengths = {}
        for action, slot, n in ops:
            sid = 100 + slot
            if action == 0 and sid not in tier.sessions:
                tier.admit({sid: n})
                ref.start_sequence(sid)
                _ref_extend(tier, ref, sid, 0, n)
                lengths[sid] = n
            elif action == 1 and sid in lengths:
                tier.decode([sid], steps=n)
                _ref_extend(tier, ref, sid, lengths[sid], lengths[sid] + n)
                lengths[sid] += n
            elif action == 2 and sid in lengths:
                assert tier.verify(sid)
                assert (tier.block_table(sid) >= 0).all()
                _assert_matches_ref(tier, ref, sid)
            elif action == 3 and sid in lengths:
                tier.finish(sid)
                ref.finish_sequence(sid)
                del lengths[sid]
        for sid in list(lengths):
            _assert_matches_ref(tier, ref, sid)
    finally:
        tier.close()
    _assert_clean(cluster)
    _teardown(cluster, "inproc")


# -- oracle sanity ------------------------------------------------------------
def test_expected_page_slab_is_deterministic_and_masked():
    a = expected_page_slab(3, 1, 6, num_layers=2, page_tokens=4,
                           kv_heads=2, head_dim=4)
    b = expected_page_slab(3, 1, 6, num_layers=2, page_tokens=4,
                           kv_heads=2, head_dim=4)
    assert a.tobytes() == b.tobytes()
    assert (a[:, 2:] == 0).all()      # positions 6,7 past the length
    assert (a[:, :2] != 0).all()


def test_expected_page_slab_matches_the_jax_package():
    from repro.runtime import serving as jax_serving
    for seq, page, length in ((3, 1, 6), (0, 0, 1), (91, 4, 100)):
        kw = dict(num_layers=2, page_tokens=8, kv_heads=2, head_dim=4)
        assert (expected_page_slab(seq, page, length, **kw).tobytes()
                == jax_serving.expected_page_slab(seq, page, length,
                                                  **kw).tobytes())


# -- what the port refuses ----------------------------------------------------
def test_rpc_refuses_values_that_are_not_json():
    import socket
    a, b = socket.socketpair()
    try:
        before = port_rpc.pickle_fallbacks()
        with pytest.raises(TypeError, match="complex"):
            port_rpc.send_msg(a, {"op": "x", "value": 1j})
        assert port_rpc.pickle_fallbacks() == before + 1
        # numpy scalars are routine and stay JSON
        port_rpc.send_msg(a, {"op": "y", "n": np.int64(7)})
        meta, raw = port_rpc.recv_msg(b)
        assert meta == {"op": "y", "n": 7} and raw == b""
    finally:
        a.close()
        b.close()


def test_rpc_handler_reply_that_is_not_json_is_an_error_reply():
    import socket
    a, b = socket.socketpair()
    server = threading.Thread(target=port_rpc.serve_connection, args=(
        b, {"bad": lambda meta, raw: {"value": object()},
            "close": lambda meta, raw: None}), daemon=True)
    server.start()
    conn = port_rpc.RpcConnection(a, timeout_s=10.0)
    try:
        with pytest.raises(port_rpc.RemoteError, match="TypeError"):
            conn.call("bad")
        conn.call("close")         # the node loop survived the bad reply
    finally:
        server.join(timeout=10.0)
        conn.close()
        b.close()


def test_tier_refuses_cuda_without_a_card_and_a_pool_not_fp32():
    """No card: the default device raises. A pool of any dtype but fp32 and
    bf16 raises a TypeError that names the two."""
    cluster = Cluster(2, node_capacity=1 << 20, page_size=1 << 14)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                ServingTier(cluster)
        for bad in (np.float16, torch.float16, np.float64, np.int8,
                    torch.float64, "int32"):
            with pytest.raises(TypeError, match="float32 or bfloat16"):
                ServingTier(cluster, dtype=bad, device="cpu")
        for good, host in ((np.float32, np.float32), ("float32", np.float32),
                           (torch.bfloat16, np.uint16),
                           ("bfloat16", np.uint16)):
            tier = ServingTier(cluster, dtype=good, device="cpu")
            assert tier.host_dtype == host
            assert tier.slab_nbytes == 2 * 4 * 2 * 2 * 4 * np.dtype(
                host).itemsize
    finally:
        cluster.shutdown()


# -- the port's tier against the JAX package's tier ---------------------------
GEOMS = {
    # the reference tests' geometry, and a wider one (more layers, heads and
    # head dim, longer pages) with few slots so every level spills
    "default": dict(hbm_pages_per_node=3, host_budget_bytes=1024),
    "wide": dict(num_layers=3, page_tokens=8, kv_heads=2, head_dim=16,
                 hbm_pages_per_node=4, host_budget_bytes=3 * 8 * 2 * 2
                 * 16 * 4),
}


def _pair(geom, **kw):
    from repro.runtime.cluster import Cluster as JaxCluster
    from repro.runtime.serving import ServingTier as JaxTier
    ckw = dict(node_capacity=8 << 20, page_size=1 << 14,
               replication_factor=1, admission=True)
    jc, pc = JaxCluster(4, **ckw), Cluster(4, **ckw)
    tkw = dict(GEOMS[geom], **kw)
    return (jc, JaxTier(jc, **tkw)), (pc, ServingTier(pc, device="cpu",
                                                      **tkw))


def _assert_same_state(jt, pt, seqs, what):
    assert jt.stats == pt.stats, what
    for s in seqs:
        assert vars(jt.sessions[s]) == vars(pt.sessions[s]), (what, s)
        jt_table, pt_table = jt.block_table(s), pt.block_table(s)
        np.testing.assert_array_equal(jt_table, pt_table, err_msg=what)
        a, b = jt.sequence_slabs(s), pt.sequence_slabs(s)
        assert len(a) == len(b), (what, s)
        for k, (x, y) in enumerate(zip(a, b)):
            assert x.tobytes() == y.tobytes(), (what, s, k)
        assert pt.verify(s), (what, s)


def _assert_same_attend(jt, pt, seqs, what, layers=(0,)):
    for layer in layers:
        # per-shard batches whose pages fit a pool: a restore inside one
        # batch's block tables can evict another table's page (the cache's
        # _alloc_slot ignores exclude_set, in both packages)
        for s in seqs:
            outs = {f"jax-{impl}": jt.attend([s], layer, impl=impl)[s]
                    for impl in ("kernel", "xla")}
            outs.update({f"port-{impl}": pt.attend([s], layer, impl=impl)[s]
                         for impl in ("kernel", "xla")})
            ref = outs["jax-xla"]
            for name, out in outs.items():
                np.testing.assert_allclose(
                    out, ref, rtol=RTOL, atol=ATOL,
                    err_msg=f"{what}: seq {s} layer {layer} {name}")


# one admit / decode / kill / finish script, run on both tiers side by side
SCRIPT = [
    ("admit", {1: 6, 2: 9, 3: 3}),
    ("decode", [1, 2, 3], 5),
    ("attend",),
    ("decode", [2], 7),
    ("kill", 2),
    ("decode", [1, 2, 3], 3),
    ("attend",),
    ("finish", 3),
    ("admit", {4: 11}),
    ("decode", [1, 2, 4], 4),
    ("attend",),
]


def _run_script(jax_pair, port_pair, assert_state, assert_attend):
    """``SCRIPT`` on both tiers, each step then held by ``assert_state``
    and, after an attend step, by ``assert_attend`` at every layer."""
    (jc, jt), (pc, pt) = jax_pair, port_pair
    layers = range(jt.num_layers)
    for step, op in enumerate(SCRIPT):
        what = f"step {step} {op[0]}"
        for tier, cluster in ((jt, jc), (pt, pc)):
            if op[0] == "admit":
                plan = tier.admit(op[1])
                assert plan.diversions == {}
            elif op[0] == "decode":
                tier.decode(op[1], steps=op[2])
            elif op[0] == "kill":
                cluster.kill_node(tier.sessions[op[1]].node)
            elif op[0] == "finish":
                tier.finish(op[1])
        live = sorted(pt.sessions)
        assert sorted(jt.sessions) == live, what
        if op[0] == "attend":
            assert_attend(jt, pt, live, what, layers)
        assert_state(jt, pt, live, what)
    assert pt.stats["failovers"] >= 1


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_port_tier_matches_the_jax_tier_step_by_step(geom):
    (jc, jt), (pc, pt) = _pair(geom)
    try:
        _run_script((jc, jt), (pc, pt), _assert_same_state,
                    _assert_same_attend)
    finally:
        jt.close()
        pt.close()
        jc.shutdown()
        pc.shutdown()


# -- the bf16 tier (the configs' kv_cache_dtype) -------------------------------
def _geom16(geom):
    """``GEOMS[geom]`` with the host budget in the same number of slabs at
    bf16's 2-byte elements, so that every level spills as it does in fp32."""
    kw = dict(GEOMS[geom])
    kw["host_budget_bytes"] //= 2
    return kw


def _pair16(geom, backend="inproc"):
    import jax.numpy as jnp
    from repro.runtime.cluster import Cluster as JaxCluster
    from repro.runtime.serving import ServingTier as JaxTier
    ckw = dict(node_capacity=8 << 20, page_size=1 << 14,
               replication_factor=1, admission=True)
    if backend == "proc":
        ckw["backend"] = "proc"
    jc, pc = JaxCluster(4, **ckw), Cluster(4, **ckw)
    # the same dtype object to both: the port takes ml_dtypes' bfloat16 by
    # its name
    tkw = dict(_geom16(geom), dtype=jnp.bfloat16)
    return (jc, JaxTier(jc, **tkw)), (pc, ServingTier(pc, device="cpu",
                                                      **tkw))


def _shard_stats(tier):
    """Each shard's pager counters and its level-2 puts: driven by Eq. 1
    alone, so the two packages give the same. (Level-3 counts depend on
    when a transfer worker finishes, in either package.)"""
    return {node: (dict(sh.cache.stats), sh.store.stats["host_puts"])
            for node, sh in sorted(tier._shards.items())}


def _assert_same_state16(jt, pt, seqs, what):
    _assert_same_state(jt, pt, seqs, what)
    assert _shard_stats(jt) == _shard_stats(pt), what
    for s in seqs:
        assert jt.verify(s), (what, s)
        for a in pt.sequence_slabs(s):
            assert a.dtype == pt.host_dtype, (what, s)


def _assert_same_attend16(jt, pt, seqs, what, layers=(0,), held=None):
    """Each session's ``attend`` at every layer, both impls, both packages:
    within 2e-2 of the JAX tier's plain version, and of fp64 dense attention
    where the session's pages fit the pool (a longer one has its own pages
    evict one another while its table is built, in both packages alike).
    ``held`` gains the sessions held to the dense answer."""
    fits = [s for s in seqs
            if pt._pages_for(pt.sessions[s].length) <= pt.hbm_pages_per_node]
    if held is not None:
        held += fits
    for layer in layers:
        for s in seqs:
            outs = {f"jax-{impl}": jt.attend([s], layer, impl=impl)[s]
                    for impl in ("kernel", "xla")}
            outs.update({f"port-{impl}": pt.attend([s], layer, impl=impl)[s]
                         for impl in ("kernel", "xla")})
            for impl in ("kernel", "xla"):
                assert outs[f"port-{impl}"].dtype == pt.host_dtype
                assert outs[f"port-{impl}"].shape == (pt.kv_heads,
                                                      pt.head_dim)
            ref = _floats(outs["jax-xla"])
            for name, out in outs.items():
                msg = f"{what}: seq {s} layer {layer} {name}"
                np.testing.assert_allclose(_floats(out), ref, rtol=TOL16,
                                           atol=TOL16, err_msg=msg)
                if s in fits:
                    np.testing.assert_allclose(
                        _floats(out), _dense_attend(pt, s, layer),
                        rtol=TOL16, atol=TOL16, err_msg=msg)


def _settled_spills(pair):
    """Level-3 spills of every shard once no copy is in flight."""
    cluster, tier = pair
    for shard in tier._shards.values():
        _settle(cluster, shard.store)
    return sum(sh.store.stats["remote_spills"]
               for sh in tier._shards.values())


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_port_tier_matches_the_jax_tier_at_bf16(geom):
    """The shared script at a bf16 pool: byte-identical slabs (the JAX
    slab's bits), the oracle's bytes, equal tier and pager stats, every
    level spilled in both, ``attend`` within 2e-2 of the JAX tier's and of
    fp64 dense attention."""
    jax_pair, port_pair = _pair16(geom)
    (jc, jt), (pc, pt) = jax_pair, port_pair
    held = []
    try:
        assert pt.slab_nbytes == jt.slab_nbytes
        _run_script(jax_pair, port_pair, _assert_same_state16,
                    functools.partial(_assert_same_attend16, held=held))
        assert len(set(held)) >= 2
        assert _settled_spills(jax_pair) > 0
        assert _settled_spills(port_pair) > 0
        assert sum(sh.cache.stats["fetches"]
                   for sh in pt._shards.values()) > 0
    finally:
        jt.close()
        pt.close()
        jc.shutdown()
        pc.shutdown()


def test_port_tier_matches_the_jax_tier_at_bf16_on_proc():
    """The shared script at a bf16 pool over proc clusters: replica blobs
    and level-3 slabs cross node processes as bytes and come back the same."""
    jax_pair, port_pair = _pair16("default", backend="proc")
    (jc, jt), (pc, pt) = jax_pair, port_pair
    try:
        _run_script(jax_pair, port_pair, _assert_same_state16,
                    _assert_same_attend16)
        assert _settled_spills(port_pair) > 0
        jt.close()
        pt.close()
    finally:
        jreport, preport = jc.close(), pc.close()
    assert jreport.ok, jreport
    assert preport.ok, preport
    assert port_rpc.pickle_fallbacks() == 0


def test_oracle_bits_match_the_jax_package_on_all_997_values():
    """The oracle's values are k / 997: each rounds to the JAX package's
    bytes (ml_dtypes' bfloat16), as arrays and as the scalars ``attend``
    builds its q from."""
    import jax.numpy as jnp
    from repro.runtime import serving as jax_serving
    dtype, jd = "bfloat16", jnp.bfloat16
    vals = np.arange(997) / 997.0
    want = vals.astype(jd).view(np.uint16)
    assert host_array(vals, dtype).view(np.uint16).tobytes() == \
        want.tobytes()
    for k in range(997):
        got = np.full((2,), host_array(float(vals[k]), dtype))
        assert got.view(np.uint16)[0] == np.full((2,), vals[k], jd).view(
            np.uint16)[0], k
    kw = dict(num_layers=2, page_tokens=8, kv_heads=2, head_dim=4)
    for seq, page, length in ((3, 1, 6), (0, 0, 1), (91, 4, 100),
                              (996, 200, 1700)):
        a = expected_page_slab(seq, page, length, dtype=dtype, **kw)
        b = jax_serving.expected_page_slab(seq, page, length, dtype=jd, **kw)
        assert a.dtype == np.uint16
        assert a.tobytes() == b.tobytes()
    # the pool holds the same bits as the host form: no second rounding
    t = host_to_tensor(host_array(vals, dtype), dtype)
    assert str(t.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(t.double().numpy(),
                                  vals.astype(jd).astype(np.float64))


def test_port_tier_matches_the_jax_tier_over_a_batch_attend():
    """A batch over several shards in one ``attend`` call, where every
    batch's pages fit its shard's pool: the same tables in both packages."""
    (jc, jt), (pc, pt) = _pair("default", hbm_pages_per_node=16)
    try:
        prompts = {s: 3 + 2 * s for s in range(8)}
        for tier in (jt, pt):
            tier.admit(prompts)
            tier.decode(sorted(prompts), steps=3)
        seqs = sorted(prompts)
        outs = [jt.attend(seqs, impl="kernel"), jt.attend(seqs, impl="xla"),
                pt.attend(seqs, impl="kernel"), pt.attend(seqs, impl="xla")]
        assert len({pt.sessions[s].node for s in seqs}) > 1
        for s in seqs:
            for out in outs[1:]:
                np.testing.assert_allclose(out[s], outs[0][s], rtol=RTOL,
                                           atol=ATOL)
        _assert_same_state(jt, pt, seqs, "batch")
    finally:
        jt.close()
        pt.close()
        jc.shutdown()
        pc.shutdown()


# -- where the port's copy differs from the JAX package's ---------------------
def _jax_or_port(package):
    if package == "jax":
        from repro.runtime.cluster import Cluster as JaxCluster
        from repro.runtime.serving import ServingTier as JaxTier
        return JaxCluster, JaxTier, {}
    return Cluster, ServingTier, {"device": "cpu"}


@pytest.mark.parametrize("package", ["jax", "port"])
def test_stale_spill_copy_documented_disagreement(package):
    """A slab taken back, changed and put again while its level-3 copy
    flies: the JAX package's store adopts the older copy when it lands
    (the next take returns the older bytes); the port's drops it and keeps
    the newer slab."""
    make_cluster, make_tier, kw = _jax_or_port(package)
    cluster = make_cluster(4, node_capacity=8 << 20, page_size=1 << 14,
                           replication_factor=1, admission=True)
    tier = make_tier(cluster, hbm_pages_per_node=4, host_budget_bytes=0,
                     **kw)
    tier.admit({5: 4})
    store = tier._shards[tier.sessions[5].node].store
    gate, shipping = threading.Event(), threading.Event()
    ship = store._ship

    def held_ship(*args):
        shipping.set()
        assert gate.wait(timeout=30.0)
        return ship(*args)

    store._ship = held_ship
    older = np.full(tier.slab_shape, 1.0, np.float32)
    newer = np.full(tier.slab_shape, 2.0, np.float32)
    store.put(10_000, older)
    assert shipping.wait(timeout=30.0)
    store.take(10_000)
    store.put(10_000, newer)
    gate.set()
    _settle(cluster, store)
    # one copy settles: the older one adopted (JAX) or, once it is
    # dropped, the newer one sent again (port)
    assert store.stats["remote_spills"] == 1
    got = store.take(10_000)
    want = older if package == "jax" else newer
    assert got.tobytes() == want.tobytes()
    assert tier.verify(5)
    tier.close()
    cluster.shutdown()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_late_spill_worker_documented_disagreement(package):
    """The ``during_spill`` hook with a transfer worker that runs late: the
    JAX package fires it on the worker, so the kill lands after the decode
    loop and no session fails over in it; the port fires it on the spilling
    thread before the copy is submitted, so the killed node's session fails
    over inside the loop."""
    import time
    make_cluster, make_tier, kw = _jax_or_port(package)
    cluster = make_cluster(4, node_capacity=8 << 20, page_size=1 << 14,
                           replication_factor=1, admission=True)
    tier = make_tier(cluster, hbm_pages_per_node=3, host_budget_bytes=0,
                     **kw)
    tier.admit({1: 10, 2: 6})
    tier.decode([1, 2], steps=4)
    late = threading.Event()
    for shard in tier._shards.values():
        ship = shard.store._ship

        def late_ship(*args, _ship=ship):
            late.wait(timeout=30.0)    # the worker runs after the loop
            return _ship(*args)

        shard.store._ship = late_ship
    tier.add_fault_hook("during_spill",
                        lambda: cluster.kill_node(tier.sessions[1].node))
    tier.decode([1, 2], steps=6)
    failovers = tier.stats["failovers"]
    late.set()
    time.sleep(0.05)
    assert failovers == (0 if package == "jax" else 1)
    for s in (1, 2):
        assert tier.verify(s)
    tier.close()
    cluster.shutdown()


# -- the copied cluster runtime against the JAX package's ---------------------
PAIR = np.dtype([("key", np.int64), ("val", np.float64)])


def _pairs(n, key_range, seed):
    rng = np.random.default_rng(seed)
    recs = np.zeros(n, PAIR)
    recs["key"] = rng.integers(0, key_range, n)
    recs["val"] = rng.random(n)
    return recs


def _shuffle_parts(cluster, backend, recs, columnar):
    sset = cluster.create_sharded_set("pts", recs, key_fn=lambda r: r["key"])
    sh = cluster.shuffle("pts-sh", 8, PAIR, columnar=columnar)
    if backend == "proc":
        sh.map_sharded(sset, key_field="key")
    else:
        sh.map_sharded(sset, key_fn=lambda r: r["key"])
    sh.finish_maps()
    sh.place_reducers_locally()
    parts = [np.sort(sh.pull(r), order=["key", "val"]) for r in range(8)]
    for r in range(8):
        sh.release_reducer(r)
    return parts


@pytest.mark.parametrize("case", ["random", "empty", "one_partition", "wide"])
def test_dispatch_plan_and_partition_crc_match_the_jax_package(case):
    """``dispatch_plan`` and ``fused_partition_crc`` give the JAX package's
    answers on the same inputs."""
    from repro.core.columnar import fused_partition_crc as jax_crc
    from repro.runtime import cluster as jax_cluster
    from repro_torch.core.columnar import fused_partition_crc as crc
    from repro_torch.runtime.cluster import dispatch_plan as plan
    rng = np.random.default_rng(11)
    n, parts = {"random": (5000, 8), "empty": (0, 4),
                "one_partition": (300, 1), "wide": (4000, 300)}[case]
    ids = rng.integers(0, parts, n)
    for a, b in zip(plan(ids, parts), jax_cluster.dispatch_plan(ids, parts)):
        np.testing.assert_array_equal(a, b)
    keys = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    cols = {"key": keys, "val": rng.standard_normal(n)}
    dtype = np.dtype([("key", np.int64), ("val", np.float64)])
    got, want = crc(keys, cols, dtype, parts), jax_crc(keys, cols, dtype,
                                                       parts)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for f in a:
                np.testing.assert_array_equal(a[f], b[f])
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("columnar", [False, True], ids=["rows", "columnar"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_copied_runtime_shuffles_and_aggregates_as_the_jax_package(
        backend, columnar):
    """The port's copies of the cluster runtime (its own numpy dispatch
    plan, an rpc without pickle) partition a shuffle and sum a hash
    aggregate exactly as the JAX package's inproc cluster does."""
    from repro.runtime.cluster import Cluster as JaxCluster
    from repro.runtime.cluster import \
        cluster_hash_aggregate as jax_aggregate
    from repro_torch.runtime.cluster import cluster_hash_aggregate
    recs = _pairs(20_000, 1 << 20, seed=3)
    kw = dict(node_capacity=16 << 20, page_size=1 << 16,
              replication_factor=1)
    ref = JaxCluster(4, **kw)
    want = _shuffle_parts(ref, "inproc", recs, columnar)
    want_agg = jax_aggregate(ref, ref.catalog["pts"], "key", "val",
                             num_reducers=8, force_shuffle=True)
    ref.shutdown()
    cluster = _cluster(backend, **kw)
    got = _shuffle_parts(cluster, backend, recs, columnar)
    if backend == "inproc":
        got_agg = cluster_hash_aggregate(cluster, cluster.catalog["pts"],
                                         "key", "val", num_reducers=8,
                                         force_shuffle=True)
        for a, b in zip(got_agg, want_agg):
            assert a.tobytes() == b.tobytes()
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()
    assert port_rpc.pickle_fallbacks() == 0
    _teardown(cluster, backend)
