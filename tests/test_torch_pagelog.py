"""The port's durable page tier (``repro_torch.core.pagelog``) and what runs
over it — warm and cold revival, the recovery plan's ``"pagelog"`` source,
the revival fence, compaction, the fsync policies — on the CPU.

Every test of the JAX package's ``tests/test_pagelog.py`` is mirrored here on
the port, with the page-log tests of ``tests/test_node_proc.py`` (proc
backend), ``tests/test_columnar.py`` (fsync policies) and
``tests/test_sanitizer.py`` (no fsync under the index lock). The
cross-package tests hold the two logs together: the same appends with the
same ``epoch_fn`` write byte-identical ``pages.log`` files, each package
replays the other's log, the reference's ``fsck`` reads a compacted port log
as clean, and one cluster script gives the same recovery plans in both. The
port syncs holding no lock at all; the last tests drive its compaction with
records appended while it writes, and with writer threads beside it.
"""
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import sanitizer as port_sanitizer
from repro_torch.core.memory_manager import MemoryManager
from repro_torch.core.pagelog import (FSYNC_POLICIES, LOG_FILENAME,
                                      ConsistentHashIndex, PageLog,
                                      PageLogEntry, fsck)
from repro_torch.runtime import rpc as port_rpc
from repro_torch.runtime.cluster import Cluster, StorageNode

torch.set_num_threads(2)

PAIR = np.dtype([("key", np.int64), ("val", np.float64)])


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


@pytest.fixture
def sanitize():
    prev = port_sanitizer.enabled()
    port_sanitizer.enable(True)
    port_sanitizer.reset()
    yield port_sanitizer
    port_sanitizer.reset()
    port_sanitizer.enable(prev)


def _pairs(n, key_range, seed=0):
    rng = np.random.default_rng(seed)
    recs = np.zeros(n, PAIR)
    recs["key"] = rng.integers(0, key_range, n)
    recs["val"] = rng.random(n)
    return recs


def _sorted(recs):
    return np.sort(recs, order=["key", "val"])


def _cluster(tmp_path, replication_factor=1, **kw):
    kw.setdefault("node_capacity", 16 << 20)
    kw.setdefault("page_size", 1 << 16)
    kw.setdefault("pagelog_dir", str(tmp_path / "pagelog"))
    return Cluster(4, replication_factor=replication_factor, **kw)


def _proc(tmp_path=None, **kw):
    kw.setdefault("node_capacity", 16 << 20)
    kw.setdefault("page_size", 1 << 16)
    kw.setdefault("replication_factor", 1)
    if tmp_path is not None:
        kw.setdefault("pagelog_dir", str(tmp_path / "pagelog"))
        kw.setdefault("spill_dir", str(tmp_path / "spill"))
    return Cluster(4, backend="proc", **kw)


# -- page log unit behaviour --------------------------------------------------
def test_append_read_roundtrip_and_supersede(tmp_path):
    log = PageLog(str(tmp_path))
    a0 = os.urandom(512)
    a1 = os.urandom(512)
    log.append("a", a0)                    # seq 0 allocated
    log.append("a", a1)                    # seq 1
    assert log.read("a", 0) == a0
    assert log.read("a", 1) == a1
    assert log.next_seq("a") == 2
    # re-appending an existing seq supersedes in place: index keeps newest
    a0b = os.urandom(512)
    log.append("a", a0b, seq=0)
    assert log.read("a", 0) == a0b
    assert len(log.entries_for("a")) == 2  # still two live pages
    assert log.set_bytes("a") == 1024
    log.close()


def test_replay_rebuilds_index_with_tombstones_and_renames(tmp_path):
    log = PageLog(str(tmp_path))
    pages = [os.urandom(256) for _ in range(3)]
    for p in pages:
        log.append("keep", p)
    log.append("gone", os.urandom(256))
    log.drop_set("gone")                   # tombstone
    log.rename_set("keep", "kept")         # O(1) re-key, no data rewrite
    log.close()

    warm = PageLog(str(tmp_path))          # construction IS the replay
    assert warm.set_names() == ["kept"]
    assert [warm.read("kept", i) for i in range(3)] == pages
    assert warm.next_seq("kept") == 3      # seq allocation survives restart
    assert warm.report["tombstones"] == 1
    assert warm.report["renames"] == 1
    assert warm.report["truncated_bytes"] == 0
    warm.close()


def test_torn_tail_truncated_on_replay(tmp_path):
    log = PageLog(str(tmp_path))
    keep = [os.urandom(300), os.urandom(300)]
    log.append("t", keep[0])
    log.append("t", keep[1])
    log.append("t", os.urandom(300))       # this record will be torn
    log.close()
    path = os.path.join(str(tmp_path), LOG_FILENAME)
    with open(path, "r+b") as f:           # crash mid-append: short tail
        f.truncate(os.path.getsize(path) - 5)

    rep = fsck(str(tmp_path))              # read-only check sees the tear
    assert not rep["clean"] and rep["torn_tail_bytes"] > 0

    warm = PageLog(str(tmp_path))          # replay cuts back to last good
    assert warm.report["truncated_bytes"] > 0
    assert [e.seq for e in warm.entries_for("t")] == [0, 1]
    assert [warm.read("t", i) for i in range(2)] == keep
    warm.close()
    post = fsck(str(tmp_path))             # the tear is gone from disk
    assert post["clean"] and post["torn_tail_bytes"] == 0
    assert post["records"] == 2


def test_index_keeps_one_set_in_one_bucket():
    idx = ConsistentHashIndex(num_buckets=8)
    for seq in range(20):
        idx.put(PageLogEntry(name="s", seq=seq, epoch=0, offset=0,
                             length=1, payload_crc=0))
    b = idx.bucket_of("s")
    assert all(("s", seq) in idx._buckets[b] for seq in range(20))
    assert [e.seq for e in idx.entries_for("s")] == list(range(20))
    assert idx.drop_set("s") == 20 and len(idx) == 0


# -- warm vs cold cluster restart ---------------------------------------------
def test_warm_restart_is_byte_identical_with_zero_net_bytes(tmp_path):
    cluster = _cluster(tmp_path)
    recs = _pairs(20_000, 1_500, seed=3)
    sset = cluster.create_sharded_set("t", recs, key_fn=lambda r: r["key"])
    expect = _sorted(cluster.read_sharded(sset))
    cluster.kill_node(2)
    base_net = cluster.net_bytes
    report = cluster.recover_node(2)
    assert report.ok, report.checksum_failures
    assert report.sources["t:2"] == "pagelog"
    assert report.warm_shards >= 1
    assert report.warm_replicas >= 1
    assert cluster.net_bytes == base_net
    assert np.array_equal(_sorted(cluster.read_sharded(sset)), expect)
    cluster.shutdown()


def test_cold_restart_pulls_replica_bytes(tmp_path):
    cluster = _cluster(tmp_path)
    recs = _pairs(20_000, 1_500, seed=4)
    sset = cluster.create_sharded_set("t", recs, key_fn=lambda r: r["key"])
    expect = _sorted(cluster.read_sharded(sset))
    cluster.kill_node(2)
    shutil.rmtree(cluster._node_pagelog_dir(2), ignore_errors=True)
    base_net = cluster.net_bytes
    report = cluster.recover_node(2)
    assert report.ok, report.checksum_failures
    assert report.sources["t:2"].startswith("replica@")
    assert report.warm_shards == 0
    assert cluster.net_bytes > base_net
    assert np.array_equal(_sorted(cluster.read_sharded(sset)), expect)
    cluster.shutdown()


def test_cold_revival_flag_wipes_the_log(tmp_path):
    """``revive_node(warm=False)``: the disk died with the machine, so the
    revived node has an empty log and recovery pulls from the replica."""
    cluster = _cluster(tmp_path)
    sset = cluster.create_sharded_set("t", _pairs(8_000, 500, seed=13),
                                      key_fn=lambda r: r["key"])
    cluster.kill_node(1)
    assert cluster.revive_node(1, warm=False) == []
    assert cluster.nodes[1].pool.memory.pagelog.set_names() == []
    plan = cluster.scheduler.recovery_plan(sset, 1, target_node=1)
    assert all(s.kind != "pagelog" for s in plan)
    cluster.shutdown()


# -- recovery costing: local disk vs wire -------------------------------------
def test_recovery_plan_flips_pagelog_vs_replica_as_disk_cost_rises(tmp_path):
    cluster = _cluster(tmp_path)
    recs = _pairs(16_000, 900, seed=5)
    sset = cluster.create_sharded_set("t", recs, key_fn=lambda r: r["key"])
    cluster.kill_node(2)
    cluster.revive_node(2)                 # warm: log replayed, pool empty
    plan = cluster.scheduler.recovery_plan(sset, 2, target_node=2)
    kinds = [s.kind for s in plan]
    assert kinds[0] == "pagelog"           # default: disk byte < wire byte
    assert "replica" in kinds
    log_src = plan[0]
    assert log_src.disk_bytes > 0 and log_src.cost_bytes == 0
    cluster.scheduler.disk_byte_cost = 1e6
    plan = cluster.scheduler.recovery_plan(sset, 2, target_node=2)
    assert plan[0].kind == "replica"
    assert plan[-1].kind == "pagelog"
    cluster.shutdown()


def test_recovery_plan_has_no_pagelog_source_without_durable_tier():
    cluster = Cluster(4, node_capacity=16 << 20, page_size=1 << 16,
                      replication_factor=1)
    recs = _pairs(8_000, 500, seed=6)
    sset = cluster.create_sharded_set("t", recs, key_fn=lambda r: r["key"])
    cluster.kill_node(1)
    cluster.revive_node(1)
    plan = cluster.scheduler.recovery_plan(sset, 1, target_node=1)
    assert all(s.kind != "pagelog" for s in plan)
    cluster.shutdown()


# -- revival fence -------------------------------------------------------------
def test_revive_fences_sets_dropped_while_dead(tmp_path):
    cluster = _cluster(tmp_path)
    keep = cluster.create_sharded_set("keep", _pairs(8_000, 500, seed=7),
                                      key_fn=lambda r: r["key"])
    tmp = cluster.create_sharded_set("tmp", _pairs(8_000, 500, seed=8),
                                     key_fn=lambda r: r["key"])
    cluster.kill_node(1)
    cluster.drop_sharded_set(tmp)          # dropped while node 1 was dead
    fenced = cluster.revive_node(1)
    assert fenced and all(n.startswith("tmp/") for n in fenced)
    log = cluster.nodes[1].pool.memory.pagelog
    assert not any(n.startswith("tmp/") for n in log.set_names())
    plan = cluster.scheduler.recovery_plan(keep, 1, target_node=1)
    assert plan[0].kind == "pagelog"
    cluster.shutdown()


def test_stale_log_epoch_is_not_a_recovery_source(tmp_path):
    cluster = _cluster(tmp_path)
    recs = _pairs(12_000, 700, seed=9)
    sset = cluster.create_sharded_set("t", recs, key_fn=lambda r: r["key"])
    cluster.kill_node(1)
    cluster.revive_node(1)
    sset.shards[1].epoch = cluster.stats.event_seq + 10
    plan = cluster.scheduler.recovery_plan(sset, 1, target_node=1)
    assert all(s.kind != "pagelog" for s in plan)
    cluster.shutdown()


def test_double_revive_raises(tmp_path):
    cluster = _cluster(tmp_path)
    cluster.create_sharded_set("t", _pairs(4_000, 300, seed=10),
                               key_fn=lambda r: r["key"])
    cluster.kill_node(3)
    cluster.revive_node(3)
    with pytest.raises(ValueError):
        cluster.revive_node(3)
    cluster.shutdown()


# -- overcommit: the pool degrades to the log instead of failing -------------
def test_scan_larger_than_pool_completes_through_the_log(tmp_path):
    recs = _pairs(30_000, 2_000, seed=11)
    capacity = max(4 << 16, recs.nbytes // 8)
    cluster = Cluster(4, node_capacity=capacity, page_size=1 << 16,
                      replication_factor=1,
                      pagelog_dir=str(tmp_path / "pagelog"))
    sset = cluster.create_sharded_set("big", recs, key_fn=lambda r: r["key"])
    back = cluster.read_sharded(sset)
    assert np.array_equal(_sorted(back), _sorted(recs))
    log_bytes = sum(node.memory.stats["log_bytes"]
                    for node in cluster.nodes.values())
    assert log_bytes > 0
    cluster.shutdown()


# -- compaction ----------------------------------------------------------------
def test_compaction_rewrites_live_records_into_new_generation(tmp_path):
    log = PageLog(str(tmp_path))
    a_new = os.urandom(1024)
    log.append("a", os.urandom(1024))
    log.append("a", a_new, seq=0)          # supersede: old image is dead
    log.append("b", os.urandom(512))
    log.drop_set("b")                      # tombstoned: fully dead
    assert log.amplification() > 2.0
    before_entries = {name: [(e.seq, e.epoch) for e in log.entries_for(name)]
                      for name in log.set_names()}
    stats = log.compact()
    assert stats["generation"] == 1
    assert stats["records"] == 1
    assert stats["after_bytes"] < stats["before_bytes"]
    assert log.amplification() < 1.2
    assert log.read("a", 0) == a_new
    assert {name: [(e.seq, e.epoch) for e in log.entries_for(name)]
            for name in log.set_names()} == before_entries
    log.close()


def test_compaction_triggers_on_amplification_threshold(tmp_path):
    log = PageLog(str(tmp_path), compact_threshold=2.0, compact_min_bytes=0)
    payload = os.urandom(4096)
    log.append("a", payload)
    assert log.compactions == 0
    for _ in range(4):
        log.append("a", payload, seq=0)
    assert log.compactions >= 1
    assert log.amplification() <= 2.0
    assert log.read("a", 0) == payload
    log.close()


def test_background_compactor_sweeps_without_appends(tmp_path):
    import time as _time
    log = PageLog(str(tmp_path))
    payload = os.urandom(4096)
    log.append("a", payload)
    for _ in range(4):
        log.append("a", payload, seq=0)
    assert log.compactions == 0            # no threshold: inline never fires
    log.compact_threshold = 2.0
    log.compact_min_bytes = 0
    log.start_compactor(interval_s=0.01)
    deadline = _time.time() + 5.0
    while log.compactions == 0 and _time.time() < deadline:
        _time.sleep(0.01)
    log.stop_compactor()
    assert log.compactions >= 1
    assert log.read("a", 0) == payload
    log.close()


def test_compacted_log_replays_and_fscks_clean(tmp_path):
    log = PageLog(str(tmp_path))
    keep = os.urandom(2048)
    log.append("a", os.urandom(2048))
    log.append("a", keep, seq=0)
    log.append("gone", os.urandom(512))
    log.drop_set("gone")
    log.compact()
    log.close()
    log2 = PageLog(str(tmp_path))
    assert log2.generation == 1
    assert log2.set_names() == ["a"]
    assert log2.read("a", 0) == keep
    log2.close()
    report = fsck(str(tmp_path))
    assert report["exists"] and report["generation"] == 1
    assert report["crc_failures"] == 0 if "crc_failures" in report else True
    assert report["torn_tail_bytes"] == 0
    assert not report["stale_compact_tmp"]


def test_cluster_compaction_knob_bounds_log_growth(tmp_path):
    cluster = _cluster(tmp_path, pagelog_compact_threshold=2.0)
    recs = _pairs(6_000, 500, seed=12)
    sset = cluster.create_sharded_set("t", recs, key_fn=lambda r: r["key"])
    for i in range(4):
        cluster.drop_sharded_set(sset)
        sset = cluster.create_sharded_set("t", _pairs(6_000, 500, seed=12 + i),
                                          key_fn=lambda r: r["key"])
    compactions = sum(node.memory.pagelog.compactions
                      for node in cluster.nodes.values())
    worst = max(node.memory.pagelog.amplification()
                for node in cluster.nodes.values())
    assert compactions >= 1
    assert worst <= 2.5
    back = cluster.read_sharded(sset)
    assert len(back) == 6_000
    cluster.shutdown()


def _compaction_script(cluster_cls, root):
    """Queue 3's input: a sharded set of 6000 pairs over four nodes with
    page logs that compact at 2x, dropped and recreated four times."""
    cluster = cluster_cls(4, node_capacity=16 << 20, page_size=1 << 16,
                          replication_factor=1, pagelog_dir=str(root),
                          pagelog_compact_threshold=2.0)
    sset = cluster.create_sharded_set("t", _pairs(6_000, 500, seed=12),
                                      key_fn=lambda r: r["key"])
    for i in range(4):
        cluster.drop_sharded_set(sset)
        sset = cluster.create_sharded_set("t", _pairs(6_000, 500, seed=12 + i),
                                          key_fn=lambda r: r["key"])
    compactions = sum(node.memory.pagelog.compactions
                      for node in cluster.nodes.values())
    cluster.shutdown()
    logs = {}
    for node_dir in sorted(os.listdir(root)):
        with open(os.path.join(root, node_dir, LOG_FILENAME), "rb") as fh:
            logs[node_dir] = fh.read()
    return compactions, logs


def test_pool_persists_outside_its_lock_documented_disagreement(
        tmp_path, monkeypatch):
    """The buffer pool writes the page log holding no lock. The reference
    persists write-through pages and tombstones under its ``buffer_pool``
    lock, so the compactions they trigger fsync under it; its sanitizer
    does not see them (its compaction's fsync is not a marked blocking
    region), so every ``os.fsync`` is watched here in both packages. With
    ``PANGEA_SANITIZE=1`` the port records no blocking-while-holding event
    (48 before the pool queued its log writes) and fsyncs with no lock
    held; the reference fsyncs under ``buffer_pool``. The logs are the same
    bytes."""
    from repro.core import sanitizer as ref_sanitizer
    from repro.runtime.cluster import Cluster as RefCluster
    monkeypatch.setenv("PANGEA_SANITIZE", "1")
    real_fsync = os.fsync
    held = []

    def watched(fd):
        held.append(watch())
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", watched)
    out = {}
    for name, san, cls in (("port", port_sanitizer, Cluster),
                           ("ref", ref_sanitizer, RefCluster)):
        prev = san.enabled()
        san.enable(True)
        san.reset()
        held.clear()
        watch = san.held_lock_names
        try:
            compactions, logs = _compaction_script(cls, tmp_path / name)
            report = san.sanitizer_report()
        finally:
            san.reset()
            san.enable(prev)
        out[name] = (compactions, logs, report, list(held))
    compactions, port_logs, report, port_held = out["port"]
    assert compactions >= 1 and port_held
    assert report["blocking_while_holding"] == [] and report["cycles"] == []
    assert all(h == [] for h in port_held)
    ref_compactions, ref_logs, ref_report, ref_held = out["ref"]
    assert ref_compactions == compactions
    assert ref_report["blocking_while_holding"] == []
    assert any("buffer_pool" in h for h in ref_held)
    assert port_logs == ref_logs and len(port_logs) == 4


def test_failed_log_write_raises_in_its_writer_and_leaves_the_page_dirty(
        tmp_path):
    """A write-through page's log write runs outside the pool's lock, maybe
    in another thread's turn at the queue. If it fails, the thread that
    unpinned the page raises (the reference raises there), the page is left
    dirty with its pin released (as the reference leaves it), and its next
    unpin writes it again. The other thread's unpin, which ran the failing
    write, returns normally."""
    from repro_torch.core.attributes import AttributeSet, DurabilityType
    from repro_torch.core.buffer_pool import BufferPool
    log = PageLog(str(tmp_path / "log"))
    pool = BufferPool(1 << 20, pagelog=log)
    ls = pool.create_set("s", 4096, AttributeSet(
        durability=DurabilityType.WRITE_THROUGH))
    good, bad = pool.new_page(ls), pool.new_page(ls)
    pool.view(good)[:] = 1
    pool.view(bad)[:] = 2
    entered, go = threading.Event(), threading.Event()
    fail = [True]
    real_append = log.append

    def append(name, payload, seq=None):
        if payload[0] == 1:
            entered.set()
            assert go.wait(30)
        elif payload[0] == 2 and fail[0]:
            raise OSError("disk full")
        return real_append(name, payload, seq)

    log.append = append
    raised = {}

    def unpin(page, key):
        try:
            pool.unpin(page, dirty=True)
        except OSError as exc:
            raised[key] = exc

    runner = threading.Thread(target=unpin, args=(good, "good"))
    runner.start()
    assert entered.wait(30)          # the runner holds the queue
    writer = threading.Thread(target=unpin, args=(bad, "bad"))
    writer.start()
    for _ in range(3000):            # the bad write is queued behind it
        if pool._log_queued == 2:
            break
        threading.Event().wait(0.01)
    assert pool._log_queued == 2
    go.set()
    runner.join(30)
    writer.join(30)
    assert list(raised) == ["bad"] and "disk full" in str(raised["bad"])
    assert not good.dirty and good.durable and good.pin_count == 0
    assert bad.dirty and not bad.durable and not bad.spilled
    assert bad.pin_count == 0 and pool.memory.pinned_bytes == 0
    assert [e.seq for e in log.entries_for("s")] == [good.log_seq]
    # the page is still dirty, so its next unpin writes it again
    fail[0] = False
    pool.pin(bad)
    pool.unpin(bad)
    assert not bad.dirty and bad.durable and bad.pin_count == 0
    assert log.read("s", bad.log_seq) == bytes([2]) * 4096
    log.close()


# -- fsync policies (tests/test_columnar.py's) ----------------------------------
def test_fsync_policy_validated(tmp_path):
    with pytest.raises(ValueError, match="fsync_policy"):
        PageLog(str(tmp_path / "never-created"), fsync_policy="wat")


def test_fsync_default_none_never_syncs(tmp_path):
    log = PageLog(str(tmp_path))
    assert log.fsync_policy == "none"
    for _ in range(8):
        log.append("s", os.urandom(256))
    log.close()
    assert log.fsync_count == 0


def test_fsync_always_syncs_every_append(tmp_path):
    log = PageLog(str(tmp_path), fsync_policy="always")
    for _ in range(5):
        log.append("s", os.urandom(256))
    assert log.fsync_count == 5
    log.close()


def test_fsync_close_syncs_only_at_close(tmp_path):
    log = PageLog(str(tmp_path), fsync_policy="close")
    for _ in range(5):
        log.append("s", os.urandom(256))
    assert log.fsync_count == 0
    log.close()
    assert log.fsync_count == 1


def test_fsync_group_batches_syncs(tmp_path):
    log = PageLog(str(tmp_path), fsync_policy="group", group_bytes=4096)
    for _ in range(16):
        log.append("s", os.urandom(1024))
    assert 0 < log.fsync_count < 16
    mid = log.fsync_count
    log.close()
    assert log.fsync_count >= mid


@pytest.mark.parametrize("policy", FSYNC_POLICIES)
def test_fsck_clean_under_each_fsync_policy(tmp_path, policy):
    log = PageLog(str(tmp_path), fsync_policy=policy, group_bytes=1024)
    for i in range(6):
        log.append(f"s{i % 2}", os.urandom(512))
    log.close()
    rep = fsck(str(tmp_path))
    assert rep["clean"] and rep["records"] == 6
    assert rep["live_sets"] == ["s0", "s1"]


@pytest.mark.parametrize("policy", FSYNC_POLICIES)
def test_fsync_count_equals_the_reference(tmp_path, policy):
    """The same appends (with a drop, a rename and a compaction between)
    make as many syncs in the port's log, which syncs holding no lock, as
    in the reference's, which syncs under its sync lock."""
    from repro.core.pagelog import PageLog as RefPageLog
    counts = []
    for cls, d in ((PageLog, "port"), (RefPageLog, "ref")):
        log = cls(str(tmp_path / d), fsync_policy=policy, group_bytes=2048)
        for i in range(12):
            log.append(f"s{i % 3}", bytes([i]) * (300 + 97 * i))
            if i == 5:
                log.drop_set("s1")
            if i == 7:
                log.rename_set("s2", "t2")
                log.compact()
        mid = log.fsync_count
        log.close()
        counts.append((mid, log.fsync_count))
    assert counts[0] == counts[1]


# -- the sanitizer's view (tests/test_sanitizer.py's) ----------------------------
def test_pagelog_always_policy_fsyncs_outside_index_lock(tmp_path, sanitize):
    log = PageLog(str(tmp_path), fsync_policy="always")
    for i in range(3):
        log.append("set", bytes([i]) * 64)
    log.close()
    assert log.fsync_count >= 3
    events = sanitize.sanitizer_report()["blocking_while_holding"]
    held = [n for e in events for n in e["held"]]
    assert "pagelog" not in held, events
    # the port's syncs hold no lock at all, its own sync lock included
    assert events == []
    assert sanitize.sanitizer_report()["violations"] == 0


def test_pagelog_group_policy_still_batches(tmp_path):
    log = PageLog(str(tmp_path), fsync_policy="group", group_bytes=4096)
    for _ in range(8):
        log.append("s", b"x" * 256)
    assert log.fsync_count == 0   # under the batch threshold
    log.append("s", b"y" * 4096)  # pushes the tail past group_bytes
    assert log.fsync_count == 1
    log.append("s", b"z" * 128)   # small tail left unsynced...
    log.close()
    assert log.fsync_count == 2   # ...drained by close


def test_compaction_fsyncs_outside_every_lock(tmp_path, sanitize):
    log = PageLog(str(tmp_path), fsync_policy="always", compact_threshold=1.5,
                  compact_min_bytes=0)
    for i in range(6):
        log.append("a", bytes([i]) * 512, seq=0)
    assert log.compactions >= 1
    log.close()
    report = sanitize.sanitizer_report()
    assert report["blocking_while_holding"] == []
    assert report["violations"] == 0


# -- the proc backend (tests/test_node_proc.py's) ----------------------------------
def test_warm_log_recovery_over_rpc(tmp_path):
    cluster = _proc(tmp_path)
    recs = _pairs(10_000, 1_000, seed=8)
    sset = cluster.create_sharded_set("pts", recs, key_fn=lambda r: r["key"])
    cluster.kill_node(2)
    report = cluster.recover_node(2)
    assert report.ok
    assert report.warm_shards == 1 and report.warm_replicas == 1
    assert report.bytes_transferred == 0
    assert report.sources == {"pts:2": "pagelog"}
    back = cluster.read_sharded(sset)
    assert np.array_equal(_sorted(back), _sorted(recs))
    assert cluster.close().ok


def test_proc_revive_fences_sets_dropped_while_dead(tmp_path):
    cluster = _proc(tmp_path)
    recs = _pairs(8_000, 500, seed=10)
    sset = cluster.create_sharded_set("pts", recs, key_fn=lambda r: r["key"])
    fenced_name = sset.shards[1].set_name
    cluster.kill_node(1)
    cluster.drop_sharded_set(sset)
    fenced = cluster.revive_node(1)
    assert fenced_name in fenced
    rep, _ = cluster.nodes[1].call("log_sets")
    assert fenced_name not in rep["sets"]
    assert cluster.close().ok


def test_proc_cold_revival_recovers_from_the_replica(tmp_path):
    """The proc backend's remote log proxy: the scheduler sees the revived
    node's log over rpc; wiping it makes the replica the source."""
    cluster = _proc(tmp_path)
    recs = _pairs(10_000, 1_000, seed=14)
    sset = cluster.create_sharded_set("pts", recs, key_fn=lambda r: r["key"])
    log = cluster.nodes[3].memory.pagelog
    assert log.entries_for(sset.shards[3].set_name) > 0
    assert log.set_bytes(sset.shards[3].set_name) > 0
    cluster.kill_node(3)
    shutil.rmtree(cluster._node_pagelog_dir(3), ignore_errors=True)
    report = cluster.recover_node(3)
    assert report.ok and report.warm_shards == 0
    assert report.sources["pts:3"].startswith("replica@")
    assert report.bytes_transferred > 0
    assert np.array_equal(_sorted(cluster.read_sharded(sset)), _sorted(recs))
    assert port_rpc.pickle_fallbacks() == 0
    assert cluster.close().ok


# -- every constructor takes a log ----------------------------------------------
@pytest.mark.parametrize("make", [
    lambda d: Cluster(2, pagelog_dir=d),
    lambda d: Cluster(2, backend="proc", pagelog_dir=d),
    lambda d: StorageNode(0, 1 << 20, pagelog_dir=d),
    lambda d: MemoryManager(1 << 20, pagelog=PageLog(d)),
], ids=["inproc", "proc", "node", "memory_manager"])
def test_pagelog_is_taken_by_every_constructor(make, tmp_path):
    obj = make(str(tmp_path / "log"))
    if isinstance(obj, MemoryManager):
        class _Page:
            log_seq = -1
            durable = False
        page = _Page()
        obj.pagelog_write("s", page, b"abc")
        assert page.durable and page.log_seq == 0
        assert obj.pagelog_read("s", 0) == b"abc"
        report = obj.pressure_report()
        assert report["pagelog_bytes"] > 0 and report["log_bytes"] == 3
        obj.close()
        assert obj.pagelog._append_fh is None
    elif isinstance(obj, StorageNode):
        assert obj.pool.memory.pagelog is not None
        assert obj.pool.memory.pagelog.directory == str(tmp_path / "log")
    else:
        log = obj.nodes[0].memory.pagelog
        assert log is not None and log.set_bytes("absent") == 0
        if hasattr(obj, "pagelog_report"):
            assert set(obj.pagelog_report()) == {0, 1}
            assert obj.close().ok
        else:
            obj.shutdown()


# -- the two packages' logs side by side ------------------------------------------
def _log_script(cls, directory, epoch, compact, **kw):
    """One sequence of log operations, with a deterministic epoch counter."""
    log = cls(directory, epoch_fn=lambda: epoch[0], **kw)
    for i in range(9):
        epoch[0] = i // 2
        log.append(f"set{i % 3}", bytes([i]) * (100 + 37 * i))
    log.append("set0", b"superseded" * 20, seq=1)
    log.drop_set("set1")
    log.rename_set("set2", "renamed")
    epoch[0] = 7
    if compact == "explicit":
        log.compact()
    log.append("set0", b"after" * 50)
    log.append("renamed", b"tail" * 30, seq=0)
    log.close()
    return log


@pytest.mark.parametrize("compact", ["none", "explicit", "threshold"])
def test_same_appends_write_byte_identical_logs(tmp_path, compact):
    from repro.core.pagelog import PageLog as RefPageLog
    kw = ({"compact_threshold": 1.3, "compact_min_bytes": 0}
          if compact == "threshold" else {})
    port = _log_script(PageLog, str(tmp_path / "port"), [0], compact, **kw)
    ref = _log_script(RefPageLog, str(tmp_path / "ref"), [0], compact, **kw)
    assert port.compactions == ref.compactions
    if compact != "none":
        assert port.compactions >= 1
    with open(os.path.join(port.directory, LOG_FILENAME), "rb") as f:
        port_bytes = f.read()
    with open(os.path.join(ref.directory, LOG_FILENAME), "rb") as f:
        ref_bytes = f.read()
    assert port_bytes == ref_bytes


def _state(log):
    return {name: [(e.seq, e.epoch, e.length, log.read(name, e.seq))
                   for e in log.entries_for(name)]
            for name in log.set_names()}


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_replays_the_others_log(tmp_path, writer):
    from repro.core.pagelog import PageLog as RefPageLog
    classes = {"port": PageLog, "ref": RefPageLog}
    _log_script(classes[writer], str(tmp_path), [0], "explicit")
    logs = [cls(str(tmp_path)) for cls in (PageLog, RefPageLog)]
    states = [_state(log) for log in logs]
    assert states[0] == states[1] and states[0]
    assert logs[0].report == logs[1].report
    assert logs[0].generation == logs[1].generation == 1
    assert ([logs[0].next_seq(n) for n in ("set0", "renamed")]
            == [logs[1].next_seq(n) for n in ("set0", "renamed")])
    for log in logs:
        log.close()


def test_reference_fsck_reads_a_compacted_port_log_as_clean(tmp_path):
    from repro.core.pagelog import fsck as ref_fsck
    _log_script(PageLog, str(tmp_path), [0], "explicit")
    ours, theirs = fsck(str(tmp_path)), ref_fsck(str(tmp_path))
    assert theirs["clean"] and ours["clean"]
    assert theirs["generation"] == 1 and not theirs["stale_compact_tmp"]
    assert ours == theirs


def _recovery_script(cluster_cls, tmp_path):
    """Create, kill, warm revive, plan; flip the disk cost; recover warm;
    then kill another node and recover it cold. Returns what the plans and
    reports say, without the package's own types."""
    cluster = cluster_cls(4, node_capacity=16 << 20, page_size=1 << 16,
                          replication_factor=1,
                          pagelog_dir=str(tmp_path / "pagelog"))
    recs = _pairs(16_000, 900, seed=5)
    sset = cluster.create_sharded_set("t", recs, key_fn=lambda r: r["key"])
    cluster.kill_node(2)
    cluster.revive_node(2)

    def plan():
        return [(s.kind, s.holder, s.set_name, s.cost_bytes, s.disk_bytes)
                for s in cluster.scheduler.recovery_plan(sset, 2,
                                                         target_node=2)]
    out = {"plan": plan()}
    default_cost = cluster.scheduler.disk_byte_cost
    cluster.scheduler.disk_byte_cost = 1e6
    out["flipped"] = plan()
    cluster.scheduler.disk_byte_cost = default_cost
    cluster.kill_node(2)
    base = cluster.net_bytes
    warm = cluster.recover_node(2)
    out["warm"] = (warm.sources, warm.warm_shards, warm.warm_replicas,
                   warm.bytes_transferred, cluster.net_bytes - base)
    cluster.kill_node(1)
    shutil.rmtree(cluster._node_pagelog_dir(1))
    base = cluster.net_bytes
    cold = cluster.recover_node(1)
    out["cold"] = (cold.sources, cold.warm_shards, cold.warm_replicas,
                   cold.bytes_transferred, cluster.net_bytes - base)
    out["records"] = _sorted(cluster.read_sharded(sset)).tobytes()
    cluster.shutdown()
    return out


def test_recovery_plans_and_sources_equal_the_reference(tmp_path):
    from repro.runtime.cluster import Cluster as RefCluster
    ours = _recovery_script(Cluster, tmp_path / "port")
    theirs = _recovery_script(RefCluster, tmp_path / "ref")
    assert ours["plan"][0][0] == "pagelog" and ours["plan"][0][4] > 0
    assert ours["flipped"][0][0] == "replica"
    assert ours["warm"][0] == {"t:2": "pagelog"}
    assert ours["cold"][0]["t:1"].startswith("replica@")
    assert ours == theirs


# -- the port's compaction beside concurrent writers --------------------------------
def test_compaction_copies_records_appended_while_it_writes(tmp_path,
                                                            monkeypatch):
    """Records that land while compaction writes the new generation (before
    and after it takes the sync turn) are copied behind the snapshot: the
    swapped log holds the same live state as a log that never compacted,
    replays to it in both packages, and fscks clean."""
    from repro.core.pagelog import PageLog as RefPageLog
    log = PageLog(str(tmp_path / "c"))
    plain = PageLog(str(tmp_path / "p"))
    for target in (log, plain):
        for i in range(6):
            target.append(f"s{i % 2}", bytes([i]) * 700)
        target.append("s0", b"old" * 100, seq=0)
    late = [lambda t: (t.append("s1", b"during-write" * 40),
                       t.drop_set("s0")),
            lambda t: (t.append("s2", b"during-turn" * 40),
                       t.rename_set("s1", "r1"),
                       t.append("r1", b"superseding" * 40, seq=1))]
    calls, synced_sizes = [], []
    real = PageLog._fsync_file

    def fsync_then_mutate(fh):
        real(fh)
        synced_sizes.append(os.fstat(fh.fileno()).st_size)
        if len(calls) < len(late):
            step = late[len(calls)]
            calls.append(step)
            step(log)
            step(plain)

    monkeypatch.setattr(log, "_fsync_file", fsync_then_mutate)
    stats = log.compact()
    assert len(calls) == 2 and stats["generation"] == 1
    # the records appended while the snapshot was written (which a sync
    # may already have acknowledged) were fsynced in the new file before
    # the swap; those appended under the turn were not yet
    assert synced_sizes[1] > synced_sizes[0]
    assert stats["after_bytes"] > synced_sizes[1]
    assert _state(log) == _state(plain)
    assert log.amplification() < plain.amplification()
    log.append("r1", b"after-swap" * 10)
    plain.append("r1", b"after-swap" * 10)
    log.close()
    plain.close()
    expect = _state(PageLog(str(tmp_path / "p")))
    assert _state(PageLog(str(tmp_path / "c"))) == expect
    assert _state(RefPageLog(str(tmp_path / "c"))) == expect
    rep = fsck(str(tmp_path / "c"))
    assert rep["clean"] and rep["generation"] == 1
    assert not rep["stale_compact_tmp"]


@pytest.mark.parametrize("policy", ["always", "group"])
def test_writers_and_compactions_together_keep_every_page(tmp_path, sanitize,
                                                          policy):
    """Four writer threads superseding their pages while a fifth compacts
    in a loop: every page's newest image survives, the log replays to it,
    fsck is clean, and the sanitizer saw no cycle and no sync under a
    lock."""
    log = PageLog(str(tmp_path), fsync_policy=policy, group_bytes=4096)
    newest = {}
    stop = threading.Event()

    def writer(w):
        for i in range(40):
            payload = bytes([w, i]) * (64 + 16 * (i % 5))
            log.append(f"w{w}", payload, seq=i % 6)
            newest[(f"w{w}", i % 6)] = payload

    def compactor():
        while not stop.is_set():
            log.compact()

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(1, 5)]
    comp = threading.Thread(target=compactor)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        comp.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        comp.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not comp.is_alive() and not any(t.is_alive() for t in threads)
    assert log.compactions >= 1
    for (name, seq), payload in newest.items():
        assert log.read(name, seq) == payload
    assert log.fsync_count >= 1
    if policy == "always":
        assert log.fsync_count <= 4 * 40
    log.close()
    warm = PageLog(str(tmp_path))
    for (name, seq), payload in newest.items():
        assert warm.read(name, seq) == payload
    warm.close()
    assert fsck(str(tmp_path))["clean"]
    report = sanitize.sanitizer_report()
    assert report["cycles"] == [] and report["blocking_while_holding"] == []
    assert report["violations"] == 0
