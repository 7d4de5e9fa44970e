"""The port's checkpoint manager (``repro_torch.checkpoint``) on the CPU:
file mode and pool mode, where every blob is a write-through set in a
node's durable page log.

Every test of the JAX package's ``tests/test_checkpoint.py`` is mirrored here
on the port. The cross-package tests write one state with each package and
hold the results together: the same files byte for byte, each package
restoring the other's checkpoint (fp32 leaves equal, bf16 leaves equal bit
for bit), and a pool-mode checkpoint after a warm and a cold revival of the
node that holds the row layout and the ``latest`` pointer. Torch params go
in as they are (a bf16 tensor is stored as the reference stores a bf16
array) and come back in a torch template's dtypes.
"""
import os
import threading
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.models.lm import tree_map
from repro_torch.models.model import build_model
from repro_torch.runtime import rpc as port_rpc
from repro_torch.runtime.cluster import Cluster

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_isolation():
    port_rpc.reset_counters()
    yield


def _state():
    rng = np.random.default_rng(0)
    return {"params": {"w1": rng.normal(size=(16, 8)).astype(np.float32),
                       "w2": rng.normal(size=(8, 16)).astype(np.float32),
                       "scale": rng.normal(size=(7,)).astype(np.float32)},
            "opt": {"step": np.int32(5),
                    "m": {"w1": rng.normal(size=(16, 8)).astype(np.float32)}}}


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_equal(a[k], b[k])
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _assert_bits_equal(a, b):
    """Two trees of tensors: same dtypes, same bits."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_bits_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bits_equal(x, y)
    elif a is None:
        assert b is None
    else:
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        assert torch.equal(a, b)


def test_roundtrip_both_layouts(tmp_path):
    mgr = CheckpointManager(str(tmp_path), layouts=("row", "col"),
                            num_shards=4)
    st = _state()
    mgr.save(1, st)
    for layout in ("row", "col"):
        back = mgr.restore(st, layout=layout)
        _assert_equal(back, st)


@pytest.mark.parametrize("damaged_layout,shard", [("row", 0), ("row", 3),
                                                  ("col", 1)])
def test_recovery_from_other_layout(tmp_path, damaged_layout, shard):
    mgr = CheckpointManager(str(tmp_path), layouts=("row", "col"),
                            num_shards=4)
    st = _state()
    mgr.save(2, st)
    mgr.damage_shard(2, damaged_layout, shard)
    back = mgr.restore(st)
    _assert_equal(back, st)


def test_damage_in_both_layouts_different_shards(tmp_path):
    """Row shard 0 and col shard 2 together leave no layout whole, and the
    per-tensor salvage then finds no tensor whole in both: the restore
    raises cleanly (as the reference's does for this state), never returns
    a wrong tensor."""
    mgr = CheckpointManager(str(tmp_path), layouts=("row", "col"),
                            num_shards=4)
    st = _state()
    mgr.save(3, st)
    mgr.damage_shard(3, "row", 0)
    mgr.damage_shard(3, "col", 2)
    try:
        back = mgr.restore(st)
    except IOError as e:
        assert "unrecoverable" in str(e)
    else:
        _assert_equal(back, st)


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), layouts=("row",), num_shards=2,
                            keep=2)
    st = _state()
    for step in (1, 2, 3, 4):
        mgr.save(step, st, async_=True)
    mgr.wait()
    assert mgr.latest_step() == 4
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(dirs) == 2


def test_async_save_owns_its_copy_of_cpu_tensors(tmp_path):
    """A save of CPU tensors copies them before it returns: the donated
    train step then updates the state in place while the save writes."""
    mgr = CheckpointManager(str(tmp_path), layouts=("row",), num_shards=2)
    st = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
          "b": torch.ones(8, dtype=torch.bfloat16)}
    want = {k: v.clone() for k, v in st.items()}
    gate, write = threading.Event(), mgr._write
    mgr._write = lambda step, flat: (gate.wait(), write(step, flat))
    mgr.save(1, st, async_=True)
    for t in st.values():           # before the save's thread writes
        t.add_(100)
    gate.set()
    mgr.wait()
    back = mgr.restore({k: torch.zeros_like(v) for k, v in st.items()},
                       step=1)
    _assert_bits_equal(back, want)


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state())


# -- pool mode ----------------------------------------------------------------
def _pool_cluster(tmp_path, cls=Cluster):
    return cls(4, node_capacity=16 << 20, page_size=1 << 16,
               replication_factor=1, pagelog_dir=str(tmp_path / "pagelog"))


def test_pool_mode_roundtrip_both_layouts(tmp_path):
    cluster = _pool_cluster(tmp_path)
    mgr = CheckpointManager(cluster=cluster, layouts=("row", "col"),
                            num_shards=4)
    st = _state()
    mgr.save(1, st)
    for layout in ("row", "col"):
        _assert_equal(mgr.restore(st, layout=layout), st)
    cluster.shutdown()


def test_pool_mode_requires_exactly_one_backend(tmp_path):
    cluster = _pool_cluster(tmp_path)
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "d"), cluster=cluster)
    with pytest.raises(ValueError):
        CheckpointManager()
    cluster.shutdown()


def test_pool_mode_damage_recovers_from_other_layout(tmp_path):
    cluster = _pool_cluster(tmp_path)
    mgr = CheckpointManager(cluster=cluster, layouts=("row", "col"),
                            num_shards=4)
    st = _state()
    mgr.save(2, st)
    mgr.damage_shard(2, "row", 1)
    _assert_equal(mgr.restore(st), st)
    cluster.shutdown()


def test_pool_mode_survives_full_cluster_restart(tmp_path):
    cluster = _pool_cluster(tmp_path)
    mgr = CheckpointManager(cluster=cluster, layouts=("row",), num_shards=4)
    st = _state()
    mgr.save(7, st)
    for n in list(cluster.nodes):
        cluster.kill_node(n)
    for n in list(cluster.nodes):
        assert cluster.revive_node(n) == []
    _assert_equal(mgr.restore(st), st)
    assert mgr.latest_step() == 7
    cluster.shutdown()


def test_pool_mode_gc_keeps_newest(tmp_path):
    cluster = _pool_cluster(tmp_path)
    mgr = CheckpointManager(cluster=cluster, layouts=("row",), num_shards=2,
                            keep=2)
    st = _state()
    for step in (1, 2, 3):
        mgr.save(step, st)
    assert mgr._list_steps() == ["step_00000002", "step_00000003"]
    _assert_equal(mgr.restore(st), st)
    live = [n for n in cluster.durable_blobs if "step_00000001" in n]
    assert live == []
    cluster.shutdown()


# -- torch leaves and bf16 ------------------------------------------------------
def _torch_params(seed=0):
    """smoke qwen3-0.6b's params as ServeLoop serves them: bf16 weights
    and one fp32 leaf, on the CPU."""
    model = build_model(smoke_config("qwen3-0.6b"), device="cpu")
    return model._compute_cast(model.init(torch.Generator().manual_seed(seed)))


def _ref_state(params):
    """The same values as the JAX package holds them: numpy leaves, bf16 as
    ml_dtypes' bfloat16."""
    def one(t):
        a = params_to_numpy({"t": t})["t"]
        return a.view(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 else a
    return tree_map(one, params)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_torch_params_write_the_reference_checkpoint_byte_for_byte(tmp_path):
    from repro.checkpoint import CheckpointManager as RefManager
    params = _torch_params()
    CheckpointManager(str(tmp_path / "port"), layouts=("row", "col"),
                      num_shards=4).save(1, params)
    RefManager(str(tmp_path / "ref"), layouts=("row", "col"),
               num_shards=4).save(1, _ref_state(params))
    ours, theirs = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert sorted(ours) == sorted(theirs) and len(ours) == 10
    for name in ours:
        assert ours[name] == theirs[name], name


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_restores_the_others_checkpoint(tmp_path, writer):
    from repro.checkpoint import CheckpointManager as RefManager
    params = _torch_params(seed=1)
    ref_state = _ref_state(params)
    kw = dict(layouts=("row", "col"), num_shards=2)
    if writer == "port":
        CheckpointManager(str(tmp_path), **kw).save(3, params)
    else:
        RefManager(str(tmp_path), **kw).save(3, ref_state)
    for layout in ("row", "col"):
        ours = CheckpointManager(str(tmp_path), **kw).restore(
            params, layout=layout)
        _assert_bits_equal(params, ours)
        theirs = RefManager(str(tmp_path), **kw).restore(ref_state,
                                                         layout=layout)
        flat_t, flat_r = [], []
        tree_map(flat_t.append, params)
        tree_map(flat_r.append, theirs)
        for t, r in zip(flat_t, flat_r):
            if t.dtype == torch.bfloat16:
                assert r.dtype == np.dtype("V2")      # the reference's quirk
                assert r.tobytes() == params_to_numpy({"t": t})["t"].tobytes()
            else:
                assert np.array_equal(r, t.numpy())
    # the reference's restored leaves carry bf16 back through the bridge
    again = params_from_numpy(RefManager(str(tmp_path), **kw).restore(
        ref_state), device="cpu")
    _assert_bits_equal(params, again)


def test_bf16_restore_documented_disagreement(tmp_path):
    """The reference restores a bf16 leaf as numpy's two-byte void
    (``|V2``): its manifest records no dtype the npz can carry back. The
    port gives the torch template's bf16 by a bit view; with a numpy
    template it gives what the reference gives."""
    from repro.checkpoint import CheckpointManager as RefManager
    w = np.arange(8, dtype=np.float32).reshape(2, 4)
    ref_state = {"w": w.astype(ml_dtypes.bfloat16),
                 "b": np.ones(4, np.float32)}
    kw = dict(layouts=("row", "col"), num_shards=2)
    RefManager(str(tmp_path), **kw).save(1, ref_state)
    theirs = RefManager(str(tmp_path), **kw).restore(ref_state)
    assert theirs["w"].dtype == np.dtype("V2")            # expected bfloat16
    assert theirs["b"].dtype == np.float32
    template = {"w": torch.from_numpy(w).to(torch.bfloat16),
                "b": torch.ones(4)}
    ours = CheckpointManager(str(tmp_path), **kw).restore(template)
    assert ours["w"].dtype == torch.bfloat16
    assert torch.equal(ours["w"], template["w"])
    assert torch.equal(ours["b"], template["b"])
    as_numpy = CheckpointManager(str(tmp_path), **kw).restore(ref_state)
    assert as_numpy["w"].dtype == np.dtype("V2")
    assert as_numpy["w"].tobytes() == theirs["w"].tobytes()


def test_torch_template_refuses_a_width_it_cannot_view(tmp_path):
    mgr = CheckpointManager(str(tmp_path), num_shards=2)
    mgr.save(1, {"w": np.ones((4, 4), np.float32)})
    with pytest.raises(ValueError, match="cannot be viewed"):
        mgr.restore({"w": torch.ones(4, 4, dtype=torch.bfloat16)})
    back = mgr.restore({"w": torch.ones(4, 4, dtype=torch.int32)})
    assert back["w"].dtype == torch.int32        # a bit view, not a cast
    assert back["w"].view(torch.float32).eq(1).all()


def test_async_save_of_torch_params(tmp_path):
    params = _torch_params(seed=2)
    mgr = CheckpointManager(str(tmp_path), layouts=("col",), num_shards=3)
    mgr.save(5, params, async_=True)
    mgr.wait()
    _assert_bits_equal(params, mgr.restore(params))


# -- pool mode after a node's revival ------------------------------------------------
def _placement(names, nodes=4):
    return {n: zlib.crc32(n.encode()) % nodes for n in names}


def test_pool_blobs_land_where_the_smoke_phase_expects():
    """``_put_blob`` places a blob on ``alive[crc32(name) % len(alive)]``:
    step 1 under prefix ``ckpt`` on four nodes puts the whole row layout
    and ``latest`` on node 0, the manifest on node 1, the whole col layout
    on node 2."""
    names = [f"ckpt/step_00000001/{lay}/shard_{i}.npz"
             for lay in ("row", "col") for i in range(4)]
    where = _placement(names + ["ckpt/step_00000001/manifest.json",
                                "ckpt/latest"])
    assert {where[n] for n in names if "/row/" in n} == {0}
    assert {where[n] for n in names if "/col/" in n} == {2}
    assert where["ckpt/latest"] == 0
    assert where["ckpt/step_00000001/manifest.json"] == 1


def test_pool_mode_warm_revival_restores_torch_params_from_the_log(tmp_path):
    cluster = _pool_cluster(tmp_path)
    params = _torch_params(seed=3)
    mgr = CheckpointManager(cluster=cluster, layouts=("row", "col"),
                            num_shards=4)
    mgr.save(1, params)
    assert {n: loc[0] for n, loc in cluster.durable_blobs.items()} == \
        _placement(cluster.durable_blobs)
    cluster.kill_node(0)
    assert cluster.revive_node(0) == []
    base = cluster.net_bytes
    assert mgr.latest_step() == 1
    back = mgr.restore(params, layout="row")
    assert cluster.net_bytes == base
    log = cluster.nodes[0].pool.memory.pagelog
    assert any(n.startswith("ckpt/step_00000001/row/") for n in
               cluster.nodes[0].pool.paging.sets)
    assert log.set_names()
    _assert_bits_equal(params, back)
    _assert_bits_equal(params, params_from_numpy(back, device="cpu"))
    cluster.shutdown()


def _cold_outcome(cluster_cls, manager_cls, tmp_path, state, template):
    """Save step 1, kill node 0, revive it cold; what ``latest_step``,
    ``restore`` without a step and ``restore(step=1)`` do."""
    cluster = _pool_cluster(tmp_path, cluster_cls)
    mgr = manager_cls(cluster=cluster, layouts=("row", "col"), num_shards=4)
    mgr.save(1, state)
    cluster.kill_node(0)
    cluster.revive_node(0, warm=False)
    out = {}
    for what, call in (("latest_step", mgr.latest_step),
                       ("restore", lambda: mgr.restore(template))):
        try:
            out[what] = ("returned", call())
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            out[what] = (type(e).__name__, str(e))
    out["step1"] = mgr.restore(template, step=1)
    cluster.shutdown()
    return out


def test_cold_revival_falls_through_to_col_as_the_reference_does(tmp_path):
    from repro.checkpoint import CheckpointManager as RefManager
    from repro.runtime.cluster import Cluster as RefCluster
    params = _torch_params(seed=4)
    ours = _cold_outcome(Cluster, CheckpointManager, tmp_path / "port",
                         params, params)
    ref_state = _ref_state(params)
    theirs = _cold_outcome(RefCluster, RefManager, tmp_path / "ref",
                           ref_state, ref_state)
    assert ours["latest_step"] == theirs["latest_step"]
    assert ours["restore"] == theirs["restore"]
    assert ours["latest_step"][0] == "OSError"        # latest went with node 0
    _assert_bits_equal(params, ours["step1"])         # the col layout
    flat_t, flat_r = [], []
    tree_map(flat_t.append, ours["step1"])
    tree_map(flat_r.append, theirs["step1"])
    for t, r in zip(flat_t, flat_r):
        assert params_to_numpy({"t": t})["t"].tobytes() == r.tobytes()
