"""``examples/torch_cluster_quickstart.py`` (the cluster runtime of the
port) against ``examples/cluster_quickstart.py`` (the JAX package's),
both loaded by path and run once for the module: the aggregation's keys
and sums equal on the same records, every printed count and byte figure
equal (only the recovery's milliseconds masked), and the port's JSON line
holding the numbers it printed."""
import numpy as np
import pytest
import torch

from _torch_examples import load, masked, run_jax, run_port

torch.set_num_threads(2)

MS = r"\d+\.\d+ ms\b"


def _recording(fn, calls):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out)
        return out
    return wrapped


@pytest.fixture(scope="module")
def runs():
    jx, pt = load("cluster_quickstart"), load("torch_cluster_quickstart")
    jaggs, paggs = [], []
    jx.cluster_aggregate = _recording(jx.cluster_aggregate, jaggs)
    pt.cluster_aggregate = _recording(pt.cluster_aggregate, paggs)
    want = run_jax(jx)
    res, lines = run_port(pt)
    return dict(want=want, res=res, lines=lines, jaggs=jaggs, paggs=paggs)


def test_printed_counts_and_bytes_equal_the_reference(runs):
    assert len(runs["lines"]) == len(runs["want"]) == 10
    assert masked(runs["lines"], MS) == masked(runs["want"], MS)


@pytest.mark.parametrize("call", [0, 1], ids=["co_partitioned", "shuffled"])
def test_aggregate_keys_and_sums_equal_the_reference(runs, call):
    assert len(runs["paggs"]) == len(runs["jaggs"]) == 2
    (pk, pv), (jk, jv) = runs["paggs"][call], runs["jaggs"][call]
    assert len(pk) == 5000
    assert pk.dtype == np.asarray(jk).dtype and pv.dtype == np.asarray(jv).dtype
    assert np.array_equal(pk, np.asarray(jk))
    assert np.array_equal(pv, np.asarray(jv))


def test_json_line_holds_the_printed_numbers(runs):
    res, lines = runs["res"], runs["lines"]
    assert res["device"] == "cpu"
    shards = {int(n): c for n, c in res["shard_records"].items()}
    assert f"across 4 pools: {shards}" in lines[0]
    assert sum(shards.values()) == res["records"] == 200_000
    assert f"{res['groups']} groups; shuffle moved " \
           f"{res['shuffle_net_bytes'] / 1e6:.2f} MB" in lines[1]
    assert f"matched {res['joined_rows']} rows moving " \
           f"{res['join_net_bytes']} network bytes" in lines[2]
    assert res["join_net_bytes"] == 0
    assert f"{res['join_reserved_hwm_bytes'] / 1e3:.0f} KB" in lines[3]
    assert f"({res['columnar_groups']} groups, bit-for-bit)" in lines[4]
    assert f"{res['shards_recovered']} shards, {res['replicas_rebuilt']} " \
           f"replicas re-replicated, {res['recovery_bytes'] / 1e6:.2f} MB " \
           f"in {res['recovery_ms']:.1f} ms" in lines[6]
    assert res["proc_drained_records"] == 200_000
    assert res["orphan_processes"] == res["leaked_segments"] == 0
