"""The port's serving examples against the JAX package's, both loaded by
path and run on the CPU.

- ``examples/torch_serving_quickstart.py`` against
  ``examples/serving_quickstart.py``: every slab the example reads (the
  pages before the kill, after the failover, and each session's in
  ``verify``) byte-identical, the same printed lines (the background
  spill counters' values masked), and ``attend`` within
  2e-5 of the reference's, on both the ``"xla"`` and the ``"kernel"`` impl.
- ``examples/torch_serve_paged.py`` against ``examples/serve_paged.py``,
  the port's ``ServeLoop`` given the reference's params (bridged): the same
  tokens for every request at fp32 compute and KV (in bf16 a near tie can
  flip a greedy token between the two packages' sums), and the same
  offload, fetch and byte counters at fp32 and as shipped (bf16).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_examples import load, masked, run_jax, run_port
from repro_torch.bridge import params_from_numpy

torch.set_num_threads(2)

PAGED_TOL = 2e-5
TOK_PER_S = r"\d+\.\d tok/s"
SPILL_COUNTS = r"(?<=': )\d+"


def _recording_tier(base, slabs, attends):
    class Recording(base):
        def sequence_slabs(self, seq_id):
            out = super().sequence_slabs(seq_id)
            slabs.append((seq_id, [np.asarray(s).tobytes() for s in out]))
            return out

        def attend(self, seq_ids, layer=0, impl="xla"):
            out = super().attend(seq_ids, layer=layer, impl=impl)
            attends.append((impl, {s: np.array(v) for s, v in out.items()}))
            return out
    return Recording


@pytest.fixture(scope="module")
def tier_runs():
    jx, pt = load("serving_quickstart"), load("torch_serving_quickstart")
    runs = {}
    for name, mod in (("jax", jx), ("port", pt)):
        runs[name] = dict(slabs=[], attends=[])
        mod.ServingTier = _recording_tier(mod.ServingTier,
                                          runs[name]["slabs"],
                                          runs[name]["attends"])
    runs["jax"]["lines"] = run_jax(jx)
    runs["port"]["res"], runs["port"]["lines"] = run_port(pt)
    return runs


def test_serving_quickstart_prints_the_reference_lines(tier_runs):
    """The same lines, but for the spill counters' values: a level-3
    spill goes through the cluster's transfer engine in the background,
    so whether it has landed when the line is printed is a matter of
    timing in both packages (the slabs' bytes are held below)."""
    got, want = (masked(tier_runs[k]["lines"], SPILL_COUNTS)
                 for k in ("port", "jax"))
    assert got == want and len(got) == 6
    assert "spill stats on seq 1's shard" in want[1]


def test_serving_quickstart_slabs_byte_identical(tier_runs):
    want, got = tier_runs["jax"]["slabs"], tier_runs["port"]["slabs"]
    # seq 1 before the kill, after the failover, then verify() of 1, 2, 3
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 1, 1, 2, 3]
    for (_, g), (_, w) in zip(got, want):
        assert len(g) == len(w) > 0
        assert g == w


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_serving_quickstart_attend_matches_the_reference(tier_runs, impl):
    (jimpl, want), = tier_runs["jax"]["attends"]
    assert jimpl == "xla"
    got = dict(tier_runs["port"]["attends"])[impl]
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for s in want:
        assert got[s].shape == want[s].shape == (2, 4)
        np.testing.assert_allclose(got[s], want[s], rtol=PAGED_TOL,
                                   atol=PAGED_TOL)
    res = tier_runs["port"]["res"]
    assert res["attend_max_abs_err"] <= PAGED_TOL
    assert res["killed"] not in res["attend_shards"]
    assert res["failovers"] >= 1 and res["leaked_reservations"] == 0


@functools.lru_cache(maxsize=None)
def _paged_run(compute):
    """Both serve_paged examples, the port's given the reference's params;
    ``compute`` "float32" runs both at fp32 compute and KV, so that no
    greedy argmax tie flips (tests/test_torch_serve.py does the same),
    "bfloat16" as shipped."""
    jx, pt = load("serve_paged"), load("torch_serve_paged")
    if compute == "float32":
        for mod in (jx, pt):
            mod.smoke_config = functools.partial(
                lambda arch, smoke: smoke(arch).with_(
                    compute_dtype="float32", kv_cache_dtype="float32"),
                smoke=mod.smoke_config)
    ref = {}

    class Recording(jx.ServeLoop):
        def run(self, requests):
            ref["loop"] = self
            ref["out"] = super().run(requests)
            return ref["out"]

    jx.ServeLoop = Recording
    ref["lines"] = run_jax(jx)
    params = params_from_numpy(jax.tree.map(np.asarray, ref["loop"].params),
                               device="cpu")
    pt.ServeLoop = functools.partial(pt.ServeLoop, params=params)
    res, lines = run_port(pt)
    return ref, res, lines


def test_serve_paged_tokens_equal_the_reference():
    ref, res, lines = _paged_run("float32")
    assert res["requests"] == len(ref["out"]) == 12
    assert {int(r): t for r, t in res["generated"].items()} == ref["out"]
    assert masked(lines, TOK_PER_S) == masked(ref["lines"], TOK_PER_S)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_serve_paged_pager_counters_equal_the_reference(compute):
    ref, res, lines = _paged_run(compute)
    assert res["offloads"] > 0 and res["fetches"] > 0
    for key in ("decode_tokens", "offloads", "fetches", "offload_bytes"):
        assert res[key] == ref["loop"].stats[key], key
    assert masked(lines[:2], TOK_PER_S) == masked(ref["lines"][:2], TOK_PER_S)
