"""The benchmark's parts on the CPU: traffic, metric arithmetic, work
counts, trace reduction, the manifest and the rules on imports."""
from __future__ import annotations

import ast
import json
import math
import re
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import harness, readers, tracing, traffic, yardstick

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SERVE_MIX = json.loads((HERE / "traffic" / "serve.longdoc.json").read_text())
DS = json.loads((HERE / "configs" / "deepseek-v2-lite-16b.json").read_text())
SEEDS = [0, 1, 7, 2 ** 31 + 11, 2 ** 33, -5]


# ---------------------------------------------------------------- traffic --
@pytest.mark.parametrize("seed", SEEDS)
def test_every_seed_serves_the_same_lengths(seed):
    base = traffic.serve_lengths(SERVE_MIX, 0, 0)
    for cycle in (0, 1, 5):
        got = traffic.serve_lengths(SERVE_MIX, seed, cycle)
        assert sorted(got.ravel()) == sorted(base.ravel())


@pytest.mark.parametrize("seed", SEEDS)
def test_every_batch_takes_one_length_from_each_stratum(seed):
    strata = traffic._quantile_lengths(SERVE_MIX).reshape(
        SERVE_MIX["clients"], SERVE_MIX["cycle_batches"])
    for batch in traffic.serve_lengths(SERVE_MIX, seed, 3):
        for s, L in enumerate(sorted(batch)):
            assert L in strata[s]


def test_lengths_span_the_mix_log_uniformly():
    q = traffic._quantile_lengths(SERVE_MIX)
    lo, hi = SERVE_MIX["prompt_min"], SERVE_MIX["prompt_max"]
    assert lo <= q.min() and q.max() == traffic.max_prompt(SERVE_MIX) <= hi
    mid = math.exp((math.log(lo) + math.log(hi)) / 2)
    assert abs(np.median(q) - mid) / mid < 0.01


def test_the_seed_draws_order_and_tokens():
    a = traffic.serve_batches(SERVE_MIX, 3, 1000)
    b = traffic.serve_batches(SERVE_MIX, 3, 1000)
    c = traffic.serve_batches(SERVE_MIX, 4, 1000)
    for _ in range(3):
        x, y, z = next(a), next(b), next(c)
        assert all(np.array_equal(p.prompt, q.prompt) for p, q in zip(x, y))
        assert [len(p.prompt) for p in x] != [len(p.prompt) for p in z] or \
            not all(np.array_equal(p.prompt, q.prompt) for p, q in zip(x, z))
    mix = dict(dataset_rows=6, seq_len=5)
    assert np.array_equal(traffic.train_rows(mix, 9, 50),
                          traffic.train_rows(mix, 9, 50))
    assert len({tuple(r) for r in traffic.train_rows(mix, 9, 1 << 20)}) == 6


# ------------------------------------------------- end-to-end arithmetic --
def fake_run(kind, records, **kw):
    ref = harness.load_module(HERE / "reference" / "deepseek_v2.py", "ds")
    return harness.Run(kind=kind, conf=DS, mix={}, reference=ref,
                       setup_s=kw.get("setup_s", 12.5), records=records, attempted=0, failed=0,
                       memory_peak_bytes=0, check={},
                       trace=kw.get("trace"))


def metric(name, run):
    return harness.read_metrics(run, [{"name": name, "unit": "x"}]).get(
        name, {}).get("value")


def serve_timeline():
    # three batches of 4; the last ends past a 2 s window (it was in
    # flight at the close and completes)
    recs = []
    t = 10.0
    for ttft, dur, lens in ((0.5, 1.0, [10, 20, 30, 40]),
                            (0.7, 1.2, [15, 15, 15, 15]),
                            (0.9, 1.5, [5, 6, 7, 8])):
        recs.append({"t_send": t, "t_first": t + ttft, "t_done": t + dur,
                     "prompt_lens": lens, "returned": [4] * 4, "plen":
                     max(lens), "steps": 4,
                     "delta": {"prefill_s": ttft, "decode_s": dur - ttft,
                               "pager_s": 0.01}})
        t += dur
    return recs


def test_serve_metrics_from_a_timeline():
    run = fake_run("serve", serve_timeline())
    # 12 requests: nearest rank ceil(0.95 * 12) = 12th -> 0.9 s
    assert metric("ttft_p95_ms", run) == pytest.approx(900.0)
    tokens = 100 + 60 + 26 + 3 * 16
    assert metric("serve_tok_s", run) == pytest.approx(tokens / 3.7)
    assert metric("prefill_ms.serve", run) == pytest.approx(700.0)
    assert metric("decode_step_ms.serve", run) == pytest.approx(
        1e3 * (0.5 + 0.5 + 0.6) / 12)
    assert metric("pager_ms.serve", run) == pytest.approx(10.0)
    assert metric("setup_s", run) == 12.5
    assert metric("train_tok_s", run) is None
    assert metric("idle_share.serve", run) is None    # no trace


def test_the_tail_is_of_all_requests():
    assert readers.percentile(list(range(1, 101)), 95) == 95
    assert readers.percentile([3.0], 95) == 3.0
    assert readers.percentile(list(range(1, 21)), 95) == 19


def test_train_metrics_from_a_timeline():
    recs = [{"t_start": 5.0 + i, "t_step": 5.1 + i, "t_end": 5.9 + i,
             "loss": 1.0, "tokens": 8192, "batch": (2, 4096)}
            for i in range(4)]
    run = fake_run("train", recs)
    assert metric("train_tok_s", run) == pytest.approx(4 * 8192 / 3.9)
    assert metric("data_ms.train", run) == pytest.approx(100.0)
    assert metric("ttft_p95_ms", run) is None
    flops = 4 * readers.train_flops(run, recs[0])
    assert metric("mfu.train", run) == pytest.approx(
        100 * flops / 3.9 / 989e12)


def test_a_traced_run_reads_the_host_clock_in_its_untraced_half():
    """Host-clock metrics read the first half's records, which ran with
    the profiler off; device time a step divides by the traced half's."""
    recs = [{"t_start": 5.0 + i, "t_step": 5.1 + i + 0.1 * (i >= 2),
             "t_end": 5.9 + i, "loss": 1.0, "tokens": 8192,
             "batch": (2, 4096), "traced": i >= 2} for i in range(5)]
    summary = tracing.Summary(window_s=3.0, busy_s=2.4,
                              range_s={"pb.adamw": 0.6}, work={},
                              device_ops=[], idle_gaps=[])
    run = fake_run("train", recs, trace=summary)
    assert metric("data_ms.train", run) == pytest.approx(100.0)
    assert metric("mfu.train", run) == pytest.approx(
        100 * 2 * readers.train_flops(run, recs[0]) / 1.9 / 989e12)
    assert metric("adamw_ms.train", run) == pytest.approx(200.0)
    assert metric("idle_share.train", run) == pytest.approx(20.0)


def test_the_profiler_records_the_second_half_of_a_window():
    """The profiler starts once, past the window's half: the records before
    are untraced, those after traced, and a traced window closes on a
    traced record even where its first step outlasts the window."""
    from perfbench.runners import measure

    def tracer():
        t = tracing.Tracer(True)
        t.start = lambda: setattr(t, "_prof", "on")    # no profiler here
        t.stop = lambda: None
        return t

    def step(seconds):
        return lambda: (time.sleep(seconds), {})[1]
    flags = [r["traced"] for r in measure(step(0.01), 0.2, tracer(), "cpu",
                                          time.time())[0]]
    assert flags == sorted(flags) and 0 < flags.count(True) < len(flags)
    flags = [r["traced"] for r in measure(step(0.05), 0.01, tracer(), "cpu",
                                          time.time())[0]]
    assert flags == [False, True]
    flags = [r["traced"] for r in measure(step(0.01), 0.05,
                                          tracing.Tracer(False), "cpu",
                                          time.time())[0]]
    assert not any(flags)


# --------------------------------------------------------------- the work --
def test_deepseek_work_by_hand():
    ref = harness.load_module(HERE / "reference" / "deepseek_v2.py", "ds")
    attn = (2048 * 16 * 192 + 2048 * 512 + 2048 * 64 + 512 * 16 * 256
            + 16 * 128 * 2048)
    moe = 2048 * 64 + 3 * 2048 * 1408 * 8
    assert ref.matmul_params(DS) == 27 * (attn + moe) + 2048 * 102400
    assert ref.attn_pair_flops(DS) == 27 * 2 * 16 * 320
    run = fake_run("serve", [])
    assert readers.prefill_flops(run, 4) == (
        2 * ref.matmul_params(DS) * 4 + ref.attn_pair_flops(DS) * 10)
    rec = {"prompt_lens": [3, 5], "plen": 5, "steps": 2}
    assert readers.decode_flops(run, rec) == 2 * (
        2 * ref.matmul_params(DS) * 2 + ref.attn_pair_flops(DS) * (6 + 7))
    assert readers.train_flops(run, {"batch": (2, 3)}) == 3 * 2 * (
        2 * ref.matmul_params(DS) * 3 + ref.attn_pair_flops(DS) * 6)
    total = sum(math.prod(s) for _, s, _ in ref.leaves(DS))
    assert abs(total - 16.21e9) < 0.01e9


@pytest.mark.parametrize("shape,bound_us", [
    # qwen3-0.6b's prefill: B=4, H=16, KH=8, T=512, D=128, bf16, causal
    (((4, 16, 512, 128), (4, 8, 512, 128), (4, 8, 512, 128)), 7.5116),
    # deepseek-v2-lite-16b's: H=KH=16, D=192, Dv=128
    (((4, 16, 512, 192), (4, 16, 512, 192), (4, 16, 512, 128)), 12.5203),
])
def test_flash_work_by_hand(shape, bound_us):
    q, k, v = shape
    nbytes, flops = yardstick.flash_work(q, k, v, 2, True)
    elems = (math.prod(q) + math.prod(k) + math.prod(v)
             + math.prod(q[:3]) * v[3])
    assert nbytes == 2 * elems
    assert flops == 2 * (q[3] + v[3]) * q[0] * q[1] * 512 * 513 // 2
    assert yardstick.bound_s(nbytes, flops) * 1e6 == pytest.approx(
        bound_us, abs=1e-3)
    with_lse, _ = yardstick.flash_work(q, k, v, 2, True, lse=True)
    assert with_lse == nbytes + 4 * math.prod(q[:3])


def test_live_pairs():
    assert yardstick.live_pairs(4, 4, True) == 10
    assert yardstick.live_pairs(1, 10, True, q_offset=9) == 10
    assert yardstick.live_pairs(3, 5, False) == 15
    assert yardstick.live_pairs(3, 5, True, q_offset=-1) == 3


def test_shuffle_work_by_hand():
    # deepseek's prefill: 2048 tokens top-6 into 4 x 64 buffers of 60
    nbytes, flops = yardstick.dispatch_work(2048, 6, 256, 60, 2048, 2,
                                            12288, 2048)
    assert nbytes == (2048 + 15360) * 4096 + 2 * 12288 * 4
    assert flops == 12288 * 2048
    assert yardstick.bound_s(nbytes, flops) * 1e3 == pytest.approx(
        0.02131, abs=1e-5)
    nbytes, flops = yardstick.combine_work(2048, 6, 2048, 2, 12000)
    assert nbytes == (12000 + 2048) * 4096 + 2 * 12288 * 4 + 12288 * 2
    assert flops == 2 * 12000 * 2048


# ---------------------------------------------------------------- tracing --
class Ev:
    def __init__(self, name, dev, s, d, tid=1, corr=0):
        self._v = (name, dev, s, d, tid, corr)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def duration_ns(self): return self._v[3]
    def start_thread_id(self): return self._v[4]
    def correlation_id(self): return self._v[5]


CPU, GPU = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def test_trace_reduction():
    bwd = "autograd::engine::evaluate_function: _FlashAttentionBackward0"
    ev = [Ev("pb.window", CPU, 0, 1000),
          Ev("serve.batch", CPU, 10, 900),
          Ev("serve.decode_step", CPU, 500, 300),
          Ev("pb.flash.prefill", CPU, 20, 50),
          Ev("cudaLaunchKernel", CPU, 30, 5, corr=101),
          Ev("flash_kernel", GPU, 100, 40, corr=101),
          Ev(bwd, CPU, 200, 100, tid=2),
          Ev("pb.shuffle.train", CPU, 210, 20, tid=2),
          Ev("cudaLaunchKernel", CPU, 215, 2, tid=2, corr=102),
          Ev("dispatch_kernel", GPU, 230, 10, corr=102),
          Ev("cudaLaunchKernel", CPU, 250, 2, tid=2, corr=103),
          Ev("bwd_kernel", GPU, 260, 60, corr=103),
          # no launch record: the device-side annotation names its range
          Ev("pb.adamw", GPU, 600, 100),
          Ev("adam_kernel", GPU, 610, 50, corr=999),
          Ev("cudaLaunchKernel", CPU, 700, 2, corr=104),
          Ev("late_kernel", GPU, 990, 30, corr=104)]
    s = tracing.reduce(ev, {})
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx((40 + 10 + 60 + 50 + 10) * 1e-9)
    assert s.range_s == pytest.approx({
        "pb.flash.prefill": 40e-9, "pb.shuffle.train": 10e-9,
        tracing.ATTN_BWD: 60e-9, "pb.adamw": 50e-9})
    idle = dict(s.idle_gaps)
    # gaps [0,100] before any span, [140,230] [240,260] [320,610] in the
    # batch, [660,990] in a decode step
    assert idle == pytest.approx({"harness": 100e-9, "serve.batch": 400e-9,
                                  "serve.decode_step": 330e-9})
    assert dict(s.device_ops)["bwd_kernel"] == pytest.approx(60e-9)


def test_innermost_segments():
    segs = tracing._segments([(0, 100, "a"), (10, 20, "b"), (30, 60, "c"),
                              (40, 50, "d"), (200, 300, "e")])
    look = tracing._Lookup(segs)
    assert [look.at(t) for t in (5, 15, 35, 45, 55, 70, 150, 250)] == [
        "a", "b", "c", "d", "c", "a", None, "e"]


def test_roofline_reads_nothing_without_calls():
    summary = tracing.Summary(window_s=1.0, busy_s=0.25, range_s={},
                              work={}, device_ops=[], idle_gaps=[])
    run = fake_run("serve", serve_timeline(), trace=summary)
    assert metric("flash_roofline.prefill", run) is None
    assert metric("idle_share.serve", run) == pytest.approx(75.0)
    summary.range_s["pb.flash.prefill"] = 2e-3
    summary.work["pb.flash.prefill"] = [0, 0, 1e-3, 27]
    assert metric("flash_roofline.prefill", run) == pytest.approx(50.0)


# --------------------------------------------------------------- manifest --
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_manifest_names_and_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    reported = {c: {m["name"] for m in BENCH["end_to_end"]
                    if c in m.get("workloads", [c])} for c in cells}
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        for c in m.get("workloads", cells):
            assert m["moves"] in reported[c], (m["name"], c)
    for m in BENCH["end_to_end"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])


PUBLISHED = {p["source_url"]: p["config"] for p in (
    json.loads(f.read_text()) for f in sorted((HERE / "published").glob("*.json")))}
WIDTH = re.compile(r"_dim$|_rank$|(hidden|intermediate)_size$|heads?$|expan"
                   r"|per_tok")


@pytest.mark.parametrize(
    "entry", harness.load_bench(held_out=True)["configs"],
    ids=lambda c: c["name"])
def test_a_configuration_holds_its_published_config(entry):
    """Every key of the published config is in the file, equal to it but
    for the keys ``reduced`` lists; none of those is a width, and a group
    it lists keeps every width inside it."""
    conf = json.loads((ROOT / entry["file"]).read_text())
    pub = PUBLISHED[entry["source"]]
    assert set(pub) <= set(conf)
    same = lambda a, b: type(a) is type(b) and a == b
    changed = {k for k in pub if not same(conf[k], pub[k])}
    assert changed == set(entry["reduced"]) == set(conf["reduced"])
    for k in changed:
        assert not WIDTH.search(k), k
        if isinstance(pub[k], dict):
            assert isinstance(conf[k], dict) and set(pub[k]) == set(conf[k])
            for kk in pub[k]:
                assert not WIDTH.search(kk) or same(conf[k][kk], pub[k][kk])


@pytest.mark.parametrize("factor,plain", [(1, True), (0.5, True), (40, False)])
def test_the_reference_rotates_only_plainly(factor, plain):
    ref = harness.load_module(HERE / "reference" / "deepseek_v2.py", "ds")
    conf = dict(DS, rope_scaling=dict(DS["rope_scaling"], factor=factor))
    if plain:
        assert ref.rope_theta(conf) == DS["rope_theta"]
        assert ref.rope_theta(dict(DS, rope_scaling=None)) == DS["rope_theta"]
    else:
        with pytest.raises(ValueError, match="not plain RoPE"):
            ref.rope_theta(conf)


def test_added_files_are_found_without_editing(tmp_path, monkeypatch):
    shutil.copytree(HERE, tmp_path / "perfbench")
    bench = json.loads(json.dumps(BENCH))
    conf = dict(DS, name="deepseek-v2-lite-16b-l2", num_hidden_layers=2)
    (tmp_path / "perfbench" / "configs" / "new.json").write_text(
        json.dumps(conf))
    (tmp_path / "perfbench" / "traffic" / "serve.short.json").write_text(
        json.dumps(dict(SERVE_MIX, prompt_min=128, prompt_max=512)))
    (tmp_path / "perfbench" / "limits" / "new.cell.json").write_text(
        json.dumps({"logit_gap": 0.5}))
    (tmp_path / "perfbench" / "metrics" / "batches.serve.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    bench["configs"].append({"name": conf["name"], "source": DS["source"],
                             "file": "perfbench/configs/new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new.cell", "config": conf["name"],
                               "traffic": "serve.short", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "batches.serve", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "serve_tok_s",
                               "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", tmp_path / "perfbench")
    cell = harness.load_cell("new.cell")
    assert cell.conf["num_hidden_layers"] == 2
    assert cell.mix["prompt_max"] == 512
    assert cell.limits == {"logit_gap": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["batches.serve"]
    run = fake_run("serve", serve_timeline())
    assert harness.read_metrics(run, cell.per_layer) == {
        "batches.serve": {"value": 3.0, "unit": "batches"}}
    assert cell.runner.__name__.endswith("serve_closed_loop")


# ---------------------------------------------------------------- imports --
def imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    roots = set(imported_roots(path))
    assert not roots & set(harness.FORBIDDEN), roots
    if path.parent.name == "reference":
        assert "repro_torch" not in roots


def test_forbidden_names_are_compared_whole(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "reprox", SimpleNamespace())
    monkeypatch.setitem(sys.modules, "jaxline.x", SimpleNamespace())
    found = harness.forbidden_modules()
    assert "reprox" not in found and "jaxline" not in found
    monkeypatch.setitem(sys.modules, "flax.linen", SimpleNamespace())
    assert "flax" in harness.forbidden_modules()
