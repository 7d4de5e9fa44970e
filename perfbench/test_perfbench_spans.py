"""The reduction of the port's spans (``perfbench/spans.py``) on synthetic
trace events, and the five readers that read it."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import spans, spans_run, tracing
from perfbench.test_perfbench_parts import CPU, GPU, Ev, fake_run, metric

AUTOGRAD = 2


def step_events():
    """One traced step: a forward with a layer and a flash call on the
    main thread; a backward whose kernels autograd's thread launches, one
    outside any span of its own, then a recomputed layer with a flash
    call; an update; a copy after the step."""
    return [
        Ev("pb.window", CPU, 0, 1000),
        Ev("train.step", CPU, 5, 985),
        Ev("pangea.step", CPU, 10, 900),
        Ev("pangea.step", GPU, 90, 800),          # device-side annotation
        Ev("pangea.step.forward", CPU, 20, 280),
        Ev("pangea.layer", CPU, 30, 130),
        Ev("pangea.flash", CPU, 40, 20),
        Ev("cudaLaunchKernel", CPU, 45, 2, corr=1),
        Ev("flash_fwd", GPU, 100, 40, corr=1),
        Ev("cuLaunchKernelEx", CPU, 150, 2, corr=2),
        Ev("moe_gemm", GPU, 150, 20, corr=2),
        Ev("pangea.step.backward", CPU, 310, 390),
        Ev("cudaLaunchKernel", CPU, 320, 2, tid=AUTOGRAD, corr=3),
        Ev("loss_bwd", GPU, 330, 70, corr=3),
        Ev("pangea.layer", CPU, 410, 90, tid=AUTOGRAD),
        Ev("cudaMemsetAsync", CPU, 420, 2, tid=AUTOGRAD, corr=4),
        Ev("Memset", GPU, 430, 50, corr=4),
        Ev("pangea.flash", CPU, 440, 20, tid=AUTOGRAD),
        Ev("cudaLaunchKernel", CPU, 445, 2, tid=AUTOGRAD, corr=5),
        Ev("flash_fwd", GPU, 490, 30, corr=5),
        Ev("cudaStreamSynchronize", CPU, 600, 5, corr=8),
        Ev("pangea.step.update", CPU, 710, 140),
        Ev("cudaLaunchKernel", CPU, 720, 2, corr=6),
        Ev("adamw", GPU, 730, 70, corr=6),
        Ev("cudaMemcpyAsync", CPU, 950, 2, corr=7),
        Ev("Memcpy_DtoH", GPU, 960, 10, corr=7)]


def test_kernels_go_to_the_innermost_span_of_their_launching_thread():
    s = spans.reduce_spans(step_events())
    assert s.steps == 1 and s.unattributed_s == 0
    # autograd's thread has no span open at 320: the step's thread's
    # innermost, the backward, takes its kernel
    assert s.device_s == pytest.approx({
        "pangea.flash": 70e-9, "pangea.layer": 20e-9,
        "pangea.step.backward": 70e-9, "pangea.layer.recompute": 50e-9,
        "pangea.step.update": 70e-9})


def test_phases_are_inclusive_and_the_backward_holds_the_recompute():
    s = spans.reduce_spans(step_events())
    assert s.phase_s == pytest.approx({
        "pangea.step": 280e-9, "pangea.step.forward": 60e-9,
        "pangea.step.backward": 150e-9, "pangea.step.update": 70e-9})
    # the layer that opened inside the backward: its kernel and its flash's
    assert s.recompute_s == pytest.approx(80e-9)


def test_launch_calls_inside_the_step_are_counted_on_every_thread():
    s = spans.reduce_spans(step_events())
    # 45, 150, 320, 420, 445, 720; not the sync at 600 nor the copy at 950
    assert s.launches == 6


def test_idle_gaps_are_named_by_the_launching_threads_span():
    s = spans.reduce_spans(step_events())
    assert dict(s.idle_gaps) == pytest.approx({
        "harness": 100e-9,                 # [0, 100): before any span
        "pangea.layer": 10e-9,             # [140, 150)
        "pangea.step.forward": 160e-9,     # [170, 330): autograd's thread
        # has none open: the step's thread's
        "pangea.step.backward": 240e-9,    # [400, 430), [520, 730)
        "pangea.layer.recompute": 10e-9,   # [480, 490)
        "pangea.step.update": 160e-9,      # [800, 960)
        "train.step": 30e-9})              # [970, 1000): the harness's
    busy = tracing.reduce([e for e in step_events() if not (
        e.device_type() == GPU and e.name().startswith("pangea."))], {})
    assert sum(v for _, v in s.idle_gaps) == pytest.approx(
        busy.window_s - busy.busy_s)


def test_a_trace_without_the_ports_spans_names_gaps_as_the_harness_does():
    ev = [e for e in step_events() if not e.name().startswith("pangea.")]
    s = spans.reduce_spans(ev)
    assert s.steps == 0 and s.launches == 0 and s.phase_s == {}
    assert dict(s.idle_gaps) == pytest.approx(
        dict(tracing.reduce(ev, {}).idle_gaps))


def test_stacks_name_every_open_span():
    look = spans._Open([(0, 100, "a"), (10, 20, "b"), (30, 60, "c"),
                        (40, 50, "d"), (200, 300, "e")])
    assert [look.at(t) for t in (5, 15, 35, 45, 55, 70, 150, 250)] == [
        ("a",), ("a", "b"), ("a", "c"), ("a", "c", "d"), ("a", "c"),
        ("a",), (), ("e",)]


def traced_run(with_spans=True):
    recs = [{"t_start": 5.0 + i, "t_step": 5.1 + i, "t_end": 5.9 + i,
             "loss": 1.0, "tokens": 8192, "batch": (2, 4096),
             "traced": i >= 2, "step_host_s": 0.25 + 0.1 * i}
            for i in range(6)]
    summary = tracing.Summary(window_s=4.0, busy_s=3.0,
                              range_s={"pb.adamw": 0.6}, work={},
                              device_ops=[], idle_gaps=[])
    if with_spans:
        summary.spans = spans.Spans(
            steps=4, device_s={}, recompute_s=0.4, launches=12000,
            unattributed_s=0.0,
            phase_s={"pangea.step": 2.8, "pangea.step.forward": 0.8,
                     "pangea.step.backward": 1.2})
    return fake_run("train", recs, trace=summary)


@pytest.mark.parametrize("name,value", [
    ("fwd_ms.train", 200.0), ("bwd_ms.train", 300.0),
    ("recompute_ms.train", 100.0), ("launches.train", 3000.0),
    ("step_host_ms.train", 300.0)])
def test_the_readers_of_the_ports_spans(name, value):
    assert metric(name, traced_run()) == pytest.approx(value)
    # no spans in the trace (the port's spans off): nothing to read
    run = traced_run(with_spans=False)
    for r in run.records:
        r.pop("step_host_s")
    assert metric(name, run) is None
    # spans in the trace but no step among them (the port's spans off)
    run.trace.spans = spans.Spans(steps=0, device_s={}, phase_s={},
                                  recompute_s=0.0, launches=0,
                                  unattributed_s=0.0)
    assert metric(name, run) is None
    assert metric(name, fake_run("serve", [])) is None


def test_each_record_takes_the_host_time_of_its_step():
    recs = [{"t_step": 1.0, "t_end": 2.0}, {"t_step": 3.0, "t_end": 4.0},
            {"t_step": 5.0, "t_end": 6.0}]
    closed = [SimpleNamespace(name="pangea.step", start_ns=int(s * 1e9),
                              end_ns=int(e * 1e9))
              for s, e in ((1.1, 1.6), (3.2, 3.9))]
    closed.append(SimpleNamespace(name="pangea.layer", start_ns=int(5.1e9),
                                  end_ns=int(5.2e9)))
    spans_run.step_host_seconds(recs, closed)
    assert recs[0]["step_host_s"] == pytest.approx(0.5)
    assert recs[1]["step_host_s"] == pytest.approx(0.7)
    assert recs[2]["step_host_s"] is None


def test_a_small_cell_runs_with_the_ports_spans_on_the_cpu():
    """The whole path on the CPU at a small size: the port's spans on for
    the run, the step's host time on every record, the spans' ranges in
    the profiler's trace (no device work there, so no device reading)."""
    from perfbench import smoke
    from repro_torch import trace
    cell = smoke.small_cell("dsv2l4.train.s4k")
    out = spans_run.measure(cell, 2 ** 31 + 91, 0.3, True, device="cpu")
    assert out["correct"] and not trace._on
    assert out["span_steps"] == out["steps"]["traced"] >= 1
    assert out["metrics"]["step_host_ms.train"]["value"] > 0
    assert out["phase_ms_per_step"] == {}
    off = spans_run.measure(cell, 2 ** 31 + 91, 0.3, False, device="cpu")
    assert off["span_steps"] == 0 and "step_host_ms.train" not in \
        off["metrics"]
