"""The port's program spans (``repro_torch.trace``) on the CPU.

- The span tree of one smoke deepseek-v2-lite-16b train step with remat:
  ``pangea.step`` and its four phases, one ``pangea.layer`` a layer under
  ``pangea.step.forward`` and one more a layer inside
  ``pangea.step.backward`` (the remat recompute), the kernel entries' spans
  inside the layers; the data spans of ``run_training`` beside the steps.
- Off: nothing recorded, no span object, one shared no-op context, and
  no ``pangea.`` range in a ``torch.profiler`` trace of the same step (on:
  the ranges are there).
- ``drain()`` clears what it returns; spans of two threads keep their own
  parents.
"""
from __future__ import annotations

import collections
import threading

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import smoke_config
from repro_torch.launch.train import run_training
from repro_torch.models.model import build_model
from repro_torch.optim import make_train_state, make_train_step

PHASES = ("pangea.step.forward", "pangea.step.backward",
          "pangea.step.grad_norm", "pangea.step.update")


@pytest.fixture(autouse=True)
def spans_off():
    trace.enable(False)
    trace.drain()
    yield
    trace.enable(False)
    trace.drain()


def deepseek_step():
    """A smoke deepseek-v2-lite-16b train step with remat on the CPU over
    one batch: (the config, a function that takes one step)."""
    cfg = smoke_config("deepseek-v2-lite-16b").with_(
        remat="layer", compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    state = [make_train_state(model.init(torch.Generator().manual_seed(0)))]
    step = make_train_step(model.loss, lr=1e-3)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)), dtype=torch.int32)
    pad = torch.full((2, 1), -100, dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.cat([toks[:, 1:], pad], dim=1)}

    def run():
        state[0], metrics = step(state[0], batch)
        return metrics
    return cfg, run


def children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def inside(spans, outer):
    return [s for s in spans if s.thread == outer.thread
            and outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
            and s is not outer]


def test_the_span_tree_of_a_remat_train_step():
    cfg, run = deepseek_step()
    run()                                 # a first step, spans off
    trace.enable(True)
    run()
    spans = trace.drain()
    by_name = collections.Counter(s.name for s in spans)
    (step,) = [s for s in spans if s.name == "pangea.step"]
    assert step.parent is None and step.attrs == {"tokens": 32}
    phases = children(spans, step)
    assert [s.name for s in sorted(phases, key=lambda s: s.start_ns)] == \
        list(PHASES)
    fwd = next(s for s in phases if s.name == "pangea.step.forward")
    bwd = next(s for s in phases if s.name == "pangea.step.backward")
    L = cfg.n_layers
    first = children(spans, fwd)
    again = children(spans, bwd)
    assert [s.name for s in first] == ["pangea.layer"] * L
    assert [s.attrs["layer"] for s in first] == list(range(L))
    # the recompute: each layer once more, inside the backward
    assert [s.name for s in again] == ["pangea.layer"] * L
    assert sorted(s.attrs["layer"] for s in again) == list(range(L))
    assert by_name["pangea.layer"] == 2 * L
    for layer in first + again:
        names = collections.Counter(s.name for s in inside(spans, layer))
        assert names["pangea.flash"] == 1
        assert names["pangea.dispatch"] == 1 and names["pangea.combine"] == 1
    assert by_name["pangea.flash"] == 2 * L
    assert all(fwd.start_ns <= s.start_ns <= s.end_ns <= fwd.end_ns
               for s in first)
    assert all(bwd.start_ns <= s.start_ns <= s.end_ns <= bwd.end_ns
               for s in again)
    assert set(by_name) == {"pangea.step", "pangea.layer", "pangea.flash",
                            "pangea.dispatch", "pangea.combine", *PHASES}


def test_run_training_opens_the_data_spans_beside_each_step():
    trace.enable(True)
    res = run_training(smoke_config("qwen3-0.6b"), steps=2, batch_size=2,
                       seq_len=8, device="cpu", log_every=100)
    spans = trace.drain()
    assert res.steps == 2
    top = [s.name for s in sorted(spans, key=lambda s: s.start_ns)
           if s.parent is None]
    assert top == ["pangea.data.fetch", "pangea.data.to_device",
                   "pangea.step"] * 2


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_a_profiled_step_holds_pangea_ranges_only_when_on(on):
    _, run = deepseek_step()
    run()
    trace.enable(on)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    names = {e.name for e in prof.events()}
    spans = trace.drain()
    found = {n for n in names if n.startswith("pangea.")}
    if on:
        assert found == {s.name for s in spans}
        assert {"pangea.step", "pangea.layer", *PHASES} <= found
    else:
        assert found == set() and spans == []


def test_off_records_allocates_and_profiles_nothing(monkeypatch):
    first = trace.span("pangea.step", tokens=8192)
    assert trace.span("pangea.layer", layer=3) is first

    def refused(*a, **kw):
        raise AssertionError("spans are off")
    # no span object, no profiler call
    monkeypatch.setattr(trace, "_Open", refused)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    for i in range(1000):
        with trace.span("pangea.layer", layer=i % 4) as opened:
            assert opened is None
    assert trace.drain() == []


def test_drain_clears_what_it_returns():
    trace.enable(True)
    with trace.span("a"):
        with trace.span("b", k=1):
            pass
    got = trace.drain()
    assert [s.name for s in got] == ["b", "a"]
    assert got[0].parent == got[1].id and got[0].attrs == {"k": 1}
    assert got[1].start_ns <= got[0].start_ns <= got[0].end_ns \
        <= got[1].end_ns
    assert trace.drain() == []
    with trace.span("c"):
        pass
    assert [s.name for s in trace.drain()] == ["c"]


def test_spans_of_two_threads_keep_their_own_parents():
    trace.enable(True)
    ready = [threading.Barrier(2), threading.Barrier(2)]

    def body(tag):
        with trace.span(f"outer.{tag}"):
            ready[0].wait(timeout=10)      # both outers open at once
            with trace.span(f"inner.{tag}"):
                ready[1].wait(timeout=10)  # both inners open at once

    threads = [threading.Thread(target=body, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    spans = {s.name: s for s in trace.drain()}
    assert len(spans) == 4
    for tag in "xy":
        outer, inner = spans[f"outer.{tag}"], spans[f"inner.{tag}"]
        assert outer.parent is None and inner.parent == outer.id
        assert inner.thread == outer.thread
    assert spans["outer.x"].thread != spans["outer.y"].thread
