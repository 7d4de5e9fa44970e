"""A training cell with the port's own spans on: ``python3
perfbench/spans_run.py --workload <name> --seed <n> --seconds <s>
[--spans 0|1]``, from the root of a checkout, on the card.

It runs the cell as ``run.py --trace 1`` does (the profiler over the
window's second half, the harness's ranges and readers unchanged) and,
with ``--spans 1`` (the default), turns on ``repro_torch.trace`` for the
whole run: both halves record the port's spans, the traced half also as
profiler ranges. It prints one JSON line: the cell's per-layer metrics and
the five that read the port's spans (``perfbench/spans.py``), the idle
gaps by span, the device seconds by span and phase a step, and the step's
host-clock median in each half. ``--spans 0`` runs the same with the
port's spans off, so two runs on one machine give the cost of the spans
when on. Device time comes from the card only: it exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import harness, readers, spans, tracing  # noqa: E402

METRICS = [{"name": n, "unit": u} for n, u in (
    ("fwd_ms.train", "ms"), ("bwd_ms.train", "ms"),
    ("recompute_ms.train", "ms"), ("step_host_ms.train", "ms"),
    ("launches.train", "count"))]


class SpanTracer(tracing.Tracer):
    """``tracing.Tracer(True)`` that turns the port's spans on (with
    ``spans``) and also reduces its trace by them."""

    def __init__(self, spans_on: bool):
        super().__init__(True)
        from repro_torch import trace
        trace.enable(spans_on)

    def stop(self):
        if not self.active:
            return None
        self._window.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.uninstrument()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        # the port's ranges' device-side annotations are not work
        work = [e for e in events if not (
            e.device_type() != torch.autograd.DeviceType.CPU
            and e.name().startswith("pangea."))]
        summary = tracing.reduce(work, dict(self.work))
        summary.spans = spans.reduce_spans(events)
        return summary


def step_host_seconds(records, closed) -> None:
    """Each record's ``step_host_s``: the host seconds of the
    ``pangea.step`` that ran between its ``t_step`` and ``t_end``."""
    steps = sorted((s.start_ns * 1e-9, s.end_ns * 1e-9) for s in closed
                   if s.name == spans.STEP)
    for r in records:
        inside = [e - s for s, e in steps
                  if r["t_step"] <= s and e <= r["t_end"]]
        r["step_host_s"] = inside[0] if len(inside) == 1 else None


def measure(cell, seed: int, seconds: float, spans_on: bool,
            device: str = "cuda") -> Dict:
    """Run ``cell`` traced, the port's spans on or off; the result line."""
    from repro_torch import trace
    tracer = SpanTracer(spans_on)
    t0 = time.perf_counter()
    try:
        run = cell.runner.run(cell, seed=seed, seconds=seconds,
                              tracer=tracer, device=device,
                              t_process=harness.process_start())
        step_host_seconds(run.records, trace.drain())
    finally:
        trace.enable(False)
    s = run.trace.spans
    n = len(readers.traced(run))
    walls = {half: [r["t_end"] - r["t_start"] for r in run.records
                    if r["traced"] == traced]
             for half, traced in (("untraced", False), ("traced", True))}
    verdict = harness.judge(run.check, cell.limits)
    per_step = lambda d: {k: 1e3 * v / n for k, v in d.items()}
    return {
        "workload": cell.name, "seed": seed, "spans": int(spans_on),
        "card": harness.card_state() if device == "cuda" else device,
        "correct": harness.correct(verdict),
        "metrics": harness.read_metrics(run, cell.per_layer + METRICS),
        "step_median_s": {k: statistics.median(v) for k, v in walls.items()},
        "steps": {k: len(v) for k, v in walls.items()},
        "busy_ms_per_step": 1e3 * run.trace.busy_s / n,
        "window_s": run.trace.window_s, "busy_s": run.trace.busy_s,
        "span_steps": s.steps,
        "phase_ms_per_step": per_step(s.phase_s),
        "span_ms_per_step": per_step(s.device_s),
        "unattributed_ms_per_step": 1e3 * s.unattributed_s / n,
        "idle_gaps_s": s.idle_gaps,
        "harness_idle_gaps_s": run.trace.idle_gaps,
        "harness_range_ms_per_step": per_step(run.trace.range_s),
        "device_ops": run.trace.device_ops,
        "memory_peak_bytes": run.memory_peak_bytes,
        "run_s": time.perf_counter() - t0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("spans_run: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(measure(cell, args.seed, args.seconds,
                             bool(args.spans))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
