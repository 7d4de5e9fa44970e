"""Readings that the limits of ``perfbench/limits`` are set from.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 8]

For each seed, in one process: the timed path at the cell's own size and
the plain reference, the numbers the run's own check compares (the lower
readings), and whether the harness judges them correct against the cell's
limits. For each control seed also the control: the reference put in the
port's place in float8 (the precision below the configuration's bf16); a
serving control is read, at each position of the same prompts and tokens,
as the gap of the token the float8 reference puts first. A training
cell's fault seeds read the fault "half of the batch left out, the mean
taken over the rest", planted in the reference put in the port's place.
Control seeds also read a witness: the reference with its products'
operands and results rounded to bf16, the port's precision. Each side's
numbers are judged by ``harness.judge`` as a run's are. A cell held out of
``BENCHMARK.json`` (``perfbench/held_out.json``) can be read too. One JSON
line a reading goes to standard output and, with ``--out FILE``, to that
file.
"""
from __future__ import annotations

import sys
from pathlib import Path

if __name__ == "__main__":
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(_ROOT), str(_ROOT / "src")]

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from perfbench import harness, tracing  # noqa: E402


def place_limit(lower: float, upper: float) -> float:
    """A limit between the program's largest reading and the smallest
    reading that has to fail, two thirds of the way up on a log scale:
    more room above the lower reading, since fresh seeds read higher than
    a dozen did."""
    return lower ** (1 / 3) * upper ** (2 / 3)


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def judged(prefix: str, check, limits) -> dict:
    """A side's numbers under ``prefix``, and whether the harness's own
    judgement against the cell's limits finds it correct."""
    out = {prefix + k: v for k, v in check.items()}
    out[prefix + "correct"] = harness.correct(harness.judge(check, limits))
    return out


def serve_readings(cell, seed, seconds, control, device):
    """A run's own check; the mean gap of the requests whose prompt was the
    longest of their batch (which the loop serves with no padding) and of
    the others apart; with ``control`` the control and the witness, read
    at the same requests as the gap of the token each puts first."""
    drv = cell.runner
    run = drv.run(cell, seed=seed, seconds=seconds,
                  tracer=tracing.Tracer(False), device=device,
                  t_process=harness.process_start())
    checked, l32 = run.extra["checked"], run.extra["logits"]
    rows = drv.gap_of(l32, [c.want for c in checked])
    out = dict(judged("", run.check, cell.limits), batches=len(run.records),
               checked=len(checked))
    for name, pick in (("longest.", True), ("others.", False)):
        part = [r for r, c in zip(rows, checked) if c.longest == pick]
        out[name + "n"] = len(part)
        if part:
            out.update({name + k: v for k, v in drv.mean_gap(part).items()})
    if control:
        params = run.extra["params"]
        for name, precision in (("control.", "fp8"), ("bf16.", "bf16")):
            lg = drv.reference_logits(cell.reference, cell.conf, params,
                                      checked, precision)
            out.update(judged(name, drv.mean_gap(drv.gap_of(
                l32, [x.argmax(-1) for x in lg])), cell.limits))
    return out


def train_readings(cell, seed, control, fault, device):
    drv = cell.runner
    tr = drv.Trainer(cell, seed, device, tracing.Tracer(False))
    prog = tr.checked_steps()
    rows = tr.rows
    tr.free()
    ref32 = drv.reference_readings(cell, seed, rows, device, against=prog,
                                   keep=control or fault)
    leaves = cell.reference.leaves(cell.conf)
    out = dict(judged("", drv.compare(prog, ref32, ref32["grad_dists"]),
                      cell.limits),
               grad_dist_leaf=drv.worst_leaf(ref32["grad_dists"],
                                             ref32["grad"], leaves))
    for name, on, kw in (("control.", control, {"precision": "fp8"}),
                         ("bf16.", control, {"precision": "bf16"}),
                         ("half_batch.", fault, {"half": True})):
        if on:
            other = drv.reference_readings(cell, seed, rows, device,
                                           against=ref32, **kw)
            out.update(judged(name, drv.compare(other, ref32,
                                                other["grad_dists"]),
                              cell.limits))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, held_out=True)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    print(harness.card_state(), file=sys.stderr, flush=True)
    with (open(args.out, "a") if args.out
          else contextlib.nullcontext()) as log:
        for seed in args.seeds:
            t0 = time.perf_counter()
            control = seed in args.control_seeds
            if cell.mix["runner"] == "serve_closed_loop":
                r = serve_readings(cell, seed, args.seconds, control, "cuda")
            else:
                r = train_readings(cell, seed, control,
                                   seed in args.fault_seeds, "cuda")
            r["seconds"] = time.perf_counter() - t0
            line = json.dumps(dict(workload=args.workload, seed=seed, **r))
            print(line, flush=True)
            if log:
                log.write(line + "\n")
                log.flush()
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
