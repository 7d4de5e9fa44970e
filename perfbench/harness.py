"""Run one cell of ``BENCHMARK.json`` and print its result line.

Everything of a cell is found by name: its configuration file (the
``file`` of its entry in ``configs``), its traffic mix
``perfbench/traffic/<traffic>.json`` (whose ``runner`` names
``perfbench/runners/<runner>.py``), the limits of its check
``perfbench/limits/<workload>.json``, the plain reference of its model
``perfbench/reference/<reference>.py`` and a reader
``perfbench/metrics/<metric>.py`` for each metric it reports. A cell, a
mix or a metric is added by adding files and entries; no file here names
one.

A run: the runner sets the cell up from the seed, measures for
``--seconds`` and hands back its records; the metrics are read from them
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics, from the same records and the trace); then the timed
path's outputs are compared with the plain reference, and each number
compared is printed beside its limit, last on standard error and last in
the result line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of the benchmark, its files read."""
    name: str
    chips: int
    conf: Dict                   # the configuration file
    mix: Dict                    # the traffic file
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def reference(self):
        return load_module(HERE / "reference" / f"{self.conf['reference']}.py",
                           f"perfbench_reference_{self.conf['reference']}")

    @property
    def runner(self):
        return load_module(HERE / "runners" / f"{self.mix['runner']}.py",
                           f"perfbench_runner_{self.mix['runner']}")


def load_bench(held_out: bool = False) -> Dict:
    """``BENCHMARK.json``; with ``held_out`` also the entries of the cells
    kept out of it until the program can pass them
    (``perfbench/held_out.json``), which only the tests and
    ``calibrate.py`` read."""
    bench = load_json(ROOT / "BENCHMARK.json")
    if held_out:
        held = load_json(HERE / "held_out.json")
        bench = {k: v + held.get(k, []) if isinstance(v, list) else v
                 for k, v in bench.items()}
    return bench


def load_cell(name: str, bench: Optional[Dict] = None,
              held_out: bool = False) -> Cell:
    bench = bench or load_bench(held_out)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    reports = lambda m: name in m.get("workloads", [name])
    return Cell(name=name, chips=w["chips"],
                conf=load_json(ROOT / conf_entry["file"]),
                mix=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=limits(name),
                end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                per_layer=[m for m in bench["per_layer"] if reports(m)])


def limits(name: str) -> Dict[str, float]:
    """The limits of a cell's check; none (so that no run of it reads
    correct) where the cell has no limits file yet."""
    path = HERE / "limits" / f"{name}.json"
    return load_json(path) if path.exists() else {}


@dataclass
class Run:
    """What a runner hands back: the window's records and what set-up,
    the device and the check saw. Metric readers read it."""
    kind: str                            # "serve" or "train"
    conf: Dict
    mix: Dict
    reference: Any                       # the configuration's reference
    setup_s: float
    records: List[Dict]
    attempted: int
    failed: int
    memory_peak_bytes: int
    check: Dict[str, float]              # number compared -> reading
    trace: Any = None                    # trace.Summary of a traced run
    extra: Dict = field(default_factory=dict)


def process_start() -> float:
    """The wall-clock time this process started (from /proc where it
    exists, else the import of this module)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def read_metrics(run: Run, specs: List[Dict]) -> Dict[str, Dict]:
    out = {}
    for m in specs:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             "perfbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(check: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each number compared beside its limit; a missing or non-finite
    number fails."""
    out = {}
    for name, limit in limits.items():
        v = check.get(name)
        ok = v is not None and v == v and v <= limit
        out[name] = {"value": v, "limit": limit, "ok": ok}
    return out


def correct(verdict: Dict) -> bool:
    """Correct: there are numbers to compare and each is within its
    limit."""
    return bool(verdict) and all(v["ok"] for v in verdict.values())


def device_info(run: Run, chips: int) -> Dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def card_state() -> str:
    """The card's name, power limit and SM clock, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda") -> Dict:
    """Run ``cell`` and return its result (the dict of the result line)."""
    from . import tracing
    tracer = tracing.Tracer(trace)
    run = cell.runner.run(cell, seed=seed, seconds=seconds, tracer=tracer,
                          device=device, t_process=process_start())
    specs = cell.per_layer if trace else cell.end_to_end
    verdict = judge(run.check, cell.limits)
    result = {"correct": correct(verdict),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": read_metrics(run, specs)}
    if device == "cuda":
        result["device"] = device_info(run, cell.chips)
    if run.trace is not None:
        result["breakdown"] = {
            "device_ops": [list(x) for x in run.trace.device_ops],
            "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    result["check"] = {k: {"value": v["value"], "limit": v["limit"]}
                       for k, v in verdict.items()}
    print("perfbench: seconds " + " ".join(
        f"{k} {v:.3f}" for k, v in run.extra.get("phases", {}).items()),
        file=sys.stderr, flush=True)
    for k, v in run.check.items():
        if k not in cell.limits:
            print(f"perfbench: read {k} {v!r} (not compared)",
                  file=sys.stderr)
    return result


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    cell = load_cell(args.workload)
    import torch
    print(f"perfbench: torch imported at {time.time() - process_start():.3f}"
          f" s", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s);"
              f" found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"perfbench: {args.workload} seed {args.seed} on "
          f"{card_state()}", file=sys.stderr, flush=True)
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print(f"perfbench: after the window: {card_state()}", file=sys.stderr)
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0
