"""One runner a kind of traffic (a mix's ``runner``), and what they share:
the port's configuration built from a configuration file."""
from __future__ import annotations

import gc
import statistics
import sys
import time
from typing import Callable, Dict, List

import torch


def port_config(conf: Dict):
    """The port's ``ArchConfig`` for a configuration file: its registered
    config with the file's ``program.set`` applied, every field of
    ``program.same`` checked against the file's key it names, so that
    what runs is what the file states."""
    from repro_torch.configs import get_config
    prog = conf["program"]
    cfg = get_config(prog["arch"]).with_(**prog.get("set", {}))
    for attr, key in prog["same"].items():
        if getattr(cfg, attr) != conf[key]:
            raise ValueError(f"{conf['name']}: the port's {attr} is "
                             f"{getattr(cfg, attr)!r}, the file's {key} "
                             f"{conf[key]!r}")
    return cfg


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def served_dtype(conf: Dict) -> torch.dtype:
    return _DTYPES[conf["precision"]["served_weights"]]


def master_dtype(conf: Dict) -> torch.dtype:
    return _DTYPES[conf["precision"]["trained_weights"]]


def wall(t_perf: float) -> float:
    """A ``time.perf_counter()`` reading on the wall clock."""
    return time.time() - (time.perf_counter() - t_perf)


class Phases:
    """Seconds of each phase of a run on the host clock, from the
    process's start on."""

    def __init__(self, t_process: float):
        self._t = time.perf_counter()
        self.seconds = {"process_start": wall(self._t) - t_process}

    def mark(self, name: str):
        t = time.perf_counter()
        self.seconds[name] = t - self._t
        self._t = t


def spread(what: str, xs: List[float]):
    """One line on standard error: how ``xs`` (a value a batch or step of
    the window) lie."""
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else xs * 3
    print(f"perfbench: {what}: n {len(xs)} min {min(xs):.4f} q1 {q[0]:.4f} "
          f"median {q[1]:.4f} q3 {q[2]:.4f} max {max(xs):.4f}",
          file=sys.stderr)


def measure(step: Callable[[], Dict], seconds: float, tracer, device: str,
            t_process: float):
    """The window: the collector frozen, ``step()`` called until
    ``seconds`` have passed (the one in flight completes). In a traced run
    the profiler records the second half only: each record says whether
    it was ``traced``, so that host-clock readings come from the first
    half, with nothing recording ops, and device readings from the
    second. Returns (the steps' records, the set-up's seconds from the
    process's start, the trace's summary or None)."""
    if device == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    gc.disable()
    records = []
    try:
        t_open = time.perf_counter()
        setup_s = wall(t_open) - t_process
        half = t_open + seconds / 2
        while (not records or time.perf_counter() < t_open + seconds
               or tracer.enabled and not records[-1]["traced"]):
            if (tracer.enabled and not tracer.active and records
                    and time.perf_counter() >= half):
                tracer.start()
            rec = step()
            rec["traced"] = tracer.active
            records.append(rec)
        summary = tracer.stop()
    finally:
        gc.enable()
        gc.unfreeze()
    return records, setup_s, summary
