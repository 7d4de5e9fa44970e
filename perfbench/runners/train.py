"""Training through the port's train step and data pipeline.

Set-up builds one trainer: float32 master weights drawn from the seed on
the device, the port's ``make_train_state`` and ``make_train_step`` (its
AdamW, updating the state in place), and the feed ``run_training`` runs:
token rows drawn from the seed, written through the port's ``BufferPool``
and read back by its ``BatchLoader``, each batch completed by
``train_batch``. The trainer takes its first ``checked_steps`` steps
through that call and that feed, which warms every shape, and the same
trainer then runs the window, step after step, until its time is up.

The first steps are what the plain reference follows, from the same
weights and rows: each step's loss, each leaf's first gradient as the
optimizer got it (read from its first moment after one step), and the norm
of each leaf's change after the last checked step. The gaps of norms and
the distance of first gradients are taken by the worst leaf, against the
reference's norm of that leaf or of the median leaf, whichever is larger;
a leaf whose reference gradient is under a thousandth of the median
leaf's is left out of the change. The host copy of the first gradients,
which only the check needs, is taken before the window and its time left
out of the set-up's. Which of them are compared, and why,
the cell's limits file and ``PERF.md`` say.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import traffic, weights
from perfbench.runners import (Phases, master_dtype, measure, port_config,
                               spread)

SMALL_GRAD = 1e-3


class Trainer:
    """The port's train step, its state and its feed, built once."""

    def __init__(self, cell, seed: int, device: str, tracer):
        from repro_torch.core import BufferPool
        from repro_torch.data.pipeline import BatchLoader, write_token_dataset
        from repro_torch.launch.train import train_batch
        from repro_torch.models.model import build_model
        from repro_torch.optim import make_train_state, make_train_step

        self.conf, self.mix, self.ref = cell.conf, cell.mix, cell.reference
        self.seed, self.device, self.tracer = seed, device, tracer
        self.cfg = cfg = port_config(self.conf)
        self.leaves = self.ref.leaves(self.conf)
        opt = self.conf["optimizer"]
        params = weights.make(self.leaves, seed, master_dtype(self.conf),
                              device)
        self.state = make_train_state(params, cfg.opt_state_dtype)
        self.step_fn = make_train_step(build_model(cfg, device=device).loss,
                                       lr=opt["lr"],
                                       weight_decay=opt["weight_decay"])
        self.rows = traffic.train_rows(self.mix, seed, cfg.vocab)
        self.B = self.mix["batch_size"]
        self.pool = BufferPool(self.mix["pool_bytes"])
        ds = write_token_dataset(self.pool, "train_tokens", self.rows)
        self._train_batch = train_batch

        def feed():
            while True:
                for b in BatchLoader(ds, batch_size=self.B):
                    yield b
        self.batches = feed()
        self.done = 0
        self.check_s = 0.0

    def step(self) -> Dict:
        tr = self.tracer
        t0 = time.perf_counter()
        with tr.span("train.data"):
            batch = next(self.batches)
            tb = self._train_batch(self.cfg, batch, self.state.params,
                                   self.done, self.seed, self.device)
        t1 = time.perf_counter()
        with tr.span("train.step"):
            tr.phase = "train"
            self.state, metrics = self.step_fn(self.state, tb)
            loss = float(metrics["loss"])
        t2 = time.perf_counter()
        self.done = int(metrics["step"])
        return {"t_start": t0, "t_step": t1, "t_end": t2, "loss": loss,
                "tokens": int(np.prod(batch["tokens"].shape)),
                "batch": batch["tokens"].shape}

    def leaf_tensors(self, tree) -> List[torch.Tensor]:
        return [weights.get(tree, leaf[0]) for leaf in self.leaves]

    def checked_steps(self) -> Dict[str, List]:
        """The first steps, with what the reference compares: losses, each
        leaf's first gradient (first moment / (1 - beta1) after step 1),
        kept as a host copy, and its norm, and the norm of each leaf's
        change after the last checked step."""
        b1 = self.conf["optimizer"]["b1"]
        losses, grad, grad_t = [], [], []
        for i in range(self.mix["checked_steps"]):
            losses.append(self.step()["loss"])
            if i == 0:
                t0 = time.perf_counter()
                for m in self.leaf_tensors(self.state.opt.m):
                    g = m.float() / (1 - b1)
                    # the norm on the device: a float32 norm of a host copy
                    # sums hundreds of millions of squares and reads low
                    grad.append(float(g.norm()))
                    grad_t.append(g.to("cpu", copy=True))
                    del g
                # the check's own work, not the system's set-up
                self.check_s = time.perf_counter() - t0
        return {"loss": losses, "grad": grad, "grad_t": grad_t,
                "change": change_norms(self.leaf_tensors(self.state.params),
                                       self.leaves, self.seed, self.device,
                                       master_dtype(self.conf))}

    def free(self):
        self.state = self.step_fn = self.batches = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()


@torch.no_grad()
def change_norms(now: List[torch.Tensor], leaves, seed, device,
                 dtype) -> List[float]:
    """‖leaf now − leaf as drawn from the seed‖, one leaf drawn at a
    time."""
    return [float((t.float() - weights.draw(leaf, seed, i, dtype, device)
                   .float()).norm())
            for i, (t, leaf) in enumerate(zip(now, leaves))]


def reference_readings(cell, seed: int, rows: np.ndarray, device: str,
                       precision: str = "fp32", half: bool = False,
                       against: Dict = None, keep: bool = False) -> Dict:
    """The plain reference's losses, first gradients and changes over the
    checked steps, from the seed's weights and the same rows; with
    ``against`` (another side's readings, first gradients kept) also each
    leaf's distance to that side's first gradient; with ``keep`` its own
    first gradients as host copies. ``half``: each step's loss over the
    first half of its rows only (a fault)."""
    conf, mix, ref = cell.conf, cell.mix, cell.reference
    leaves = ref.leaves(conf)
    dtype = master_dtype(conf)
    params = weights.make(leaves, seed, dtype, device)
    ps = [weights.get(params, leaf[0]).requires_grad_(True)
          for leaf in leaves]
    opt = conf["optimizer"]
    m = [torch.zeros_like(p) for p in ps]
    v = [torch.zeros_like(p) for p in ps]
    B = mix["batch_size"]
    num = ref.Numerics(precision)
    losses, grad, out = [], None, {}
    with ref.no_tf32():
        for s in range(mix["checked_steps"]):
            toks = torch.as_tensor(rows[s * B:(s + 1) * B], device=device,
                                   dtype=torch.long)
            if half:
                toks = toks[:max(B // 2, 1)]
            loss = ref.loss(params, conf, toks, num)
            g = torch.autograd.grad(loss, ps)
            losses.append(float(loss.detach()))
            if s == 0:
                grad = [float(x.norm()) for x in g]
                if against:
                    out["grad_dists"] = distances(g, against["grad_t"])
                if keep:
                    out["grad_t"] = [x.to("cpu", copy=True) for x in g]
            adamw(ps, list(g), m, v, s + 1, opt)
            del g, loss
    change = change_norms(ps, leaves, seed, device, dtype)
    del params, ps, m, v
    gc.collect()
    return dict(out, loss=losses, grad=grad, change=change)


@torch.no_grad()
def distances(mine, theirs) -> List[float]:
    """‖a − b‖ of each leaf, b a host copy."""
    return [float((a.float() - b.to(a.device)).norm())
            for a, b in zip(mine, theirs)]


@torch.no_grad()
def adamw(ps, gs, m, v, t: int, opt: Dict):
    """AdamW as the configuration states it: bias-corrected moments,
    decoupled weight decay on leaves of rank 2 or more."""
    b1, b2, eps, lr, wd = (opt["b1"], opt["b2"], opt["eps"], opt["lr"],
                           opt["weight_decay"])
    for i, (p, g) in enumerate(zip(ps, gs)):
        m[i].mul_(b1).add_(g, alpha=1 - b1)
        v[i].mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m[i] / (1 - b1 ** t)) / ((v[i] / (1 - b2 ** t)).sqrt() + eps)
        if p.dim() >= 2:
            upd = upd + wd * p
        p.sub_(lr * upd)
        gs[i] = None


def worst(values, norms, keep=None, floor=True) -> float:
    """The largest of a leaf's value over its norm or the median leaf's
    norm, whichever is larger (over its own norm alone without ``floor``;
    leaves with ``keep`` false left out)."""
    med = statistics.median(norms) if floor else 0.0
    keep = keep or [True] * len(norms)
    return max(v / max(n, med) for v, n, k in zip(values, norms, keep) if k)


def compare(prog: Dict, ref: Dict, dists: List[float] = None
            ) -> Dict[str, float]:
    """The numbers compared: the worst step's relative loss gap, the worst
    leaf's gap of first-gradient norms and of change norms, and with
    ``dists`` (each leaf's distance between the two sides' first
    gradients) the worst leaf's distance; each of the last three also at
    the leaf's own norm (``*_own``, printed, not compared)."""
    gap = lambda a, b: [abs(x - y) for x, y in zip(a, b)]
    med = statistics.median(ref["grad"])
    moved = [g >= SMALL_GRAD * med for g in ref["grad"]]
    out = {"loss_gap": max(abs(a - b) / abs(b)
                           for a, b in zip(prog["loss"], ref["loss"]))}
    for name, values, norms in (
            ("grad_gap", gap(prog["grad"], ref["grad"]), ref["grad"]),
            ("change_gap", gap(prog["change"], ref["change"]), ref["change"]),
            ("grad_dist", dists, ref["grad"])):
        if values is not None:
            keep = moved if name == "change_gap" else None
            out[name] = worst(values, norms, keep)
            out[name + "_own"] = worst(values, norms, moved, floor=False)
    return out


def worst_leaf(dists: List[float], norms: List[float], leaves) -> str:
    """The leaf whose distance, over its norm or the median's, is worst."""
    med = statistics.median(norms)
    i = max(range(len(dists)), key=lambda j: dists[j] / max(norms[j], med))
    return "/".join(leaves[i][0])


def run(cell, *, seed: int, seconds: float, tracer, device: str,
        t_process: float):
    from perfbench.harness import Run

    phases = Phases(t_process)
    tr = Trainer(cell, seed, device, tracer)
    phases.mark("port_setup")
    prog = tr.checked_steps()
    phases.mark("checked_steps")
    phases.seconds["first_gradients_copy"] = tr.check_s
    records, setup_s, summary = measure(tr.step, seconds, tracer, device,
                                        t_process)
    setup_s -= tr.check_s
    spread("step s", [r["t_end"] - r["t_start"] for r in records])
    spread("data ms", [1e3 * (r["t_step"] - r["t_start"]) for r in records])
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    rows = tr.rows
    tr.free()
    phases.mark("window")
    ref = reference_readings(cell, seed, rows, device, against=prog)
    check = compare(prog, ref, ref["grad_dists"])
    phases.mark("check")
    return Run(kind="train", conf=cell.conf, mix=cell.mix,
               reference=cell.reference, setup_s=setup_s,
               records=records, attempted=len(records),
               failed=sum(not np.isfinite(r["loss"]) for r in records),
               memory_peak_bytes=peak, check=check, trace=summary,
               extra={"phases": phases.seconds})
