"""Program spans: named intervals of the port's own work, on the host clock.

Spans are off unless a caller turns them on with ``enable(True)`` (the
benchmark's traced runs do, for the whole run); there is no environment
variable and no configuration field. Off, ``span(...)`` checks one
module-level flag and returns one shared no-op context: it records
nothing, allocates nothing and calls no profiler.

On, each span keeps a per-thread stack, so a span knows the span open
around it on its own thread, and each closed span is kept in memory as a
``Span`` (name, id, parent id, thread id, start and end from
``time.perf_counter_ns()``, attrs) until ``drain()`` hands them over. While
a ``torch.profiler`` is recording, a span also opens a
``torch.profiler.record_function`` range of its name, so that it and the
kernels launched inside it lie on one clock in one trace.

The spans the port opens (all named ``pangea.*``):

- ``pangea.step``: ``optim.train_state``'s train step, entry to return
  (attr ``tokens``: the batch's label count); inside it
  ``pangea.step.forward`` (the loss function: compute cast, layers,
  logits, loss), ``pangea.step.backward`` (``torch.autograd.grad`` of the
  loss), ``pangea.step.grad_norm`` (the gradients' norm) and
  ``pangea.step.update`` (``adamw_apply``);
- ``pangea.layer``: one layer or hybrid superblock of ``models.lm.LM``
  (attr ``layer``: its index). Under ``remat == "layer"`` the backward
  runs each layer again, and opens ``pangea.layer`` again: on CUDA on the
  thread autograd runs device work on, where no span of the step's thread
  is open around it;
- ``pangea.data.fetch``: ``data.pipeline.BatchLoader`` waiting for its
  next batch from the pool; ``pangea.data.to_device``:
  ``launch.train.train_batch``, the batch's move to the device;
- ``pangea.flash``, ``pangea.dispatch``, ``pangea.combine``: the kernel
  entries ``flash_attention``, ``dispatch`` and ``combine``;
- ``pangea.moe.route`` (attr ``layer``) and ``pangea.moe.experts``: a
  grouped-sigmoid expert layer's router (scores, selection, balance loss,
  slots, counters) and its routed experts (dispatch, products, combine),
  ``models.blocks.moe_apply_grouped``; ``pangea.step.balance``: the train
  step's update of the routers' selection biases, after ``.update``.

Counters are on always, apart from spans: ``count(name, value)`` adds a
device tensor to a float64 device tensor of that name, with no host sync;
``counters()`` reads them all (one sync) and ``reset_counters()`` drops
them. The port counts, in each expert layer with a share of its experts
(``models.blocks.count_share``), in each forward that is not a remat
recompute: ``moe.pairs_held``, ``moe.pairs_kept``, ``moe.load_ratio_sum``
and ``moe.load_ratio_n`` (the layers and forwards whose held experts got
pairs).

This module imports ``torch`` only, so that every part of the package can
import it.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

__all__ = ["Span", "count", "counters", "drain", "enable", "reset_counters",
           "span"]


class Span(NamedTuple):
    """One closed span. ``parent`` is the id of the span open around it on
    its thread when it opened (None: none was)."""
    name: str
    id: int
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    attrs: Dict[str, Any]


_on = False
_NOOP = contextlib.nullcontext()
# closed spans; a deque's append and popleft are atomic across threads
_closed: "collections.deque[Span]" = collections.deque()
_ids = itertools.count(1)
_local = threading.local()


def enable(on: bool) -> None:
    """Turn spans on or off for the whole process."""
    global _on
    _on = bool(on)


def span(name: str, **attrs):
    """A context manager around one span of the port's work (see the
    module's docstring); the shared no-op context while spans are off."""
    if not _on:
        return _NOOP
    return _Open(name, attrs)


def drain() -> List[Span]:
    """The spans closed since the last drain, in the order they closed;
    they are no longer kept."""
    return [_closed.popleft() for _ in range(len(_closed))]


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "start", "range")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        _closed.append(Span(self.name, self.id, self.parent,
                            threading.get_ident(), self.start, end,
                            self.attrs))
        return False


_counters: Dict[str, torch.Tensor] = {}


def count(name: str, value: torch.Tensor) -> None:
    """Add ``value`` (a 0-d tensor) to counter ``name``, on its device,
    with no host sync."""
    c = _counters.get(name)
    if c is None:
        _counters[name] = value.detach().to(torch.float64).clone()
    else:
        c.add_(value.detach())


def counters() -> Dict[str, float]:
    """Every counter's value (reading them syncs with their device)."""
    return {k: float(v) for k, v in _counters.items()}


def reset_counters() -> None:
    _counters.clear()
