"""A model's state that no gradient touches (DeepSeek-V3's router
selection biases and the loads that move them).

The train state carries it beside the params and the moments
(``optim.TrainState.model_state``, a dict of tensors), so that a
checkpoint saves and restores it with them. The train step opens
``step(tree)`` around its forward, backward and update; a model's forward
that reads the state finds it there (``current()``), and names the update
that the step makes of it after the optimizer's (``Step.after_update``).

This module imports ``torch`` only, so that every part of the package can
import it.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Iterator, Optional

import torch

__all__ = ["Step", "current", "step"]

Tree = Dict[str, torch.Tensor]


class Step:
    """One train step's model state: ``tree``, and the updates that the
    step makes of it after the optimizer's, each under a name (a forward
    run twice, as microbatches are, names its update once)."""

    def __init__(self, tree: Tree):
        self.tree = tree
        self._updates: Dict[str, Callable[[Tree], None]] = {}

    def after_update(self, name: str, fn: Callable[[Tree], None]) -> None:
        self._updates[name] = fn

    @property
    def updates(self) -> bool:
        return bool(self._updates)

    def update(self) -> None:
        for fn in self._updates.values():
            fn(self.tree)


_current: contextvars.ContextVar[Optional[Step]] = contextvars.ContextVar(
    "repro_torch_model_state", default=None)


@contextlib.contextmanager
def step(tree: Tree) -> Iterator[Step]:
    """The train step's model state ``tree``, for the forwards inside."""
    s = Step(tree)
    token = _current.set(s)
    try:
        yield s
    finally:
        _current.reset(token)


def current() -> Optional[Step]:
    """The open train step's model state, or None outside a step."""
    return _current.get()
