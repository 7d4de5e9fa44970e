"""Train state and the train-step factory (gradient accumulation over
microbatches), as the JAX package's ``optim/train_state.py``.

``TrainState`` and ``AdamWState`` keep the reference's NamedTuple field
names, so the checkpoint manager's flattened keys (``params/...``,
``opt/step``, ``opt/m/...``, ``opt/v/...``) are the same in both packages
and a checkpoint of either restores in the other. ``TrainState`` adds
``model_state``, the model's state that no gradient touches
(``repro_torch.model_state``; the port's own architectures'), saved under
``model_state/...``; it is empty for every architecture both packages
have, which then write the same keys.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from .. import model_state as _model_state
from .. import trace
from .adamw import AdamWState, _leaves, _unflatten_like, adamw_apply, \
    adamw_init

Pytree = Any


class TrainState(NamedTuple):
    params: Pytree
    opt: AdamWState
    model_state: Optional[Dict[str, torch.Tensor]] = None


def make_train_state(params: Pytree, opt_dtype: str = "float32",
                     model_state: Optional[Dict[str, torch.Tensor]] = None
                     ) -> TrainState:
    """``model_state``: the model's (its ``init_state()``), which a
    checkpoint's restore needs in its template; without it the first step
    starts it."""
    return TrainState(params=params, opt=adamw_init(params, opt_dtype),
                      model_state=model_state)


def leaf_grads(loss: torch.Tensor, leaves: list) -> list:
    """d loss / d leaf for each leaf. A leaf the loss does not use (the
    VLM's ``embed`` when the batch brings ``embeds``) gets an fp32 zero
    gradient of its shape, as ``jax.grad`` gives it zeros: AdamW then still
    decays it. The zeros are one scalar broadcast, so that a 1.25 B-element
    leaf costs no memory for them (a DTensor leaf's are its own shards)."""
    with trace.span("pangea.step.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [g if g is not None else torch.zeros_like(p, dtype=torch.float32)
            if isinstance(p, DTensor) else torch.zeros(
                (), dtype=torch.float32, device=p.device).expand(p.shape)
            for g, p in zip(grads, leaves)]


def _label_count(batch) -> Optional[int]:
    """The batch's token count for ``pangea.step``: its labels' (None
    where it has none)."""
    labels = batch.get("labels") if isinstance(batch, dict) else None
    return None if labels is None else labels.numel()


def make_train_step(loss_fn: Callable[[Pytree, Any], torch.Tensor], *,
                    lr: float = 3e-4, weight_decay: float = 0.1,
                    microbatches: int = 1) -> Callable:
    """Build train_step(state, batch) -> (state, metrics).

    ``microbatches > 1`` accumulates fp32 gradients over equal slices of
    the batch's leading dim in a Python loop (the reference's ``lax.scan``)
    and divides by their count; the loss is the mean of the slices' losses.
    Metrics: ``loss``, ``grad_norm`` (of the averaged gradients, in fp32)
    and ``step``, as 0-d tensors. The state passed in is donated, as the
    reference's ``run_training`` jits the step with ``donate_argnums=(0,)``:
    its params and moments are updated in place (``adamw_apply``) and it
    may not be read as the old state afterwards. Each call is the program
    span ``pangea.step`` around ``pangea.step.forward``, ``.backward``,
    ``.grad_norm`` and ``.update`` (``repro_torch.trace``).

    The state's ``model_state`` (a new dict where it is None) is the
    step's (``model_state.step``) for the forwards inside: a model that
    has state reads it there, starts it where it is missing, and names its
    update, which the step makes after the optimizer's, in ``.balance``
    (DeepSeek-V3's routers' selection biases, ``LM.update_router_bias``).
    The state returned carries it.
    """

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
        with trace.span("pangea.step.forward"):
            loss = loss_fn(_unflatten_like(params, leaves), batch)
        return loss.detach(), leaf_grads(loss, leaves)

    def train_step(state: TrainState, batch) -> tuple:
        tree = {} if state.model_state is None else state.model_state
        with trace.span("pangea.step", tokens=_label_count(batch)), \
                _model_state.step(tree) as step_state:
            params = state.params
            if microbatches == 1:
                loss, grads = grads_of(params, batch)
            else:
                n = next(iter(batch.values())).shape[0] // microbatches
                gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                        for p in _leaves(params)]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=gsum[0].device)
                for i in range(microbatches):
                    mb = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
                    l_i, g = grads_of(params, mb)
                    gsum = [a + b.float() for a, b in zip(gsum, g)]
                    loss = loss + l_i.float()
                grads = [g / microbatches for g in gsum]
                loss = loss / microbatches
            grads = list(grads)
            with trace.span("pangea.step.grad_norm"):
                gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                       for g in grads))
            # the update empties the list as it goes (``adamw_apply``)
            with trace.span("pangea.step.update"):
                new_params, new_opt = adamw_apply(
                    params, grads, state.opt, lr=lr,
                    weight_decay=weight_decay)
            if step_state.updates:
                with trace.span("pangea.step.balance"):
                    step_state.update()
            metrics = {"loss": loss, "grad_norm": gnorm, "step": new_opt.step}
            return TrainState(new_params, new_opt,
                              tree or state.model_state), metrics

    return train_step
