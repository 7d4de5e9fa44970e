"""The training cells on the CPU at a small size: the plain reference
against the port, a run and its check, the control, and the faults a
training cell can have planted in the timed path."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import calibrate, harness, smoke, weights
from perfbench.runners import port_config

WORKLOAD = "dsv2l4.train.s4k"
SEED = 2 ** 31 + 91


def test_reference_loss_and_gradients_follow_the_port():
    """At fp32 the reference's loss (cross entropy and the balance loss,
    experts dropping pairs) and gradients are the port's."""
    cell = smoke.small_cell(WORKLOAD, capacity_factor=0.5)
    cell.conf["program"]["set"].update(compute_dtype="float32",
                                      capacity_factor=0.5)
    from repro_torch.models.model import build_model
    model = build_model(port_config(cell.conf), device="cpu")
    ref = cell.reference
    leaves = ref.leaves(cell.conf)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (2, 24)))
    labels = torch.cat([toks[:, 1:], torch.full((2, 1), -100)], 1)
    out = []
    for fn in (lambda p: model.loss(p, {"tokens": toks, "labels": labels}),
               lambda p: ref.loss(p, cell.conf, toks, ref.Numerics("fp32"))):
        p = weights.make(leaves, 3, torch.float32, "cpu")
        ps = [weights.get(p, leaf[0]).requires_grad_(True) for leaf in leaves]
        loss = fn(p)
        out.append((loss.detach(), torch.autograd.grad(loss, ps)))
    (lp, gp), (lr, gr) = out
    torch.testing.assert_close(lp, lr, rtol=1e-5, atol=1e-5)
    for a, b in zip(gp, gr):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


def run_small(cell, seconds=0.3):
    return harness.execute(cell, SEED, seconds, trace=False, device="cpu")


def test_a_run_is_correct():
    cell = smoke.small_cell(WORKLOAD)
    result = run_small(cell)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_tok_s", "setup_s"}
    assert set(result["check"]) == set(cell.limits)


def test_the_control_is_not_correct():
    """The reference in float8, put in the port's place, fails the cell's
    own limit on the distance of first gradients at this size too, on
    every seed, where the port passes it."""
    cell = smoke.small_cell(WORKLOAD)
    limit = cell.limits["grad_dist"]
    for seed in (1, 2, 3):
        r = calibrate.train_readings(cell, seed, True, False, "cpu")
        assert r["grad_dist"] < limit < r["control.grad_dist"], r


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from repro_torch.optim import train_state

    def unchanged(params, grads, state, **kw):
        return params, train_state.AdamWState(step=state.step + 1, m=state.m,
                                              v=state.v)
    monkeypatch.setattr(train_state, "adamw_apply", unchanged)
    result = run_small(smoke.small_cell(WORKLOAD))
    assert not result["correct"]
    assert result["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_fails(monkeypatch):
    from repro_torch.models.lm import LM
    loss = LM.loss

    def half(self, params, batch):
        n = batch["tokens"].shape[0] // 2
        return loss(self, params, {k: v[:n] for k, v in batch.items()})
    monkeypatch.setattr(LM, "loss", half)
    result = run_small(smoke.small_cell(WORKLOAD))
    assert not result["correct"], result["check"]
