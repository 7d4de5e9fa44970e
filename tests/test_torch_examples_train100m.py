"""``examples/torch_train_100m.py`` against ``examples/train_100m.py``, both
loaded by path.

- ``config_100m()`` equal to the reference's field by field, and
  ``count_params`` of it equal to the reference's count (114.3 M).
- At a smoke size (the config cut to 2 layers of width 64),
  ``--simulate-failure`` crashes at step 20 of 40, right after the step-20
  checkpoint, restarts from it, and continues bit for bit like an
  uninterrupted port run: one that trains 20 steps and goes on from its
  state in the same process. Both draw steps 21-40 from the start of the
  dataset, as the reference's loop does after a restart.
- At that smoke size, from the reference's init bridged into the port, the
  port example's losses after the restart follow the JAX example's own
  crash and restart at 1e-4 (fp32 compute in both).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_examples import load, run_jax, run_port
from repro.models.model import build_model as jax_build_model
from repro.models.model import count_params as jax_count_params
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.core import BufferPool
from repro_torch.data.pipeline import BatchLoader, synthetic_token_dataset
from repro_torch.launch.train import (SimulatedFailure, run_training,
                                      train_batch)
from repro_torch.models.model import build_model, count_params
from repro_torch.optim import make_train_step

torch.set_num_threads(2)

SMOKE = dict(n_layers=2, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
             d_ff=128, vocab=256)
STEPS, BATCH, SEQ = 40, 2, 16


def _same_bits(a, b) -> bool:
    fa, fb = _flatten(a), _flatten(b)
    return sorted(fa) == sorted(fb) and all(
        fa[k].dtype == fb[k].dtype and fa[k].tobytes() == fb[k].tobytes()
        for k in fa)


def _go_on(cfg, state, steps):
    """Train ``state`` on to ``steps`` in this process, from the first
    batch of the run's dataset; returns (state, losses)."""
    step_fn = make_train_step(build_model(cfg, device="cpu").loss, lr=3e-4)
    ds = synthetic_token_dataset(BufferPool(256 << 20), "train_tokens",
                                 vocab=cfg.vocab, num_sequences=BATCH * steps,
                                 seq_len=SEQ, seed=0)
    losses = []
    for batch in BatchLoader(ds, batch_size=BATCH):
        done = int(state.opt.step)
        if done >= steps:
            break
        tb = train_batch(cfg, batch, state.params, done, 0,
                         torch.device("cpu"))
        state, metrics = step_fn(state, tb)
        losses.append(float(metrics["loss"]))
    return state, losses


def test_config_equals_the_reference():
    jx, pt = load("train_100m"), load("torch_train_100m")
    want, got = jx.config_100m(), pt.config_100m()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.n_layers, got.d_model, got.head_dim, got.d_ff, got.vocab,
            got.remat, got.compute_dtype) == (14, 512, 64, 3072, 32768,
                                              "none", "float32")


def test_count_params_equals_the_reference():
    jx, pt = load("train_100m"), load("torch_train_100m")
    n = count_params(pt.config_100m())
    assert n == jax_count_params(jx.config_100m()) == 114_294_784


@pytest.fixture(scope="module")
def restart(tmp_path_factory):
    pt = load("torch_train_100m")
    cfg = pt.config_100m().with_(**SMOKE)
    pt.config_100m = lambda: cfg
    crashed = {}
    train = pt.run_training

    def recording(*args, **kwargs):
        try:
            return train(*args, **kwargs)
        except SimulatedFailure as e:
            crashed["state"] = e.state
            raise

    pt.run_training = recording
    ckdir = tmp_path_factory.mktemp("train100m")
    res, lines = run_port(pt, "--steps", str(STEPS), "--batch-size",
                          str(BATCH), "--seq-len", str(SEQ),
                          "--simulate-failure", "--ckpt-dir", str(ckdir))
    first = run_training(cfg, steps=STEPS // 2, batch_size=BATCH, seq_len=SEQ,
                         num_sequences=BATCH * STEPS, log_every=100,
                         device="cpu")
    return dict(cfg=cfg, res=res, lines=lines, ckdir=str(ckdir),
                crashed=crashed["state"], first=first)


def test_crash_at_half_and_restart_from_its_checkpoint(restart):
    res, lines = restart["res"], restart["lines"]
    assert res["crashed_at"] == res["restored_from"] == STEPS // 2
    assert res["steps"] == STEPS and len(res["losses"]) == STEPS // 2
    assert res["params"] == count_params(restart["cfg"])
    assert (f"!! simulated failure at step {STEPS // 2} — restarting from "
            f"checkpoint") in lines
    assert f"(restored from step {STEPS // 2})" in lines
    # the crash came at the state an uninterrupted run has at that step
    assert _same_bits(restart["crashed"], restart["first"].state)


def test_restart_continues_like_an_uninterrupted_run(restart):
    state, losses = _go_on(restart["cfg"], restart["first"].state, STEPS)
    assert losses == restart["res"]["losses"]
    saved = CheckpointManager(restart["ckdir"], layouts=("row", "col"),
                              num_shards=4)
    assert saved.latest_step() == STEPS
    assert _same_bits(saved.restore(state, step=STEPS), state)


def _recording(mod, runs, **extra):
    """Wrap ``mod.run_training`` so that each call's result (or its
    simulated failure) is kept in ``runs``, with ``extra()``'s keywords."""
    train = mod.run_training

    def run(*args, **kwargs):
        kwargs.update({k: f() for k, f in extra.items()})
        try:
            res = train(*args, **kwargs)
        except RuntimeError as e:
            runs.append(e)
            raise
        runs.append(res)
        return res

    mod.run_training = run


def test_restart_follows_the_jax_example_from_bridged_params(tmp_path):
    jx, pt = load("train_100m"), load("torch_train_100m")
    jcfg = jx.config_100m().with_(**SMOKE)
    cfg = pt.config_100m().with_(**SMOKE)
    jx.config_100m, pt.config_100m = (lambda: jcfg), (lambda: cfg)
    args = ("--steps", str(STEPS), "--batch-size", str(BATCH), "--seq-len",
            str(SEQ), "--simulate-failure")
    jruns, pruns = [], []
    _recording(jx, jruns)
    lines = run_jax(jx, *args, "--ckpt-dir", str(tmp_path / "jax"))
    assert (f"!! simulated failure at step {STEPS // 2} — restarting from "
            f"checkpoint") in lines
    # the reference's init (run_training's PRNGKey(0)), bridged afresh for
    # each call: the port's train step updates its params in place
    jp = jax.tree.map(np.asarray,
                      jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    _recording(pt, pruns, params=lambda: params_from_numpy(jp, device="cpu"))
    res, _ = run_port(pt, *args, "--ckpt-dir", str(tmp_path / "port"))
    assert [type(r).__name__ for r in pruns] == ["SimulatedFailure",
                                                 "TrainLoopResult"]
    assert isinstance(jruns[0], RuntimeError) and len(jruns) == 2
    ref = jruns[1]
    assert ref.restored_from == res["restored_from"] == STEPS // 2
    assert ref.steps == res["steps"] == STEPS
    assert len(ref.losses) == len(res["losses"]) == STEPS // 2
    np.testing.assert_allclose(res["losses"], ref.losses, rtol=1e-4,
                               atol=1e-4)
