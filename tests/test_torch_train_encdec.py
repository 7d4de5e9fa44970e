"""Training the enc-dec family (smoke seamless-m4t-large-v2: 2 + 2 layers,
d 64, 4 heads of 16) on the CPU, against the JAX package.

- ``EncDecLM.loss`` and every param's gradient against
  ``jax.value_and_grad`` of the reference's on bridged params, the same
  tokens, labels and frames: fp32 at 3e-4, bf16 at 2e-2 against the
  reference run op by op (``jax.disable_jit``) with
  ``_bf16_leaf_close``'s rule; self-attention on ``attn_impl="kernel"``
  (``_FlashAttention`` over the kernel's plain version on CPU tensors) and
  on ``"xla"``. Per-layer rematerialisation gives the same gradients, and
  the kernel's forward runs twice a layer (the forward, its recompute).
- ``make_train_step`` against the reference's on the same batches and
  frames, 4 steps: the same losses at 1e-4 in fp32 (ROADMAP queue 3,
  quirk 12: ``run_training`` itself draws other frames than the
  reference's).
- ``run_training``: the loss falls over 15 steps; a run that crashes at a
  checkpoint and restarts continues bit for bit, the frames of a step the
  same after the restart.
"""
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model
from repro.optim import make_train_step as ref_train_step
from repro.optim.train_state import make_train_state as ref_train_state
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.train import (SimulatedFailure, frames_generator,
                                      run_training, train_batch)
from repro_torch.models.lm import tree_map
from repro_torch.models.model import build_model
from repro_torch.optim import make_train_state, make_train_step
from test_torch_train_recurrent import _bf16_leaf_close

torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
GRAD_TOL = {"float32": 3e-4, "bfloat16": 2e-2}
B, S, T = 2, 20, 12          # batch, source frames, decoder tokens


def _pair(dtype, remat="none", attn_impl="kernel"):
    jcfg = jax_smoke_config(ARCH).with_(compute_dtype=dtype)
    tcfg = smoke_config(ARCH).with_(compute_dtype=dtype, remat=remat)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, attn_impl=attn_impl, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, S, 64)).astype(np.float32)
    toks = rng.integers(0, 256, (n, T)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((n, 1), -100, np.int32)],
                            axis=1)
    return {"src_embeds": src, "tokens": toks, "labels": labels}


def _loss_and_grads(tm, tp, batch):
    params = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss = tm.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss.detach(), tree_map(lambda t: t.grad, params)


def _np_tree(tree):
    return _flatten(jax.tree.map(lambda t: np.asarray(
        t.float() if isinstance(t, torch.Tensor) else t, np.float32), tree))


@pytest.mark.parametrize("attn_impl", ["kernel", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_loss_and_grads_match_jax(dtype, attn_impl):
    jm, jp, tm, tp = _pair(dtype, attn_impl=attn_impl)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tol = GRAD_TOL[dtype]
    ctx = jax.disable_jit() if dtype == "bfloat16" else nullcontext()
    with ctx:
        jl, jg = jax.value_and_grad(jm.loss)(jp, jbatch)
    launches = flash_ops.flash_attention.launches
    tl, tg = _loss_and_grads(tm, tp, batch)
    assert flash_ops.flash_attention.launches == launches   # CPU: plain
    np.testing.assert_allclose(float(tl), float(jl), rtol=tol, atol=tol)
    ours, ref = _np_tree(tg), _np_tree(jg)
    assert sorted(ours) == sorted(ref)
    if dtype == "bfloat16":
        compiled = _np_tree(jax.jit(jax.grad(jm.loss))(jp, jbatch))
    for key in ref:
        assert ours[key].shape == ref[key].shape, key
        if dtype == "bfloat16":
            _bf16_leaf_close(ours[key], ref[key], compiled[key], tol, key)
        else:
            np.testing.assert_allclose(ours[key], ref[key], rtol=tol,
                                       atol=tol, err_msg=key)


def test_remat_runs_each_layer_twice_and_gives_the_same_grads(monkeypatch):
    """With ``remat="layer"`` every encoder and decoder layer is recomputed
    in the backward: the kernel's forward (with lse) runs twice a
    self-attention layer, non-causal in the encoder; the loss and every
    gradient are the plain run's. Cross-attention never takes it."""
    calls = []
    fwd = flash_ops._kernel_fwd

    def recorded(q, k, v, causal, *args):
        calls.append((causal, args[-1]))
        return fwd(q, k, v, causal, *args)

    monkeypatch.setattr(flash_ops, "_kernel_fwd", recorded)
    _, _, tm, tp = _pair("float32")
    _, _, tm_r, _ = _pair("float32", remat="layer")
    batch = _batch(1)
    l0, g0 = _loss_and_grads(tm, tp, batch)
    cfg = smoke_config(ARCH)
    Le, L = cfg.n_encoder_layers, cfg.n_layers
    assert calls == [(False, True)] * Le + [(True, True)] * L
    calls.clear()
    l1, g1 = _loss_and_grads(tm_r, tp, batch)
    assert sorted(calls) == [(False, True)] * 2 * Le + [(True, True)] * 2 * L
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-5)
    a, b = _np_tree(g0), _np_tree(g1)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def test_serving_forward_keeps_its_bits_under_grad():
    """``forward`` under grad (remat on) gives the no-grad logits bit for
    bit; without grad nothing is recorded."""
    _, _, tm, tp = _pair("bfloat16", remat="layer")
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()
             if k != "labels"}
    with torch.no_grad():
        plain, _ = tm.forward(tp, batch)
    assert plain.grad_fn is None
    params = dict(tp, enc_norm=tp["enc_norm"].detach().requires_grad_(True))
    train, _ = tm.forward(params, batch)
    assert train.grad_fn is not None
    assert torch.equal(train.detach(), plain)


def test_train_steps_follow_the_reference_on_the_same_frames():
    """``make_train_step`` over ``EncDecLM.loss`` and the reference's over
    its own, from the same params, on the same tokens and frames (drawn
    with numpy): the same loss and grad norm at every one of 4 steps, at
    1e-4 in fp32. Quirk 12: ``run_training``'s frames come from a torch
    generator, the reference's from ``jax.random``, which differ."""
    jm, jp, tm, tp = _pair("float32")
    ts, js = make_train_state(tp), ref_train_state(jp)
    t_step = make_train_step(tm.loss, lr=1e-3)
    j_step = jax.jit(ref_train_step(jm.loss, lr=1e-3))
    losses = []
    for step in range(4):
        batch = _batch(10 + step)
        ts, tmet = t_step(ts, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
        js, jmet = j_step(js, {k: jnp.asarray(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{key} at step {step}")
        losses.append(float(tmet["loss"]))
    assert losses[-1] < losses[0]
    # the frames run_training draws at a step are not the reference's
    cfg = smoke_config(ARCH)
    ours = train_batch(cfg, {k: v for k, v in _batch(0, 4).items()
                             if k != "src_embeds"}, ts.params, 0, 0,
                       torch.device("cpu"))["src_embeds"]
    ref = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0), 0),
                            ours.shape)
    assert ours.dtype == torch.float32 and ours.shape == (4, T, 64)
    assert not np.allclose(ours.numpy(), np.asarray(ref), atol=1e-2)


def test_frames_come_from_seed_and_step():
    """One (seed, step) pair, one draw: equal for the same pair, different
    across steps and seeds; standard normals in fp32."""
    cfg = smoke_config(ARCH)
    loader = {k: v for k, v in _batch(0, 8).items() if k != "src_embeds"}

    def frames(seed, step):
        return train_batch(cfg, loader, None, step, seed,
                           torch.device("cpu"))["src_embeds"]

    a = frames(3, 5)
    assert torch.equal(a, frames(3, 5))
    assert not torch.equal(a, frames(3, 6))
    assert not torch.equal(a, frames(4, 5))
    assert torch.equal(a, torch.randn(a.shape, generator=frames_generator(
        3, 5, torch.device("cpu"))))
    assert abs(float(a.mean())) < 0.05 and abs(float(a.std()) - 1) < 0.05


def test_encdec_train_loss_decreases():
    res = run_training(smoke_config(ARCH), steps=15, batch_size=8,
                       seq_len=32, num_sequences=32, log_every=100,
                       device="cpu")
    assert res.steps == 15
    assert all(np.isfinite(l) for l in res.losses + res.grad_norms)
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])


def test_restart_continues_bit_for_bit_with_the_same_frames(tmp_path):
    """A run that checkpoints at step 3 and crashes there, then a run that
    restores and goes on to step 6, against one uninterrupted run: the
    same losses, bit for bit, at steps 4-6 and the same final state. One
    batch of tokens serves every step, so only the frames, drawn from
    (seed, step), change from step to step."""
    cfg = smoke_config(ARCH)
    kw = dict(steps=6, batch_size=4, seq_len=16, num_sequences=4,
              log_every=100, device="cpu")
    whole = run_training(cfg, **kw)
    with pytest.raises(SimulatedFailure):
        run_training(cfg, ckpt_dir=str(tmp_path), ckpt_every=3,
                     fail_at_step=3, **kw)
    rest = run_training(cfg, ckpt_dir=str(tmp_path), ckpt_every=3, **kw)
    assert rest.restored_from == 3 and rest.steps == 6
    assert rest.losses == whole.losses[3:]
    assert len(set(whole.losses)) == 6
    a, b = _flatten(whole.state), _flatten(rest.state)
    assert sorted(a) == sorted(b)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
