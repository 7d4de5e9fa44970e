"""The port's training path on the CPU, against the JAX package's.

- Attention's gradient: ``_FlashAttention`` (``impl="xla"``, and
  ``impl="kernel"``, which takes the plain version with its lse on CPU
  tensors) against ``jax.grad`` of the reference's chunked custom VJP, at
  the reference's 3e-4 in fp32.
- The whole LM: smoke qwen3-0.6b's and smoke olmo-1b's ``loss`` and every
  param's gradient against ``jax.value_and_grad`` of the reference's on
  bridged params: fp32 at 3e-4, bf16 at 2e-2 against the reference run op
  by op (``jax.disable_jit``; the compiled bf16 reference is outside 2e-2 of
  itself, ``tests/test_torch_models.py``). With per-layer
  rematerialisation the gradients are the same.
- ``run_training``: the mirrors of ``tests/test_system.py``'s loss-decreases
  and crash-restart tests, and checkpoints that either package's
  ``run_training`` writes and the other's restores with equal leaves; its
  ``tokens_per_s`` over the steps after the first, the final save left out.
"""
import time
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention.ops import (_attn_bwd_core,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch.train import (SimulatedFailure, _tokens_per_s,
                                      run_training)
from repro_torch.models.lm import tree_map
from repro_torch.models.model import build_model

torch.set_num_threads(2)

GRAD_TOL = dict(rtol=3e-4, atol=3e-4)

# B, H, KH, Tq, Tk, D, causal, window, q_offset, block_k
GRAD_CASES = [
    (1, 4, 2, 48, 48, 16, True, None, 0, 16),       # the reference's case
    (2, 4, 1, 40, 72, 16, True, None, 32, 16),      # GQA 4, q_offset, decode-like
    (1, 2, 2, 96, 96, 32, True, 32, 0, 32),         # sliding window
    (1, 4, 4, 33, 50, 8, False, None, 0, 16),       # Tk not a block multiple
    (1, 8, 2, 20, 70, 16, True, 16, 50, 32),        # window + q_offset + GQA
]


def _inputs(case, seed=0):
    B, H, KH, Tq, Tk, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, Tq, D), (B, KH, Tk, D), (B, KH, Tk, D),
                      (B, H, Tq, D))]


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_flash_grads_match_jax_custom_vjp(case, impl):
    *_, causal, window, q_offset, bk = case
    q, k, v, w = _inputs(case)

    def j_loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, window=window,
                      q_offset=q_offset, impl="xla", block_k=bk)
        return (o * w).sum()

    jg = jax.grad(j_loss, (0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    before = flash_attention.launches
    out = flash_attention(tq, tk, tv, causal=causal, window=window,
                          q_offset=q_offset, impl=impl, block_k=bk)
    (out * torch.from_numpy(w)).sum().backward()
    assert flash_attention.launches == before      # CPU: the plain version
    for t, j, name in zip((tq, tk, tv), jg, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   err_msg=f"d{name}", **GRAD_TOL)


def test_flash_lse_of_the_plain_version():
    """The plain version's lse is the log-sum-exp of each row's live scaled
    scores, +inf for a row with no live key (so the backward's exp(s - lse)
    is 0 there, as the row's output is); the backward from it gives the
    gradients of the naive oracle's autograd."""
    q, k, v, w = _inputs((1, 4, 2, 8, 8, 16), seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = attention_ref(tq, tk, tv, causal=True, q_offset=-3,
                             return_lse=True)
    assert lse.shape == (1, 4, 8) and lse.dtype == torch.float32
    assert torch.isinf(lse[..., :3]).all() and (lse[..., :3] > 0).all()
    assert torch.equal(out, attention_ref(tq, tk, tv, causal=True,
                                          q_offset=-3))
    s = torch.einsum("bkgqd,bktd->bkgqt", tq.reshape(1, 2, 2, 8, 16),
                     tk) * 16 ** -0.5
    live = torch.arange(8)[None, :] <= torch.arange(8)[:, None] - 3
    want = torch.logsumexp(s.masked_fill(~live, float("-inf")), -1)
    torch.testing.assert_close(lse[..., 3:], want.reshape(1, 4, 8)[..., 3:],
                               rtol=1e-6, atol=1e-6)
    g = [a.clone().requires_grad_(True) for a in (tq, tk, tv)]
    (attention_ref(*g, causal=True, q_offset=-3)
     * torch.from_numpy(w)).sum().backward()
    ours = _attn_bwd_core(tq, tk, tv, out, torch.from_numpy(w), lse, True,
                          None, 16 ** -0.5, -3, 4)
    for a, b in zip(ours, g):
        torch.testing.assert_close(a, b.grad, **GRAD_TOL)


def _pair(arch, dtype, remat="none", attn_impl="kernel"):
    jcfg = jax_smoke_config(arch).with_(compute_dtype=dtype)
    tcfg = smoke_config(arch).with_(compute_dtype=dtype, remat=remat)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, attn_impl=attn_impl, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (2, 12)).astype(
        np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100, np.int32)],
                            axis=1)
    return toks, labels


def _loss_and_grads(tm, tp, toks, labels):
    params = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss = tm.loss(params, {"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels)})
    loss.backward()
    return loss, tree_map(lambda t: t.grad, params)


def _flat(tree):
    return _flatten(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmo-1b"])
def test_lm_loss_and_grads_match_jax(arch, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    toks, labels = _batch(256)
    tol = 3e-4 if dtype == "float32" else 2e-2
    ctx = jax.disable_jit() if dtype == "bfloat16" else nullcontext()
    with ctx:
        jl, jg = jax.value_and_grad(jm.loss)(
            jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tl, tg = _loss_and_grads(tm, tp, toks, labels)
    np.testing.assert_allclose(float(tl), float(jl), rtol=tol, atol=tol)
    ours, ref = _flatten(jax.tree.map(
        lambda t: t.float().numpy(), tg)), _flat(jg)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key].shape == ref[key].shape, key
        np.testing.assert_allclose(ours[key], ref[key], rtol=tol, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("attn_impl", ["kernel", "xla", "naive"])
def test_remat_and_attention_impls_give_the_same_grads(attn_impl):
    """Per-layer rematerialisation (``remat="layer"``) recomputes each
    layer's forward in the backward and gives the plain run's gradients;
    so do the three attention impls."""
    _, _, tm, tp = _pair("qwen3-0.6b", "float32")
    _, _, tm_r, _ = _pair("qwen3-0.6b", "float32", remat="layer",
                          attn_impl=attn_impl)
    toks, labels = _batch(256, seed=1)
    l0, g0 = _loss_and_grads(tm, tp, toks, labels)
    l1, g1 = _loss_and_grads(tm_r, tp, toks, labels)
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-5)
    a, b = _flatten(jax.tree.map(lambda t: t.numpy(), g0)), \
        _flatten(jax.tree.map(lambda t: t.numpy(), g1))
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)


def test_serving_forward_is_untouched_by_the_training_path():
    """Without grad the forward slices layers as before and calls no
    autograd Function; with grad it gives the same logits."""
    _, _, tm, tp = _pair("qwen3-0.6b", "bfloat16", remat="layer")
    toks, _ = _batch(256, seed=2)
    with torch.no_grad():
        plain, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert plain.grad_fn is None
    params = {k: v for k, v in tp.items()}
    params["unembed"] = tp["unembed"].detach().requires_grad_(True)
    train, _ = tm.forward(params, {"tokens": torch.from_numpy(toks)})
    assert train.grad_fn is not None
    assert torch.equal(train.detach(), plain)


# -- tests/test_system.py on the port ---------------------------------------------
def test_train_loss_decreases():
    cfg = smoke_config("olmo-1b")
    res = run_training(cfg, steps=15, batch_size=8, seq_len=32,
                       num_sequences=32, log_every=100, device="cpu")
    assert res.steps == 15
    assert all(np.isfinite(l) for l in res.losses)
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])


@pytest.mark.parametrize("starts,ends,seconds,want", [
    ([0.0, 1.0, 2.5], [0.9, 2.0, 3.5], [0.8, 0.9, 0.9], 2 * 64 / 2.5),
    ([0.0], [0.9], [0.8], 64 / 0.8),
    ([], [], [], 0.0)], ids=["steps", "one_step", "no_step"])
def test_tokens_per_s_reads_the_steps_after_the_first(starts, ends, seconds,
                                                      want):
    assert _tokens_per_s(64, starts, ends, seconds) == pytest.approx(want)


def test_tokens_per_s_leaves_out_the_final_checkpoint(tmp_path,
                                                      monkeypatch):
    save = CheckpointManager.save

    def slow_final(self, step, state, async_=False):
        if not async_:
            time.sleep(1.0)
        return save(self, step, state, async_=async_)
    monkeypatch.setattr(CheckpointManager, "save", slow_final)
    res = run_training(smoke_config("qwen3-0.6b"), steps=3, batch_size=2,
                       seq_len=8, ckpt_dir=str(tmp_path), ckpt_every=100,
                       log_every=100, device="cpu")
    window = 2 * 2 * 8 / res.tokens_per_s
    assert sum(res.step_seconds[1:]) <= window < 1.0


def test_train_checkpoint_restart(tmp_path):
    cfg = smoke_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="simulated failure") as exc:
        run_training(cfg, steps=12, ckpt_dir=str(tmp_path), ckpt_every=4,
                     fail_at_step=8, log_every=100, device="cpu")
    assert isinstance(exc.value, SimulatedFailure)
    res = run_training(cfg, steps=12, ckpt_dir=str(tmp_path), ckpt_every=4,
                       log_every=100, device="cpu")
    assert res.restored_from == 8
    assert res.steps == 12
    # the step-8 checkpoint holds the crashed run's state, bit for bit
    saved = CheckpointManager(str(tmp_path), layouts=("row", "col"),
                              num_shards=4).restore(exc.value.state, step=8)
    a = _flatten(exc.value.state)
    b = _flatten(saved)
    assert sorted(a) == sorted(b)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmo-1b", "qwen2-vl-72b"])
def test_run_training_from_bridged_params_follows_the_reference(arch):
    """The reference's ``run_training`` and the port's, started from the
    same params (the reference's init, bridged) on the same tokens (both
    pools' synthetic dataset from one seed), in fp32: the same loss at
    every step, at 1e-4. qwen2-vl-72b's batches are the embeddings gathered
    from each step's params at the broadcast M-RoPE positions."""
    from repro.launch.train import run_training as ref_run_training
    jcfg = jax_smoke_config(arch).with_(compute_dtype="float32")
    kw = dict(steps=4, batch_size=4, seq_len=16, log_every=100)
    ref = ref_run_training(jcfg, **kw)
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    ours = run_training(smoke_config(arch).with_(compute_dtype="float32"),
                        params=params_from_numpy(jax.tree.map(np.asarray, jp),
                                                 device="cpu"),
                        device="cpu", **kw)
    assert ours.steps == ref.steps == 4
    np.testing.assert_allclose(ours.losses, ref.losses, rtol=1e-4, atol=1e-4)


def test_checkpoints_cross_load_between_the_packages(tmp_path):
    """A checkpoint that the port's ``run_training`` writes restores in the
    reference's ``run_training`` (which resumes from it and saves it again),
    and that checkpoint restores in the port's, with equal leaves both
    ways."""
    from repro.launch.train import run_training as ref_run_training
    cfg = smoke_config("qwen3-0.6b")
    ours = run_training(cfg, steps=3, batch_size=4, seq_len=16,
                        ckpt_dir=str(tmp_path / "a"), ckpt_every=100,
                        log_every=100, device="cpu")
    res = ref_run_training(jax_smoke_config("qwen3-0.6b"), steps=3,
                           batch_size=4, seq_len=16,
                           ckpt_dir=str(tmp_path / "a"), log_every=100)
    assert res.restored_from == 3 and res.steps == 3 and res.losses == []
    back = run_training(cfg, steps=3, batch_size=4, seq_len=16,
                        ckpt_dir=str(tmp_path / "a"), log_every=100,
                        device="cpu")
    assert back.restored_from == 3
    a, b = _flatten(ours.state), _flatten(back.state)
    assert sorted(a) == sorted(b) and "opt/step" in a
    assert all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
               for k in a)
    # and the reference's own training run restores in the port
    ref_run_training(jax_smoke_config("qwen3-0.6b"), steps=2, batch_size=4,
                     seq_len=16, ckpt_dir=str(tmp_path / "b"),
                     log_every=100)
    from repro.checkpoint import CheckpointManager as RefManager
    port = run_training(cfg, steps=2, batch_size=4, seq_len=16,
                        ckpt_dir=str(tmp_path / "b"), log_every=100,
                        device="cpu")
    assert port.restored_from == 2 and port.losses == []
    mgr = RefManager(str(tmp_path / "b"), layouts=("row", "col"),
                     num_shards=4)
    jstate = jax.tree.map(np.asarray, mgr.restore(
        jax.tree.map(np.asarray, _ref_state_template(cfg)), step=2))
    a, b = _flatten(port.state), _flatten(jstate)
    assert sorted(a) == sorted(b)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


def _ref_state_template(cfg):
    from repro.optim.train_state import make_train_state
    jm = jax_build_model(jax_smoke_config(cfg.name))
    return make_train_state(jm.init(jax.random.PRNGKey(0)))
