"""Training the VLM family (smoke qwen2-vl-72b: 2 layers, d 64, 4 heads
over 2 of 16, M-RoPE) on the CPU, against the JAX package.

- ``LM.loss`` from ``embeds`` at image-grid [B, 3, T] positions (t, h and w
  apart) and every param's gradient against ``jax.value_and_grad`` of the
  reference's on bridged params: fp32 at 3e-4, bf16 at 2e-2 against the
  reference run op by op with ``_bf16_leaf_close``'s rule, on
  ``attn_impl="kernel"`` (``_FlashAttention`` over the kernel's plain
  version on CPU tensors) and ``"xla"``; ``apply_mrope``'s gradient.
- ``embed`` takes no part in that loss: its gradient is an fp32 zero (the
  train step's ``leaf_grads``), and one step decays it to the reference's
  bits, with fp32 and with bf16 moments.
- ``run_training``'s batch (the embeddings gathered from the state, the
  broadcast positions) and its loss against the reference's is in
  tests/test_torch_train.py; here the loss falls over 15 steps.
"""
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import smoke_config as jax_smoke_config
from repro.models.common import apply_mrope as jax_apply_mrope
from repro.models.model import build_model as jax_build_model
from repro.optim import make_train_step as ref_train_step
from repro.optim.train_state import make_train_state as ref_train_state
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.train import run_training, train_batch
from repro_torch.models.common import apply_mrope
from repro_torch.models.lm import tree_map
from repro_torch.models.model import build_model
from repro_torch.optim import make_train_state, make_train_step
from repro_torch.optim.adamw import _leaves
from repro_torch.optim.train_state import leaf_grads
from test_torch_train_recurrent import _bf16_leaf_close

torch.set_num_threads(2)

ARCH = "qwen2-vl-72b"
GRAD_TOL = {"float32": 3e-4, "bfloat16": 2e-2}
B, T = 2, 24


def grid_positions(n_text, grid, n_tail):
    """[B, 3, T] int32 M-RoPE positions of one image a row: n_text text
    tokens, a gh x gw patch grid (t fixed, h the row, w the column), then
    text from the grid's largest coordinate + 1."""
    gh, gw = grid
    text = np.arange(n_text)[None].repeat(3, 0)
    rows, cols = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    patches = np.stack([np.full(gh * gw, n_text), n_text + rows.ravel(),
                        n_text + cols.ravel()])
    start = n_text + max(gh, gw)
    tail = np.arange(start, start + n_tail)[None].repeat(3, 0)
    pos = np.concatenate([text, patches, tail], axis=1)
    return np.ascontiguousarray(
        np.broadcast_to(pos, (B, 3, pos.shape[1]))).astype(np.int32)


def _pair(dtype, remat="none", attn_impl="kernel", **over):
    jcfg = jax_smoke_config(ARCH).with_(compute_dtype=dtype, **over)
    tcfg = smoke_config(ARCH).with_(compute_dtype=dtype, remat=remat, **over)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, attn_impl=attn_impl, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    pos = grid_positions(6, (3, 4), T - 6 - 12)
    labels = rng.integers(0, 256, (B, T)).astype(np.int32)
    labels[:, -1] = -100
    return {"embeds": rng.normal(size=(B, T, 64)).astype(np.float32),
            "positions": pos, "labels": labels}


def _loss_and_grads(tm, tp, batch):
    leaves = [t.detach().requires_grad_(True) for t in _leaves(tp)]
    it = iter(leaves)
    loss = tm.loss(tree_map(lambda _: next(it), tp),
                   {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = iter(leaf_grads(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), tp)


def _np_tree(tree):
    return _flatten(jax.tree.map(lambda t: np.asarray(
        t.float() if isinstance(t, torch.Tensor) else t, np.float32), tree))


def test_grid_positions_keep_t_h_and_w_apart():
    pos = grid_positions(6, (3, 4), T - 18)
    assert pos.shape == (B, 3, T)
    assert (pos[:, 0] != pos[:, 1]).any() and (pos[:, 1] != pos[:, 2]).any()


@pytest.mark.parametrize("attn_impl", ["kernel", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_loss_and_grads_match_jax(dtype, attn_impl):
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
    assert tg["embed"].dtype == torch.float32
    assert not ours["embed"].any() and not ref["embed"].any()
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
    """``remat="layer"``: the kernel's forward (causal, with lse) runs
    twice a layer, and the loss and every gradient are the plain run's."""
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
    calls.clear()
    l1, g1 = _loss_and_grads(tm_r, tp, batch)
    assert calls == [(True, True)] * 2 * smoke_config(ARCH).n_layers
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-5)
    a, b = _np_tree(g0), _np_tree(g1)
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_grads_match_jax(dtype):
    """d x of sum(apply_mrope(x, positions) w) at positions whose t, h and w
    differ, against ``jax.grad`` of the reference's."""
    rng = np.random.default_rng(4)
    pos = grid_positions(6, (3, 4), T - 18)
    x = rng.normal(size=(B, T, 4, 16)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx = jnp.asarray(x, jd)
    jg = jax.grad(lambda a: (jax_apply_mrope(a, jnp.asarray(pos)).astype(
        jnp.float32) * w).sum())(jx)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(td).requires_grad_(True)
    (apply_mrope(tx, torch.from_numpy(pos)).float()
     * torch.from_numpy(w)).sum().backward()
    assert tx.grad.dtype == td
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(jg, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_the_unused_embed_decays_to_the_reference_bits(moments):
    """One train step from ``embeds``: the embed leaf, which the loss does
    not use, gets a zero gradient and is decayed (rank 2) to the bits of
    the reference's step, its moments zero; the grad norms agree. The
    reference's step runs as ``make_train_step`` returns it, op by op:
    under ``jax.jit`` XLA contracts p - lr (wd p) into one FMA, which moves
    the last bit of some elements."""
    jm, jp, tm, tp = _pair("float32", opt_state_dtype=moments)
    batch = _batch(2)
    ts = make_train_state(tp, moments)
    js = ref_train_state(jp, moments)
    ts, tmet = make_train_step(tm.loss)(ts, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    js, jmet = ref_train_step(jm.loss)(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    ours = ts.params["embed"].numpy()
    assert ours.tobytes() == np.asarray(js.params["embed"]).tobytes()
    assert not np.array_equal(ours, jp["embed"])          # decayed
    for tree in (ts.opt.m, ts.opt.v):
        assert tree["embed"].dtype == getattr(torch, moments)
        assert not tree["embed"].any()
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)


def test_run_training_batch_gathers_the_embeddings():
    """The VLM's batch: the embeddings of the tokens gathered from the fp32
    master params (a new tensor, not a view: the step updates the params
    in place), the tokens dropped, positions arange(T) on all three."""
    cfg = smoke_config(ARCH)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, 256, (B, T)).astype(np.int32)
    tb = train_batch(cfg, {"tokens": toks, "labels": toks}, params, 0, 0,
                     torch.device("cpu"))
    assert sorted(tb) == ["embeds", "labels", "positions"]
    assert tb["positions"].dtype == torch.int32
    assert torch.equal(tb["positions"], torch.arange(T).expand(B, 3, T)
                       .int())
    emb = tb["embeds"]
    assert emb.dtype == torch.float32 and not emb.requires_grad
    assert torch.equal(emb, params["embed"][torch.from_numpy(toks).long()])
    params["embed"].add_(1.0)
    assert not torch.equal(emb, params["embed"][torch.from_numpy(toks)
                                                .long()])


def test_vlm_train_loss_decreases():
    res = run_training(smoke_config(ARCH), steps=15, batch_size=8,
                       seq_len=32, num_sequences=32, log_every=100,
                       device="cpu")
    assert res.steps == 15
    assert all(np.isfinite(l) for l in res.losses + res.grad_norms)
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
