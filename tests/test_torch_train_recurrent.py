"""Training the recurrent families on the CPU, against the JAX package.

- The scans' gradients: ``_DiagScan`` and ``_GLAScan`` (``impl="kernel"``
  on CPU tensors, so through their plain versions and the Functions' own
  backward) against ``jax.grad`` of the reference's ``diag_scan_ref`` and
  ``_gla_chunked_xla``, at 3e-4 in fp32 (the reference's gradient
  tolerance) and 2e-2 in bf16; the diagonal scan's plain backward
  (``diag_scan_bwd_ref``) against fp64 autograd of its forward at 1e-10.
- The whole LM: smoke rwkv6-3b's and smoke recurrentgemma-9b's ``loss``
  and every param's gradient against ``jax.value_and_grad`` of the
  reference's on bridged params: fp32 at 3e-4, bf16 at 2e-2 against the
  reference run op by op (``jax.disable_jit``; see ``_bf16_leaf_close``
  for the leaves where the reference's own compiled run misses 2e-2 of
  it); per-layer (per-superblock) rematerialisation gives the same
  gradients.
- ``run_training``: the same loss at every step as the reference's, from
  bridged params, at 1e-4 in fp32; the loss falls over 15 steps.
- Serving (no grad) takes neither Function.

The CUDA kernels are tested on the card by tests/test_torch_cuda.py.
"""
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.linear_scan.ops import _gla_chunked_xla
from repro.kernels.linear_scan.ref import diag_scan_ref as jax_diag_ref
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.linear_scan.ops import diag_scan, gla_scan
from repro_torch.kernels.linear_scan.ref import (diag_scan_bwd_ref,
                                                 diag_scan_ref)
from repro_torch.launch.train import run_training
from repro_torch.models import blocks
from repro_torch.models.lm import tree_map
from repro_torch.models.model import build_model

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_TOL = {"float32": 3e-4, "bfloat16": 2e-2}
ARCHS = ["rwkv6-3b", "recurrentgemma-9b"]


def _both(a, dtype_name):
    """The same values as a jnp array and a torch CPU leaf of one dtype."""
    jd, td = DTYPES[dtype_name]
    j = jnp.asarray(a, jd)
    t = torch.from_numpy(np.array(j, np.float32)).to(td)
    return j, t.requires_grad_(True)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(ours, ref, tol, what):
    assert tuple(ours.shape) == tuple(ref.shape), what
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=tol, atol=tol,
                               err_msg=what)


# -- the diagonal scan ------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("T", [1, 37, 64])
def test_diag_scan_grads_match_jax(T, with_h0, dtype):
    """da, db (and dh0) of sum(h w) + sum(h_T w_T) through ``_DiagScan``
    against ``jax.grad`` of the reference's sequential scan."""
    B, D = 2, 16
    rng = np.random.default_rng(100 * T + with_h0)
    a = 1 / (1 + np.exp(-rng.normal(size=(B, T, D))))
    b = rng.normal(size=(B, T, D))
    h0 = rng.normal(size=(B, D))
    w, wT = rng.normal(size=(B, T, D)), rng.normal(size=(B, D))
    (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
    jh0, th0 = _both(h0, "float32") if with_h0 else (None, None)

    def j_loss(a, b, h0):
        h, hT = jax_diag_ref(a, b, h0)
        return ((h.astype(jnp.float32) * w).sum()
                + (hT.astype(jnp.float32) * wT).sum())

    argnums = (0, 1, 2) if with_h0 else (0, 1)
    jg = jax.grad(j_loss, argnums)(ja, jb, jh0)
    before = diag_scan.launches
    h, hT = diag_scan(ta, tb, th0, impl="kernel")
    assert type(h.grad_fn).__name__ == "_DiagScanBackward"
    ((h.float() * torch.from_numpy(w).float()).sum()
     + (hT.float() * torch.from_numpy(wT).float()).sum()).backward()
    assert diag_scan.launches == before            # CPU: the plain version
    leaves = (ta, tb, th0) if with_h0 else (ta, tb)
    for t, j, name in zip(leaves, jg, ("a", "b", "h0")):
        assert t.grad.dtype == t.dtype, name
        _close(t.grad, j, GRAD_TOL[dtype], f"d{name}")


@pytest.mark.parametrize("with_gT", [False, True])
@pytest.mark.parametrize("T", [1, 37, 64])
def test_diag_scan_bwd_ref_matches_fp64_autograd(T, with_gT):
    """The plain reverse scan against autograd of the forward, in fp64."""
    B, D = 2, 16
    rng = np.random.default_rng(T + 7 * with_gT)
    a = torch.from_numpy(1 / (1 + np.exp(-rng.normal(size=(B, T, D)))))
    b = torch.from_numpy(rng.normal(size=(B, T, D)))
    h0 = torch.from_numpy(rng.normal(size=(B, D)))
    g = torch.from_numpy(rng.normal(size=(B, T, D)))
    gT = torch.from_numpy(rng.normal(size=(B, D))) if with_gT else None
    leaves = [x.clone().requires_grad_(True) for x in (a, b, h0)]
    h, hT = diag_scan_ref(*leaves)
    outs, cots = [h], [g]
    if with_gT:
        outs.append(hT)
        cots.append(gT)
    want = torch.autograd.grad(outs, leaves, cots)
    h_prev = torch.cat([h0[:, None], h.detach()[:, :-1]], dim=1)
    got = diag_scan_bwd_ref(a, h_prev, g, gT)
    assert all(x.dtype == torch.float64 for x in got)
    for x, y, name in zip(got, want, ("da", "db", "dh0")):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-10, msg=name)


def test_diag_scan_bwd_ref_rounds_like_the_forward():
    """In bf16 the carry stays fp32 and each output is rounded once: the
    gradient equals the fp32 reverse scan of the same values, rounded."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.5, 1, (2, 30, 8))).bfloat16()
    hp = torch.from_numpy(rng.normal(size=(2, 30, 8))).bfloat16()
    g = torch.from_numpy(rng.normal(size=(2, 30, 8))).bfloat16()
    da, db, dh0 = diag_scan_bwd_ref(a, hp, g)
    fa, fb, f0 = diag_scan_bwd_ref(a.float(), hp.float(), g.float())
    assert da.dtype == db.dtype == torch.bfloat16 and dh0.dtype == torch.float32
    assert torch.equal(da, fa.bfloat16()) and torch.equal(db, fb.bfloat16())
    assert torch.equal(dh0, f0)


# -- the GLA scan -----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_S", [False, True])
@pytest.mark.parametrize("T,Dk", [(40, 8), (64, 16), (40, 16)])
def test_gla_scan_grads_match_jax(T, Dk, use_S, dtype):
    """dr, dk, dv, dw, du of sum(o W) (+ sum(S_T W_S)) through ``_GLAScan``
    against ``jax.grad`` of the reference's ``_gla_chunked_xla`` at chunk
    64 (40 is not a chunk multiple), decays at ``rwkv_init``'s scale. With
    S_T unused its cotangent reaches the backward as None."""
    B, Dv = 2, Dk
    rng = np.random.default_rng(T + Dk + use_S)
    vals = [rng.normal(size=(B, T, Dk)), rng.normal(size=(B, T, Dk)),
            rng.normal(size=(B, T, Dv)),
            -np.exp(-2.0 + 0.5 * rng.normal(size=(B, T, Dk))),
            0.1 * rng.normal(size=(B, Dk))]
    W, WS = rng.normal(size=(B, T, Dv)), rng.normal(size=(B, Dk, Dv))
    pairs = [_both(x, dtype) for x in vals]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]

    def j_loss(*xs):
        o, S = _gla_chunked_xla(*xs, chunk=64)
        out = (o.astype(jnp.float32) * W).sum()
        return out + (S * WS).sum() if use_S else out

    jg = jax.grad(j_loss, tuple(range(5)))(*js)
    before = (gla_scan.launches, gla_scan.bwd_calls)
    o, S = gla_scan(*ts, impl="kernel", chunk=64)
    assert type(o.grad_fn).__name__ == "_GLAScanBackward"
    loss = (o.float() * torch.from_numpy(W).float()).sum()
    if use_S:
        loss = loss + (S * torch.from_numpy(WS).float()).sum()
    loss.backward()
    assert (gla_scan.launches, gla_scan.bwd_calls) == (before[0],
                                                       before[1] + 1)
    for t, j, name in zip(ts, jg, "rkvwu"):
        assert t.grad.dtype == t.dtype, name
        _close(t.grad, j, GRAD_TOL[dtype], f"d{name}")


def test_scans_without_grad_call_no_function(monkeypatch):
    """Serving: with grad off (or no input that requires it) both wrappers
    take their old path and never reach the autograd Functions."""
    def refuse(*_):
        raise AssertionError("a training Function was called")
    monkeypatch.setattr(scan_ops._DiagScan, "apply", refuse)
    monkeypatch.setattr(scan_ops._GLAScan, "apply", refuse)
    rng = np.random.default_rng(0)
    a = torch.rand(2, 9, 8, requires_grad=True)
    b = torch.from_numpy(rng.normal(size=(2, 9, 8))).float()
    r, k, v = (torch.from_numpy(rng.normal(size=(2, 9, 8))).float()
               for _ in range(3))
    w = -torch.rand(2, 9, 8)
    u = torch.zeros(2, 8)
    with torch.no_grad():
        h, _ = diag_scan(a, b, impl="kernel")
    assert h.grad_fn is None
    o, _ = gla_scan(r, k, v, w, u, impl="kernel")
    assert o.grad_fn is None
    for arch in ARCHS:
        cfg = smoke_config(arch)
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        params["unembed"].requires_grad_(True)
        with torch.no_grad():
            logits, _ = model.forward(params, {"tokens": _batch(256)[0]})
        assert logits.shape == (2, 24, 256) and logits.grad_fn is None


# -- the whole LM -----------------------------------------------------------------
def _pair(arch, dtype, remat="none"):
    jcfg = jax_smoke_config(arch).with_(compute_dtype=dtype)
    tcfg = smoke_config(arch).with_(compute_dtype=dtype, remat=remat)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _batch(vocab, seed=0, T=24):
    """Two sequences of T tokens: past smoke recurrentgemma's 16-token
    window, and not a multiple of smoke rwkv6's GLA chunk."""
    toks = np.random.default_rng(seed).integers(0, vocab, (2, T)).astype(
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


def _bf16_leaf_close(ours, ref, compiled, tol, key):
    """A bf16 gradient leaf against the op-by-op reference: elementwise
    within ``tol``; or, on a leaf where the reference's own compiled run
    misses ``tol`` of its op-by-op run elementwise (the embedding's rows sum
    a token's bf16 residual-stream gradient over its positions, and the two
    runs sum cotangents in different orders: 313 misses of 16384 on smoke
    rwkv6-3b, 96 on smoke recurrentgemma-9b), a relative (Frobenius) error
    within ``tol`` and no more elementwise misses than the compiled run
    has."""
    def misses(x):
        return int((np.abs(x - ref) > tol * (1 + np.abs(ref))).sum())
    if misses(compiled) == 0:
        np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol,
                                   err_msg=key)
        return
    rel = np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-30)
    assert rel <= tol, (key, rel)
    assert misses(ours) <= misses(compiled), (key, misses(ours),
                                              misses(compiled))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_lm_loss_and_grads_match_jax(arch, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    toks, labels = _batch(256)
    tol = GRAD_TOL[dtype]
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    ctx = jax.disable_jit() if dtype == "bfloat16" else nullcontext()
    with ctx:
        jl, jg = jax.value_and_grad(jm.loss)(jp, jbatch)
    calls = (gla_scan.bwd_calls, diag_scan.launches)
    tl, tg = _loss_and_grads(tm, tp, toks, labels)
    if arch == "rwkv6-3b":             # every layer's wkv through _GLAScan
        assert gla_scan.bwd_calls == calls[0] + tm.cfg.n_layers
    assert diag_scan.launches == calls[1]          # CPU: no kernel
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=tol,
                               atol=tol)
    ours = _flatten(jax.tree.map(lambda t: t.float().numpy(), tg))
    ref = _flatten(jax.tree.map(lambda t: np.asarray(t, np.float32), jg))
    assert sorted(ours) == sorted(ref)
    if dtype == "bfloat16":
        compiled = _flatten(jax.tree.map(
            lambda t: np.asarray(t, np.float32),
            jax.jit(jax.grad(jm.loss))(jp, jbatch)))
    for key in ref:
        assert ours[key].shape == ref[key].shape, key
        if dtype == "bfloat16":
            _bf16_leaf_close(ours[key], ref[key], compiled[key], tol, key)
        else:
            np.testing.assert_allclose(ours[key], ref[key], rtol=tol,
                                       atol=tol, err_msg=key)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_rwkv_gla_chunk_changes_no_result(chunk, monkeypatch):
    """``blocks.TRAIN_GLA_CHUNK`` (the wkv's chunk under grad, 16; here also
    8 and the reference's 64) sets how the wkv is chunked, not what it
    computes: loss and every gradient against the reference's (chunk 64)
    at 3e-4 in fp32, over T = 40 (not a chunk multiple), with every
    layer's wkv through ``_GLAScan`` at that chunk."""
    monkeypatch.setattr(blocks, "TRAIN_GLA_CHUNK", chunk)
    chunks, scan = [], blocks.gla_scan

    def recorded(*args, **kw):
        chunks.append(kw["chunk"])
        return scan(*args, **kw)

    monkeypatch.setattr(blocks, "gla_scan", recorded)
    jm, jp, tm, tp = _pair("rwkv6-3b", "float32")
    toks, labels = _batch(256, seed=3, T=40)
    jl, jg = jax.value_and_grad(jm.loss)(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    bwd = gla_scan.bwd_calls
    tl, tg = _loss_and_grads(tm, tp, toks, labels)
    cfg = smoke_config("rwkv6-3b")
    assert chunks == [chunk] * cfg.n_layers
    assert gla_scan.bwd_calls == bwd + cfg.n_layers
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=3e-4,
                               atol=3e-4)
    ours = _flatten(jax.tree.map(lambda t: t.numpy(), tg))
    ref = _flatten(jax.tree.map(np.asarray, jg))
    assert sorted(ours) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], rtol=3e-4, atol=3e-4,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_grads(arch):
    """``remat="layer"`` recomputes each RWKV6 layer (each hybrid
    superblock; the ``rem`` layers are kept) in the backward and gives the
    plain run's loss and gradients."""
    _, _, tm, tp = _pair(arch, "float32")
    _, _, tm_r, _ = _pair(arch, "float32", remat="layer")
    toks, labels = _batch(256, seed=1)
    l0, g0 = _loss_and_grads(tm, tp, toks, labels)
    l1, g1 = _loss_and_grads(tm_r, tp, toks, labels)
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-5)
    a = _flatten(jax.tree.map(lambda t: t.numpy(), g0))
    b = _flatten(jax.tree.map(lambda t: t.numpy(), g1))
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)


# -- run_training -----------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_from_bridged_params_follows_the_reference(arch):
    """The reference's ``run_training`` and the port's from the same params
    on the same tokens, in fp32: the same loss at every step, at 1e-4."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_train_loss_decreases(arch):
    res = run_training(smoke_config(arch), steps=15, batch_size=8,
                       seq_len=32, num_sequences=32, log_every=100,
                       device="cpu")
    assert res.steps == 15
    assert all(np.isfinite(l) for l in res.losses + res.grad_norms)
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
