"""Training the MoE families (and MLA) on the CPU, against the JAX package.

- The shuffle kernels' plain backwards: ``dispatch_bwd_ref`` and
  ``combine_bwd_ref`` against fp64 autograd of the dense one-hot einsum
  (the oracle's masks) at 1e-5 on fp32 inputs and 2e-2 on bf16 ones, and
  ``_Dispatch``/``_Combine`` (``impl="kernel"`` on CPU tensors, so their
  own backward through those plain versions) against ``jax.grad`` of the
  reference's ``shuffle_dispatch/ref.py`` at the reference's MoE tolerance
  (1e-5 fp32, 2e-2 bf16): K = 1, 2, 3 and 6, capacity drops, ids of -1 and
  E, slots of -1 and C + 3, and repeated (e, c) rows that sum. On CPU
  tensors the backward counters move and the launch counters do not.
- The MoE block: ``moe_apply`` (both impls) and ``moe_shardmap_apply`` at
  ``mesh=None`` against ``jax.grad`` of the reference's on smoke
  grok-1-314b and smoke deepseek-v2-lite-16b in fp32 at 3e-4, the routed
  expert ids held equal first (a flipped top-k choice moves a whole row's
  gradient).
- The whole LM: both smoke archs' ``loss`` and every param's gradient
  against ``jax.value_and_grad`` of the reference's on bridged params (fp32
  at 3e-4; bf16 at 2e-2 against the reference run op by op, with
  ``_bf16_leaf_close``'s rule, see ``_bf16_close``), the routed ids of every
  layer equal first;
  the kernel and ``"xla"`` MoE routes and remat give the same gradients;
  ``run_training`` follows the reference's, and the loss falls.
- Serving (no grad) takes neither Function.

The CUDA kernels' backwards are tested on the card by
tests/test_torch_cuda.py.
"""
from contextlib import contextmanager, nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.shuffle_dispatch.ref import combine_ref as jax_combine_ref
from repro.kernels.shuffle_dispatch.ref import dispatch_ref as jax_dispatch_ref
from repro.models import blocks as jax_blocks
from repro.models.model import build_model as jax_build_model
from repro.models.moe_shardmap import moe_shardmap_apply as jax_shardmap
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.kernels.shuffle_dispatch import ops as shuffle_ops
from repro_torch.kernels.shuffle_dispatch.ops import combine, dispatch
from repro_torch.kernels.shuffle_dispatch.ref import (_gated_mask, _mask,
                                                      combine_bwd_ref,
                                                      dispatch_bwd_ref)
from repro_torch.launch.train import run_training
from repro_torch.models import blocks
from repro_torch.models.lm import tree_map
from repro_torch.models.model import build_model
from repro_torch.models.moe_shardmap import moe_shardmap_apply
from test_torch_cuda import SHUFFLE_CASES, SHUFFLE_KINDS, shuffle_inputs
from test_torch_moe import _block, _jax_routing
from test_torch_train_recurrent import _bf16_leaf_close

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}       # the reference's MoE
GRAD_TOL = {"float32": 3e-4, "bfloat16": 2e-2}      # its gradients
ARCHS = ["grok-1-314b", "deepseek-v2-lite-16b"]
# the JAX package's sweep cases (K = 2, 1, 6, 3); the served ones of
# tests/test_torch_cuda.py are the card's
SMALL_CASES = SHUFFLE_CASES[:4]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(ours, ref, tol, what):
    assert tuple(ours.shape) == tuple(ref.shape), what
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=tol, atol=tol,
                               err_msg=what)


def _counters():
    return dict(dispatch=dispatch.launches, combine=combine.launches,
                dispatch_bwd=dispatch.bwd_launches,
                combine_bwd=combine.bwd_launches,
                dispatch_calls=dispatch.bwd_calls,
                combine_calls=combine.bwd_calls)


def _moved(before):
    now = _counters()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


# -- the plain backwards ----------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", SHUFFLE_KINDS)
@pytest.mark.parametrize("case", SMALL_CASES)
def test_shuffle_bwd_refs_match_fp64_autograd(case, kind, dtype):
    """dx, dy and dgates from the plain backwards (fp32 sums, results in
    the inputs' dtypes) against fp64 autograd of the dense one-hot einsum
    over the oracle's own masks."""
    T, D, E, K, C = case
    x, y, gates, eid, slot = shuffle_inputs(np.random.default_rng(T + K),
                                            T, D, E, K, C, kind)
    rng = np.random.default_rng(D)
    dbuf, dout = rng.normal(size=(E, C, D)), rng.normal(size=(T, D))
    td = DTYPES[dtype][1]
    e, s = torch.from_numpy(eid), torch.from_numpy(slot)
    # the inputs as the dtype rounds them, exact in fp64
    xs, ys, gs, dbs, dos = (torch.from_numpy(a).to(td).double()
                            for a in (x, y, gates, dbuf, dout))
    x64, y64, g64 = (t.clone().requires_grad_(True) for t in (xs, ys, gs))
    buf = torch.einsum("tec,td->ecd", _mask(e, s, E, C).double(), x64)
    oh = _gated_mask(e, s, None, E, C).double()        # the unit-gate mask
    eo = (e[..., None] == torch.arange(E)).double()
    so = (s[..., None] == torch.arange(C)).double()
    valid = ((e >= 0) & (s >= 0) & (s < C)).double()
    mg = torch.einsum("tke,tkc,tk->tec", eo, so, valid * g64)
    out = torch.einsum("tec,ecd->td", mg, y64)
    want_dx, = torch.autograd.grad(buf, x64, dbs)
    want_dy, want_dg = torch.autograd.grad(out, (y64, g64), dos)
    assert torch.equal(torch.einsum("tke,tkc,tk->tec", eo, so, valid), oh)
    dx = dispatch_bwd_ref(dbs.to(td), e, s)
    dy, dg = combine_bwd_ref(dos.to(td), ys.to(td), e, s, gs.to(td))
    assert dx.dtype == dy.dtype == dg.dtype == td
    tol = MOE_TOL[dtype]
    _close(dx, want_dx, tol, "dx")
    _close(dy, want_dy, tol, "dy")
    _close(dg, want_dg, tol, "dgates")
    dropped = torch.from_numpy(valid.numpy() == 0)
    if kind == "drops":
        assert dropped.any()
    assert (dg[dropped] == 0).all()


def _jax_shuffle_grads(x, y, gates, eid, slot, E, C, wd, wc, dtype):
    """jax.grad of sum(dispatch_ref(x) wd) + sum(combine_ref(y, gates) wc)
    for x, y and gates in ``dtype``."""
    jd = DTYPES[dtype][0]

    def loss(x, y, g):
        buf = jax_dispatch_ref(x, eid, slot, E, C)
        out = jax_combine_ref(y, eid, slot, g)
        return ((buf.astype(jnp.float32) * wd).sum()
                + (out.astype(jnp.float32) * wc).sum())

    return jax.grad(loss, (0, 1, 2))(*(jnp.asarray(a, jd)
                                       for a in (x, y, gates)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", SHUFFLE_KINDS)
@pytest.mark.parametrize("case", SMALL_CASES)
def test_shuffle_functions_match_jax_grad(case, kind, dtype):
    """``_Dispatch`` and ``_Combine`` on CPU tensors (gates in the data's
    dtype, as the MoE block passes them): dx, dy, dgates against
    ``jax.grad`` of the reference's oracles; each backward called once, no
    kernel launched."""
    T, D, E, K, C = case
    x, y, gates, eid, slot = shuffle_inputs(np.random.default_rng(T + K),
                                            T, D, E, K, C, kind)
    rng = np.random.default_rng(D + 1)
    wd, wc = rng.normal(size=(E, C, D)), rng.normal(size=(T, D))
    jg = _jax_shuffle_grads(x, y, gates, eid, slot, E, C, wd, wc, dtype)
    jd, td = DTYPES[dtype]
    leaves = [torch.from_numpy(np.array(jnp.asarray(a, jd), np.float32))
              .to(td).requires_grad_(True) for a in (x, y, gates)]
    e, s = torch.from_numpy(eid), torch.from_numpy(slot)
    before = _counters()
    buf = dispatch(leaves[0], e, s, E, C, impl="kernel")
    out = combine(leaves[1], e, s, leaves[2], T, impl="kernel")
    assert type(buf.grad_fn).__name__ == "_DispatchBackward"
    assert type(out.grad_fn).__name__ == "_CombineBackward"
    ((buf.float() * torch.from_numpy(wd).float()).sum()
     + (out.float() * torch.from_numpy(wc).float()).sum()).backward()
    assert _moved(before) == {"dispatch_calls": 1, "combine_calls": 1}
    for t, j, name in zip(leaves, jg, ("x", "y", "gates")):
        assert t.grad.dtype == td, name
        _close(t.grad, j, MOE_TOL[dtype], f"d{name}")


def test_combine_backward_takes_only_the_grads_it_needs():
    """With only the gates requiring grad (or only y), the Function
    returns that gradient alone, equal to the full backward's."""
    T, D, E, K, C = SMALL_CASES[2]
    x, y, gates, eid, slot = shuffle_inputs(np.random.default_rng(5), T, D,
                                            E, K, C, "drops")
    e, s = torch.from_numpy(eid), torch.from_numpy(slot)
    dout = torch.from_numpy(np.random.default_rng(6).normal(size=(T, D)))
    yt, gt = torch.from_numpy(y).float(), torch.from_numpy(gates).float()
    dy, dg = combine_bwd_ref(dout.float(), yt, e, s, gt)
    for need in ("y", "gates"):
        ly = yt.clone().requires_grad_(need == "y")
        lg = gt.clone().requires_grad_(need == "gates")
        combine(ly, e, s, lg, T, impl="kernel").backward(dout.float())
        if need == "y":
            assert lg.grad is None and torch.equal(ly.grad, dy)
        else:
            assert ly.grad is None and torch.equal(lg.grad, dg)


def test_shuffle_without_grad_takes_no_function(monkeypatch):
    """Serving: with grad off, or no input that requires it, both wrappers
    take the forward path alone and never reach the Functions; nor does a
    no-grad forward of smoke deepseek-v2-lite-16b."""
    def refuse(*_):
        raise AssertionError("a training Function was called")
    monkeypatch.setattr(shuffle_ops._Dispatch, "apply", refuse)
    monkeypatch.setattr(shuffle_ops._Combine, "apply", refuse)
    T, D, E, K, C = SMALL_CASES[0]
    x, y, gates, eid, slot = shuffle_inputs(np.random.default_rng(1), T, D,
                                            E, K, C, "slots")
    e, s = torch.from_numpy(eid), torch.from_numpy(slot)
    xt = torch.from_numpy(x).float().requires_grad_(True)
    yt = torch.from_numpy(y).float()
    gt = torch.from_numpy(gates).float()
    with torch.no_grad():
        buf = dispatch(xt, e, s, E, C, impl="kernel")
    out = combine(yt, e, s, gt, T, impl="kernel")
    assert buf.grad_fn is None and out.grad_fn is None
    assert torch.equal(buf, dispatch(xt.detach(), e, s, E, C, impl="xla"))
    cfg = smoke_config("deepseek-v2-lite-16b")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    params["unembed"].requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                              (2, 12)))
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": toks})
    assert logits.grad_fn is None


# -- the MoE block ----------------------------------------------------------------
@contextmanager
def _routed_ids(monkeypatch):
    """Records the expert ids of every ``blocks.moe_route`` call."""
    seen, route = [], blocks.moe_route

    def recorded(*args):
        probs, gates, eid = route(*args)
        seen.append(eid.numpy().copy())
        return probs, gates, eid

    monkeypatch.setattr(blocks, "moe_route", recorded)
    yield seen
    monkeypatch.setattr(blocks, "moe_route", route)


@contextmanager
def _jax_routed_ids():
    """Records the reference's expert ids (``jax.lax.top_k``'s indices)
    while it runs op by op."""
    seen, top_k = [], jax.lax.top_k

    def recorded(x, k):
        vals, idx = top_k(x, k)
        seen.append(np.asarray(idx))
        return vals, idx

    jax.lax.top_k = recorded
    try:
        with jax.disable_jit():
            yield seen
    finally:
        jax.lax.top_k = top_k


def _bf16_close(ours, ref, compiled, tol, key):
    """A bf16 gradient leaf against the reference's: ``_bf16_leaf_close``'s
    rule (elementwise within ``tol`` of the op-by-op run, or where the
    reference's compiled run itself misses that, a relative error within
    ``tol`` and no more misses than the compiled run has); or every element
    within ``tol`` of the op-by-op or of the compiled run, both of them the
    reference's own results, and a relative (Frobenius) error to the op-by-op
    run within ``tol``. The second branch takes a leaf whose bf16 sums the
    two reference runs order differently, one of them at the edge of
    ``tol``: smoke deepseek-v2-lite-16b's embedding, whose rows sum a
    token's bf16 gradient over its positions, misses 2e-2 of the op-by-op
    run at one of 16384 elements (on the port's paths that launch no kernel
    too), where the compiled run comes within 0.0017 of missing and is
    further from the op-by-op run in the Frobenius norm (0.0145 against the
    port's 0.0116)."""
    ours, ref, compiled = (np.asarray(a, np.float32)
                           for a in (ours, ref, compiled))

    def near(x, r):
        return np.abs(x - r) <= tol * (1 + np.abs(r))
    rel = np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-30)
    if (near(ours, ref) | near(ours, compiled)).all() and rel <= tol:
        return
    _bf16_leaf_close(ours, ref, compiled, tol, key)


def _block_grads(fn, p, x, w, aux_w):
    """Gradients of sum(y w) + aux_w * aux for every param leaf and x."""
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
    xl = x.detach().clone().requires_grad_(True)
    y, aux = fn(leaves, xl)
    ((y.float() * torch.from_numpy(w).float()).sum() + aux_w * aux).backward()
    return tree_map(lambda t: t.grad, leaves), xl.grad


@pytest.mark.parametrize("path", ["kernel", "xla", "shardmap"])
@pytest.mark.parametrize("cf", [1.0, 4.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_grads_match_jax(arch, cf, path, monkeypatch):
    """``moe_apply`` (impl "kernel" through ``_Dispatch``/``_Combine``, and
    "xla") and ``moe_shardmap_apply`` at ``mesh=None``: the gradient of
    sum(y w) + 0.5 aux for every param and the input, against ``jax.grad``
    of the reference's ``moe_apply`` (or its ``moe_shardmap_apply`` at no
    mesh), in fp32 at 3e-4; at capacity factor 1 pairs are dropped. The
    routed ids first. (bf16 is held for the whole LM below: a lone block's
    norm gradient sums 64 tokens' bf16 gradients, and there every bf16 run,
    the reference's compiled one and the port's kernel-free "xla" path
    included, is 0.6-0.8% from the fp32 gradient, which puts a few of its
    64 elements past 2e-2 of any other run.)"""
    dtype = "float32"
    B, T = 2, 32
    jcfg, tcfg, p, jx, tp, tx = _block(arch, dtype, cf, B, T)
    w = np.random.default_rng(11).normal(size=(B, T, jcfg.d_model))
    shard = path == "shardmap"
    if shard:
        def jfn(p, x):
            return jax_shardmap(p, x, cfg=jcfg, mesh=None)

        def tfn(p, x):
            return moe_shardmap_apply(p, x, cfg=tcfg)
    else:
        def jfn(p, x):
            return jax_blocks.moe_apply(p, x, cfg=jcfg)

        def tfn(p, x):
            return blocks.moe_apply(p, x, cfg=tcfg, impl=path)

    def jloss(p, x):
        y, aux = jfn(p, x)
        return (y.astype(jnp.float32) * w).sum() + 0.5 * aux

    jgp, jgx = jax.grad(jloss, (0, 1))(p, jx)
    jeid, _ = _jax_routing(p, jx, jcfg)
    before = _counters()
    with _routed_ids(monkeypatch) as seen:
        gp, gx = _block_grads(tfn, tp, tx, w, 0.5)
    assert len(seen) == 1 and np.array_equal(seen[0], jeid)
    calls = {"dispatch_calls": 1, "combine_calls": 1}
    assert _moved(before) == ({} if path == "xla" else calls)
    tol = GRAD_TOL[dtype]
    ours = _flatten(jax.tree.map(_np, gp))
    ref = _flatten(jax.tree.map(_np, jgp))
    assert sorted(ours) == sorted(ref)
    ours["x"], ref["x"] = _np(gx), _np(jgx)
    for key in ref:
        _close(ours[key], ref[key], tol, key)


# -- the whole LM -----------------------------------------------------------------
def _pair(arch, dtype, remat="none", **impls):
    jcfg = jax_smoke_config(arch).with_(compute_dtype=dtype)
    tcfg = smoke_config(arch).with_(compute_dtype=dtype, remat=remat)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu", **impls)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _batch(vocab, seed=0, T=24):
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
    return loss.detach(), tree_map(lambda t: t.grad, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_lm_loss_and_grads_match_jax(arch, dtype, monkeypatch):
    """Smoke grok-1-314b and smoke deepseek-v2-lite-16b (MLA): ``loss`` and
    every param's gradient against ``jax.value_and_grad`` of the
    reference's, each layer's routed ids equal first; every MoE layer's
    dispatch and combine through their Functions' backwards and, on
    deepseek, every MLA layer's attention through ``_FlashAttention``."""
    jm, jp, tm, tp = _pair(arch, dtype)
    toks, labels = _batch(256)
    tol = GRAD_TOL[dtype]
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    with _jax_routed_ids() as jeids:
        jm.forward(jp, {"tokens": jbatch["tokens"]})
    ctx = jax.disable_jit() if dtype == "bfloat16" else nullcontext()
    with ctx:
        jl, jg = jax.value_and_grad(jm.loss)(jp, jbatch)
    attn, flash = [], blocks.flash_attention

    def recorded(*args, **kw):
        out = flash(*args, **kw)
        attn.append(type(out.grad_fn).__name__)
        return out

    monkeypatch.setattr(blocks, "flash_attention", recorded)
    before = _counters()
    with _routed_ids(monkeypatch) as eids:
        tl, tg = _loss_and_grads(tm, tp, toks, labels)
    L = tm.cfg.n_layers
    assert len(eids) == len(jeids) == L
    for i in range(L):
        assert np.array_equal(eids[i], jeids[i]), f"layer {i} routing"
    assert _moved(before) == {"dispatch_calls": L, "combine_calls": L}
    if tm.cfg.kv_lora:
        assert attn == ["_FlashAttentionBackward"] * L
    np.testing.assert_allclose(float(tl), float(jl), rtol=tol, atol=tol)
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
            _bf16_close(ours[key], ref[key], compiled[key], tol, key)
        else:
            np.testing.assert_allclose(ours[key], ref[key], rtol=tol,
                                       atol=tol, err_msg=key)


def _grads_close(a, b, rtol, atol):
    a = _flatten(jax.tree.map(lambda t: t.numpy(), a))
    b = _flatten(jax.tree.map(lambda t: t.numpy(), b))
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=rtol, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_and_xla_moe_routes_give_the_same_grads(arch):
    """``moe_impl="kernel"`` (dispatch and combine through their Functions)
    and ``"xla"`` (the reference's dense dispatch mask under autograd):
    the same loss and gradients in fp32, at the MoE tolerance."""
    _, _, tk, tp = _pair(arch, "float32")
    _, _, tx, _ = _pair(arch, "float32", moe_impl="xla")
    toks, labels = _batch(256, seed=4)
    lk, gk = _loss_and_grads(tk, tp, toks, labels)
    lx, gx = _loss_and_grads(tx, tp, toks, labels)
    torch.testing.assert_close(lk, lx, rtol=1e-5, atol=1e-5)
    _grads_close(gx, gk, 1e-5, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_remat_gives_the_same_grads(arch):
    """``remat="layer"`` recomputes each MoE layer in the backward (its
    routing again, the same ids since the kernels are deterministic) and
    gives the plain run's loss and gradients; dispatch and combine run
    twice a layer, their backwards once."""
    _, _, tm, tp = _pair(arch, "float32")
    _, _, tm_r, _ = _pair(arch, "float32", remat="layer")
    toks, labels = _batch(256, seed=1)
    l0, g0 = _loss_and_grads(tm, tp, toks, labels)
    fwd = []
    orig = shuffle_ops._dispatch_fwd

    def counted(*args):
        fwd.append(args[1].clone())
        return orig(*args)

    shuffle_ops._dispatch_fwd = counted
    try:
        before = _counters()
        l1, g1 = _loss_and_grads(tm_r, tp, toks, labels)
    finally:
        shuffle_ops._dispatch_fwd = orig
    L = tm.cfg.n_layers
    assert _moved(before) == {"dispatch_calls": L, "combine_calls": L}
    assert len(fwd) == 2 * L
    for i in range(L):                # the recompute routes as the forward
        assert torch.equal(fwd[i], fwd[L + (L - 1 - i)])
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-5)
    _grads_close(g0, g1, 1e-4, 1e-5)


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
def test_moe_train_loss_decreases(arch):
    res = run_training(smoke_config(arch), steps=15, batch_size=8,
                       seq_len=32, num_sequences=32, log_every=100,
                       device="cpu")
    assert res.steps == 15
    assert all(np.isfinite(l) for l in res.losses + res.grad_norms)
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
