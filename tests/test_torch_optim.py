"""The port's optimizer (``repro_torch.optim``) on the CPU.

Every test of the JAX package's ``tests/test_optim.py`` is mirrored here on
the port. The cross-package tests hold one ``adamw_update`` and one
``make_train_step`` step (with and without microbatches, fp32 and bf16
moments) to the reference's at 1e-6 relative on the same numpy inputs, and
the int8 compression's averaging all-reduce over a two-process gloo group
to the mean of the reference's local quantise-dequantise.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels.adamw import adamw, adamw_ref, bias_corrections
from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.optim import (AdamWState, adamw_apply, adamw_init,
                               adamw_update,
                               compress_int8, compressed_allreduce,
                               decompress_int8, make_train_step)
from repro_torch.optim.train_state import TrainState, make_train_state

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _np(t):
    return t.detach().float().numpy()


# -- tests/test_optim.py ---------------------------------------------------------
def test_adamw_optimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = adamw_init(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, state = adamw_update(params, {"w": g}, state, lr=0.1,
                                     weight_decay=0.0)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_adamw_bf16_moments():
    params = {"w": torch.ones((4, 4))}
    state = adamw_init(params, dtype="bfloat16")
    assert state.m["w"].dtype == torch.bfloat16
    g = {"w": torch.full((4, 4), 0.1)}
    params2, state2 = adamw_update(params, g, state)
    assert state2.v["w"].dtype == torch.bfloat16
    assert not torch.equal(params2["w"], params["w"])


def _linear_problem():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(8, 4)).astype(np.float32),
            rng.normal(size=(16, 8)).astype(np.float32),
            rng.normal(size=(16, 4)).astype(np.float32))


def test_train_step_microbatching_matches_full_batch():
    w, x, y = _linear_problem()

    def loss(p, batch):
        pred = batch["x"] @ p["w"]
        return torch.mean((pred - batch["y"]) ** 2)

    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    # each state its own copy of w: the step updates its params in place
    s1 = make_train_state({"w": torch.tensor(w)})
    s2 = make_train_state({"w": torch.tensor(w)})
    s1b, m1 = make_train_step(loss, lr=1e-2)(s1, batch)
    s2b, m2 = make_train_step(loss, lr=1e-2, microbatches=4)(s2, batch)
    # microbatched grads average per-microbatch MEANS == full-batch mean here
    np.testing.assert_allclose(_np(m1["loss"]), _np(m2["loss"]), rtol=1e-5)
    np.testing.assert_allclose(_np(s1b.params["w"]), _np(s2b.params["w"]),
                               rtol=1e-4, atol=1e-5)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=1,
                max_size=64))
def test_int8_quantization_error_bound(vals):
    g = torch.tensor(np.array(vals, np.float32))
    q, scale = compress_int8(g)
    deq = decompress_int8(q, scale)
    amax = float(g.abs().max())
    assert float((deq - g).abs().max()) <= amax / 127.0 + 1e-6


def test_error_feedback_converges():
    """With error feedback, the accumulated quantization bias stays bounded
    and the running mean of dequantized grads tracks the true mean."""
    rng = np.random.default_rng(0)
    true = {"w": torch.tensor(rng.normal(size=(32,)), dtype=torch.float32)}
    err = None
    acc = torch.zeros(32)
    n = 50
    for _ in range(n):
        deq, err = compressed_allreduce(true, None, err)
        acc = acc + deq["w"]
    np.testing.assert_allclose(_np(acc / n), _np(true["w"]), atol=2e-2)
    amax = float(true["w"].abs().max()) + float(err["w"].abs().max())
    assert float(err["w"].abs().max()) <= amax / 127.0 * 2 + 1e-5


# -- the port against the reference ------------------------------------------------
def _tree(rng):
    """Params or grads with the leaf ranks AdamW treats apart: a matrix, a
    stacked [L, d] vector and a plain vector."""
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "layers": {"norm": rng.normal(size=(2, 5)).astype(np.float32)},
            "b": rng.normal(size=(5,)).astype(np.float32)}


def _close_tree(t_tree, j_tree, rtol):
    for k in ("w", "b"):
        np.testing.assert_allclose(_np(t_tree[k]),
                                   np.asarray(j_tree[k], np.float32),
                                   rtol=rtol, atol=0, err_msg=k)
    np.testing.assert_allclose(_np(t_tree["layers"]["norm"]),
                               np.asarray(j_tree["layers"]["norm"],
                                          np.float32), rtol=rtol, atol=0)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_equals_the_reference(moments):
    from repro.optim import adamw_init as ref_init
    from repro.optim import adamw_update as ref_update
    rng = np.random.default_rng(1)
    p = _tree(rng)
    tp = jax.tree.map(torch.from_numpy, p)
    ts, js = adamw_init(tp, moments), ref_init(jax.tree.map(jnp.asarray, p),
                                               moments)
    jp = jax.tree.map(jnp.asarray, p)
    for _ in range(3):       # the bias correction changes step to step
        g = _tree(rng)
        tp, ts = adamw_update(tp, jax.tree.map(torch.from_numpy, g), ts,
                              lr=1e-2)
        jp, js = ref_update(jp, jax.tree.map(jnp.asarray, g), js, lr=1e-2)
    assert isinstance(ts, AdamWState) and int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32
    _close_tree(tp, jp, 1e-6)
    rtol = 1e-6 if moments == "float32" else 0
    _close_tree(ts.m, js.m, rtol)
    _close_tree(ts.v, js.v, rtol)
    assert ts.m["w"].dtype == getattr(torch, moments)
    # functional: the inputs are not changed in place
    t0 = jax.tree.map(torch.from_numpy, _tree(np.random.default_rng(1)))
    before = _np(t0["w"]).copy()
    adamw_update(t0, jax.tree.map(torch.from_numpy, g),
                 adamw_init(t0, moments))
    assert np.array_equal(_np(t0["w"]), before)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_donated_step_updates_in_place_to_the_same_bits(moments):
    """The train step (its state donated, as the reference's jit donates
    it) writes the functional ``adamw_update``'s values, bit for bit, into
    the state's own tensors; ``adamw_apply`` frees each gradient as it
    goes."""
    w, x, y = _linear_problem()
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    plain = make_train_state({"w": torch.tensor(w)}, moments)
    given_ = make_train_state({"w": torch.tensor(w)}, moments)
    tensors = (given_.params["w"], given_.opt.m["w"], given_.opt.v["w"])
    step = make_train_step(loss, lr=1e-2)
    for _ in range(3):
        leaf = plain.params["w"].detach().requires_grad_(True)
        g, = torch.autograd.grad(loss({"w": leaf}, batch), [leaf])
        params, opt = adamw_update(plain.params, {"w": g}, plain.opt,
                                   lr=1e-2)
        plain = TrainState(params, opt)
        given_, gm = step(given_, batch)
    assert all(a is b for a, b in zip(
        (given_.params["w"], given_.opt.m["w"], given_.opt.v["w"]), tensors))
    assert int(given_.opt.step) == int(plain.opt.step) == 3
    for a, b in ((given_.params, plain.params), (given_.opt.m, plain.opt.m),
                 (given_.opt.v, plain.opt.v)):
        assert torch.equal(a["w"], b["w"]) and a["w"].dtype == b["w"].dtype
    assert float(gm["grad_norm"]) == float(torch.sqrt(torch.sum(
        torch.square(g))))
    grads = [torch.ones(8, 4)]
    adamw_apply({"w": torch.zeros(8, 4)}, grads, adamw_init(
        {"w": torch.zeros(8, 4)}, moments))
    assert grads == [None]


@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_train_step_equals_the_reference(microbatches, moments):
    from repro.optim import make_train_step as ref_step
    from repro.optim.train_state import make_train_state as ref_state
    w, x, y = _linear_problem()
    b = np.random.default_rng(3).normal(size=(4,)).astype(np.float32)

    def t_loss(p, batch):
        pred = batch["x"] @ p["w"] + p["b"]
        return torch.mean((pred - batch["y"]) ** 2)

    def j_loss(p, batch):
        pred = batch["x"] @ p["w"] + p["b"]
        return jnp.mean((pred - batch["y"]) ** 2)

    ts = make_train_state({"w": torch.tensor(w), "b": torch.tensor(b)},
                          moments)
    js = ref_state({"w": jnp.asarray(w), "b": jnp.asarray(b)}, moments)
    t_step = make_train_step(t_loss, lr=1e-2, microbatches=microbatches)
    j_step = ref_step(j_loss, lr=1e-2, microbatches=microbatches)
    for _ in range(2):
        ts, tm = t_step(ts, {"x": torch.from_numpy(x),
                             "y": torch.from_numpy(y)})
        js, jm = j_step(js, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    assert isinstance(ts, TrainState)
    assert int(tm["step"]) == int(jm["step"]) == 2
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_np(tm[key]), np.asarray(jm[key]),
                                   rtol=1e-6, err_msg=key)
    for key in ("w", "b"):
        np.testing.assert_allclose(_np(ts.params[key]),
                                   np.asarray(js.params[key]), rtol=1e-6,
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_an_unused_leaf_gets_zeros_and_the_reference_bits(moments,
                                                          microbatches):
    """A loss that leaves one rank-2 leaf unused (the VLM's ``embed`` when
    the batch brings ``embeds``): ``leaf_grads`` gives it an fp32 zero
    gradient of its shape, as ``jax.grad`` gives zeros, and one step
    matches the reference's ``make_train_step`` bit for bit on every leaf,
    params and moments: the unused leaf decayed, its moments zero. The
    loss is linear in the used leaves, so that both packages' gradients
    are exact and only the step is compared; the reference's step runs as
    ``make_train_step`` returns it, op by op."""
    from repro.optim import make_train_step as ref_step
    from repro.optim.train_state import make_train_state as ref_state
    from repro_torch.optim.train_state import leaf_grads
    rng = np.random.default_rng(5)
    p = {"embed": rng.normal(size=(16, 8)).astype(np.float32),
         "w": rng.normal(size=(8, 4)).astype(np.float32),
         "layers": {"norm": rng.normal(size=(2, 4)).astype(np.float32)},
         "b": rng.normal(size=(4,)).astype(np.float32)}
    batch = {"w": rng.normal(size=(4, 8, 4)).astype(np.float32),
             "norm": rng.normal(size=(4, 2, 4)).astype(np.float32),
             "b": rng.normal(size=(4, 4)).astype(np.float32)}

    def loss(q, bt):                     # torch and jnp alike
        return ((q["w"] * bt["w"].mean(0)).sum() + (q["layers"]["norm"]
                * bt["norm"].mean(0)).sum() + (q["b"] * bt["b"].mean(0)).sum())

    leaf = torch.tensor(p["embed"], requires_grad=True)
    used = torch.tensor(p["b"], requires_grad=True)
    zero, gb = leaf_grads((used * 2).sum(), [leaf, used])
    assert zero.dtype == torch.float32 and zero.shape == leaf.shape
    assert not zero.any() and torch.equal(gb, torch.full((4,), 2.0))
    ts = make_train_state(jax.tree.map(torch.tensor, p), moments)
    js = ref_state(jax.tree.map(jnp.asarray, p), moments)
    ts, tm = make_train_step(loss, lr=1e-2, microbatches=microbatches)(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    js, jm = ref_step(loss, lr=1e-2, microbatches=microbatches)(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_np(tm[key]), np.asarray(jm[key]),
                                   rtol=1e-6, err_msg=key)
    for name, ours, ref in (("params", ts.params, js.params),
                            ("m", ts.opt.m, js.opt.m),
                            ("v", ts.opt.v, js.opt.v)):
        for key, a, b in (("embed", ours["embed"], ref["embed"]),
                          ("w", ours["w"], ref["w"]),
                          ("norm", ours["layers"]["norm"],
                           ref["layers"]["norm"]),
                          ("b", ours["b"], ref["b"])):
            assert _np(a).tobytes() == np.asarray(b, np.float32).tobytes(), \
                (name, key)
    assert not np.array_equal(_np(ts.params["embed"]), p["embed"])
    assert not ts.opt.m["embed"].any() and not ts.opt.v["embed"].any()


# -- the update's wrapper (kernels/adamw) on the CPU ----------------------------------
def _bits(t):
    return t.detach().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("grad", ["dense", "zeros"])
@pytest.mark.parametrize("shape", [(7,), (6, 5), (2, 3, 4)])
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "float32"),
                                    ("bfloat16", "bfloat16")])
def test_adamw_wrapper_plain_route_is_the_plain_update(dtypes, shape, grad):
    """On CPU tensors ``adamw`` writes ``adamw_ref``'s values, bit for bit,
    into the leaf's own tensors, at steps 1 to 3 (rank 1 and rank >= 2; a
    broadcast zero gradient as ``leaf_grads`` makes it), and never touches
    the launch counters."""
    pdt, mdt = (getattr(torch, d) for d in dtypes)
    gen = torch.Generator().manual_seed(len(shape))
    p = torch.randn(shape, generator=gen).to(pdt)
    m = torch.randn(shape, generator=gen).to(mdt)
    v = torch.rand(shape, generator=gen).to(mdt)
    own = (p, m, v)
    launches = adamw.launches, dict(adamw.launches_by_route)
    for step in (1, 2, 3):
        t = torch.tensor(float(step))
        g = torch.randn(shape, generator=gen).to(pdt) if grad == "dense" \
            else torch.zeros((), dtype=torch.float32).expand(shape)
        want = adamw_ref(p, g, m, v, t, 1e-2, 0.9, 0.95, 1e-8, 0.1)
        adamw(p, g, m, v, t, bias_corrections(t, 0.9, 0.95), lr=1e-2,
              b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
        for got, ref in zip(own, want):
            assert got.dtype == ref.dtype and _bits(got) == _bits(ref), step
    assert (adamw.launches, adamw.launches_by_route) == launches


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_adamw_apply_off_the_card_launches_nothing(device):
    """Off the card (the CPU, or ``meta`` as the dry-run's step) every leaf
    takes the plain version: no launch is counted and nothing raises."""
    grads = [torch.ones(8, 4, device=device), torch.ones(3, device=device)]
    params = {"w": torch.zeros(8, 4, device=device),
              "b": torch.zeros(3, device=device)}
    launches = adamw.launches, dict(adamw.launches_by_route)
    _, state = adamw_apply(params, grads, adamw_init(params))
    assert grads == [None, None] and state.step.device.type == device
    assert (adamw.launches, adamw.launches_by_route) == launches


def _leaf(shape=(4, 8), pdt=torch.float32, gdt=None, mdt=torch.float32,
          vdt=None):
    return (torch.zeros(shape, dtype=pdt),
            torch.zeros(shape, dtype=gdt or pdt),
            torch.zeros(shape, dtype=mdt), torch.zeros(shape, dtype=vdt or mdt))


@pytest.mark.parametrize("case,error", [
    (dict(pdt=torch.float16), TypeError),
    (dict(pdt=torch.float64), TypeError),
    (dict(gdt=torch.float16), TypeError),
    (dict(mdt=torch.float16), TypeError),
    (dict(mdt=torch.bfloat16, vdt=torch.float32), TypeError),
    (dict(mdt=torch.int32), TypeError),
])
def test_adamw_kernel_refuses_dtypes_it_does_not_take(case, error):
    """The kernel's argument check, which every CUDA leaf passes before a
    launch: a param, gradient or moment in another dtype than float32 or
    bfloat16, or m and v apart, raises (here without a card)."""
    with pytest.raises(error):
        adamw_kernel.check_leaf(*_leaf(**case))


def test_adamw_kernel_checks_layout_and_route():
    """Shapes and layouts the kernel refuses, the ones it takes, and the
    route each takes (by the addresses alone), on CPU tensors."""
    p, g, m, v = _leaf((4, 8))
    adamw_kernel.check_leaf(p, g, m, v)
    assert adamw_kernel.kernel_route(p, g, m, v) == "vector"
    zeros = torch.zeros((), dtype=torch.float32).expand(4, 8)
    assert adamw_kernel.is_broadcast(zeros)
    assert not adamw_kernel.is_broadcast(g)
    adamw_kernel.check_leaf(p, zeros, m, v)
    assert adamw_kernel.kernel_route(p, zeros[:, 1:], m, v) == "vector"
    with pytest.raises(ValueError, match="contiguous"):
        adamw_kernel.check_leaf(p.t(), g.t(), m.t(), v.t())
    with pytest.raises(ValueError, match="contiguous"):
        adamw_kernel.check_leaf(p, torch.zeros(8, 4).t(), m, v)
    with pytest.raises(ValueError, match="shape|param's"):
        adamw_kernel.check_leaf(p, torch.zeros(4, 7), m, v)
    buf = torch.zeros(33)
    off = buf[1:].view(4, 8)                      # 4 bytes past a boundary
    adamw_kernel.check_leaf(off, g, m, v)
    assert adamw_kernel.kernel_route(off, g, m, v) == "scalar"
    assert adamw_kernel.kernel_route(p, g, m, off) == "scalar"
    assert adamw_kernel.kernel_route(p, off, m, v) == "scalar"
    with pytest.raises(ValueError, match="CUDA"):
        adamw_kernel.adamw_kernel(p, g, m, v, torch.ones(()), torch.ones(()),
                                  lr=1e-2, b1=0.9, b2=0.95, eps=1e-8,
                                  weight_decay=0.1)


ALLREDUCE = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.optim import compressed_allreduce
rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
rng = np.random.default_rng(100 + rank)
grads = {"w": torch.tensor(rng.normal(size=(6, 5)), dtype=torch.float32),
         "b": torch.tensor(rng.normal(size=(7,)), dtype=torch.float32)}
err = None
out = []
for _ in range(2):
    avg, err = compressed_allreduce(grads, dist.group.WORLD, err)
    out.append({k: v.tolist() for k, v in avg.items()})
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_compressed_allreduce_over_a_gloo_group_equals_the_reference(
        tmp_path):
    """Two processes over gloo: each step's result is the mean, over the
    ranks, of the reference's local quantise-dequantise with its own error
    feedback (``axis_name=None``), which is what its ``pmean`` computes."""
    from repro.optim import compressed_allreduce as ref_allreduce
    world = 2
    init = f"file://{tmp_path / 'pg'}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", ALLREDUCE, str(r),
                               str(world), init], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr[-2000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    assert outs[0] == outs[1]
    errs = [None] * world
    for step in range(2):
        deqs = []
        for r in range(world):
            rng = np.random.default_rng(100 + r)
            g = {"w": jnp.asarray(rng.normal(size=(6, 5)), jnp.float32),
                 "b": jnp.asarray(rng.normal(size=(7,)), jnp.float32)}
            d, errs[r] = ref_allreduce(g, None, errs[r])
            deqs.append(d)
        for k in ("w", "b"):
            want = (np.asarray(deqs[0][k]) + np.asarray(deqs[1][k])) / world
            np.testing.assert_allclose(np.asarray(outs[0][step][k]), want,
                                       rtol=1e-6, atol=1e-7)
