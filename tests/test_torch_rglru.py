"""The port's RG-LRU path (recurrentgemma) against the JAX package's: the
diagonal scan, the RG-LRU block, the GeLU and softplus it rounds, and the
ring-buffer cache of local attention.

On the CPU the port's ``diag_scan(impl="kernel")`` takes its plain version
(``diag_scan_ref``); the JAX kernel runs as the JAX package's own tests run
it (Pallas ``interpret=True``). Inputs come from numpy seeds and go through
both packages. Tolerances are the reference's (``tests/test_kernels.py``
``_tol``): 3e-5 in fp32, 2e-2 in bf16. The CUDA kernel itself is tested on
the card by tests/test_torch_cuda.py, which imports no jax.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.linear_scan.ops import diag_scan as jax_diag
from repro.kernels.linear_scan.ref import diag_scan_ref as jax_diag_ref
from repro.models import blocks as jax_blocks
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels.linear_scan import kernel as scan_kernel
from repro_torch.kernels.linear_scan.ops import diag_scan
from repro_torch.kernels.linear_scan.ref import diag_scan_ref
from repro_torch.models import blocks, common

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py::test_diag_scan_sweep's cases: B, T, D, chunk (T = 100
# is not a multiple of chunk 32: the reference pads it)
DIAG_CASES = [(2, 64, 16, 16), (1, 100, 8, 32), (3, 32, 32, 32)]


def _tol(dtype_name):
    t = 2e-2 if dtype_name == "bfloat16" else 3e-5
    return dict(rtol=t, atol=t)


def _both(a, dtype_name):
    """The same values as a jnp array and a torch CPU tensor of one dtype."""
    jd, td = DTYPES[dtype_name]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _diag_inputs(B, T, D, seed):
    rng = np.random.default_rng(seed)
    return (1 / (1 + np.exp(-rng.normal(size=(B, T, D)))),
            rng.normal(size=(B, T, D)), rng.normal(size=(B, D)))


def _check_diag(a, b, h0, ja, jb, jh0, chunk, tol):
    ref = jax_diag_ref(ja, jb, jh0)
    pallas = jax_diag(ja, jb, jh0, impl="kernel", chunk=chunk)
    before = diag_scan.launches
    for out in (diag_scan_ref(a, b, h0),
                diag_scan(a, b, h0, impl="kernel", chunk=chunk),
                diag_scan(a, b, h0, impl="xla")):
        for o, r, p in zip(out, ref, pallas):
            assert str(o.dtype).split(".")[-1] == r.dtype.name
            assert tuple(o.shape) == r.shape
            np.testing.assert_allclose(_np(o), _np(r), **tol)
            np.testing.assert_allclose(_np(o), _np(p), **tol)
    assert diag_scan.launches == before        # CPU: the plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DIAG_CASES)
def test_diag_scan_matches_jax_ref_and_pallas(case, dtype):
    B, T, D, chunk = case
    a, b, h0 = _diag_inputs(B, T, D, seed=sum(case))
    (ja, ta), (jb, tb), (jh, th) = (_both(x, dtype) for x in (a, b, h0))
    _check_diag(ta, tb, th, ja, jb, jh, chunk, _tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_diag_scan_without_h0(dtype):
    a, b, _ = _diag_inputs(2, 50, 12, seed=7)
    (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
    _check_diag(ta, tb, None, ja, jb, None, 16, _tol(dtype))


def test_diag_scan_with_a_bf16_h0_and_fp32_a():
    """The first prefill of recurrentgemma's unstacked layers: fp32 a and b
    (their vectors stay fp32) from the bf16 zero state of the cache; here
    with a non-zero h0 so that its reading counts."""
    a, b, h0 = _diag_inputs(2, 40, 16, seed=8)
    (ja, ta), (jb, tb) = _both(a, "float32"), _both(b, "float32")
    jh, th = _both(h0, "bfloat16")
    _check_diag(ta, tb, th, ja, jb, jh, 32, _tol("float32"))
    h, hT = diag_scan(ta, tb, th, impl="kernel")
    assert h.dtype == hT.dtype == torch.float32


@pytest.mark.parametrize("bad", ["device", "dtype", "dtype_mix", "shape",
                                 "h0_shape", "contiguity", "empty_T"])
def test_diag_kernel_raises_on_what_it_does_not_take(bad):
    a, b = torch.zeros(2, 16, 8), torch.zeros(2, 16, 8)
    h0 = torch.zeros(2, 8)
    if bad == "dtype":
        a, b = a.half(), b.half()
    elif bad == "dtype_mix":
        b = b.bfloat16()
    elif bad == "shape":
        b = torch.zeros(2, 16, 9)
    elif bad == "h0_shape":
        h0 = torch.zeros(2, 9)
    elif bad == "contiguity":
        a = torch.zeros(2, 8, 16).transpose(1, 2)
    elif bad == "empty_T":
        a, b = torch.zeros(2, 0, 8), torch.zeros(2, 0, 8)
    if bad == "device":
        with pytest.raises(ValueError, match="not a CUDA device"):
            scan_kernel.diag_scan_kernel(a, b, h0)
        return
    # checks past the device one: pretend the tensors are on the card
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        with pytest.raises((ValueError, TypeError)):
            scan_kernel.check_diag_inputs(a, b, h0)


@pytest.mark.parametrize("B,T,D,dtype", [
    (4, 2100, 4096, torch.bfloat16),     # recurrentgemma-9b's prefill
    (4, 2100, 4096, torch.float32),      # its fp32 rem layers
    (4, 1, 4096, torch.bfloat16),        # its decode step
    (4, 1, 4096, torch.float32),
    (2, 77, 33, torch.bfloat16),         # rows that are not 16-byte pieces
    (1, 100, 8, torch.float32),
])
def test_diag_plan_fits_the_card(B, T, D, dtype):
    """The tiling the kernels use: the ring for T > 1 and the step for T = 1;
    at the served prefill at least one block per SM of the H100 (132), shared
    memory within 227 KB a block and 16-byte loads; ragged widths fall to
    element loads, never to another route."""
    plan = scan_kernel.diag_plan(B, T, D, dtype)
    assert plan["route"] == scan_kernel.diag_route(T)
    assert plan["route"] == ("step" if T == 1 else "ring")
    assert plan["smem_bytes"] <= scan_kernel.SMEM_MAX
    elem = torch.empty((), dtype=dtype).element_size()
    if plan["route"] == "ring":
        # the ring's stages hold a and b of `steps` steps of the block's
        # channels, and every channel of every row has a block
        assert plan["smem_bytes"] == plan["stages"] * plan["steps"] * 2 \
            * plan["channels"] * elem
        assert plan["blocks"] * plan["channels"] >= B * D
        assert plan["stages"] >= 3                  # two stages in flight
    else:
        assert plan["blocks"] * plan["threads"] * plan["channels"] >= B * D
        assert plan["smem_bytes"] == 0
    if D == 4096:
        assert plan["access_bytes"] == 16
        if T > 1:
            assert plan["blocks"] >= 132
    if D == 33:
        assert plan["access_bytes"] == elem


def test_diag_build_and_signature():
    assert "diag_scan" in _build.SOURCES
    assert (_build.CSRC / "diag_scan.cu").exists()
    argtypes, restype = scan_kernel._DIAG_SIGNATURES["diag_scan_fwd"]
    assert restype is ctypes.c_int
    assert argtypes.count(ctypes.c_void_p) == 6     # 5 tensors + the stream
    assert len(argtypes) == 11            # + dtype, h0's dtype, B, T, D
    argtypes, restype = scan_kernel._DIAG_SIGNATURES["diag_scan_plan"]
    assert restype is ctypes.c_int
    assert argtypes == [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7


# -- activations ---------------------------------------------------------------------
@pytest.mark.parametrize("name", ["gelu", "softplus"])
def test_activation_rounds_like_the_reference_in_bf16(name):
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 4
    jx = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        ref = np.asarray(getattr(jax.nn, name)(jx), np.float32)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).bfloat16()
    assert np.array_equal(getattr(common, name)(tx).float().numpy(), ref)
    # in fp32 the two frameworks' tanh and log1p differ in the last bits
    ref32 = np.asarray(getattr(jax.nn, name)(jnp.asarray(x)))
    np.testing.assert_allclose(
        getattr(common, name)(torch.from_numpy(x)).numpy(), ref32,
        rtol=1e-6, atol=1e-6)


def test_einsum_promotes_mixed_operands_like_jnp():
    rng = np.random.default_rng(1)
    a32, b32 = rng.normal(size=(2, 3, 8)), rng.normal(size=(8, 5))
    ja, ta = _both(a32, "bfloat16")
    jb, tb = _both(b32, "float32")
    ref = jnp.einsum("btd,dv->btv", ja, jb)
    out = common.einsum("btd,dv->btv", ta, tb)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError):
        torch.einsum("btd,dv->btv", ta, tb)


# -- the RG-LRU block ----------------------------------------------------------------
def _hybrid_params(dtype):
    """The reference's smoke recurrentgemma params after its compute cast:
    superblock 0's first RG-LRU block (stacked, so its vectors are cast too)
    and the unstacked ``rem`` layer's (vectors left in fp32)."""
    jcfg = jax_smoke_config("recurrentgemma-9b").with_(compute_dtype=dtype,
                                                       kv_cache_dtype=dtype)
    jm = jax_build_model(jcfg)
    jpc = jm._compute_cast(jm.init(jax.random.PRNGKey(0)))
    sup = jax.tree.map(lambda a: a[0], jpc["layers"]["t0"])
    rem = jpc["rem"][0]["t"]
    tcfg = smoke_config("recurrentgemma-9b").with_(compute_dtype=dtype,
                                                   kv_cache_dtype=dtype)
    return jcfg, tcfg, {"super": sup, "rem": rem}


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", ["super", "rem"])
def test_rglru_apply_matches_jax(layer, dtype):
    """Prefill from the zero state, then one decode step, against the
    reference run op by op. A ``rem`` layer's fp32 vectors promote its
    residual and its h to fp32 (the conv state stays in the input's type)."""
    jcfg, tcfg, ps = _hybrid_params(dtype)
    jp = ps[layer]
    tp = params_from_numpy(_tree_np(jp), device="cpu")
    rng = np.random.default_rng(3)
    jx, tx = _both(rng.normal(size=(2, 12, 64)), dtype)
    jx1, tx1 = _both(rng.normal(size=(2, 1, 64)), dtype)
    tol = _tol(dtype)
    with jax.disable_jit():
        jst0 = jax_blocks.rglru_state_init(jcfg, 2, jnp.dtype(dtype))
        jy, jst = jax_blocks.rglru_apply(jp, jx, cfg=jcfg, state=jst0)
        jy1, jst1 = jax_blocks.rglru_apply(jp, jx1, cfg=jcfg, state=jst)
        jyf, _ = jax_blocks.rglru_apply(jp, jx, cfg=jcfg)
    tst0 = blocks.rglru_state_init(tcfg, 2, DTYPES[dtype][1], "cpu")
    ty, tst = blocks.rglru_apply(tp, tx, cfg=tcfg, state=tst0)
    ty1, tst1 = blocks.rglru_apply(tp, tx1, cfg=tcfg, state=tst)
    tyf, none = blocks.rglru_apply(tp, tx, cfg=tcfg)
    assert none is None
    for t, j, what in ((ty, jy, "y"), (ty1, jy1, "decode y"),
                       (tyf, jyf, "stateless y"),
                       (tst["h"], jst["h"], "h"), (tst["conv"], jst["conv"],
                                                   "conv"),
                       (tst1["h"], jst1["h"], "decode h"),
                       (tst1["conv"], jst1["conv"], "decode conv")):
        assert str(t.dtype).split(".")[-1] == j.dtype.name, what
        np.testing.assert_allclose(_np(t), _np(j), err_msg=what, **tol)
    if layer == "rem" and dtype == "bfloat16":
        assert ty.dtype == tst["h"].dtype == torch.float32
        assert tst["conv"].dtype == torch.bfloat16


# -- the ring buffer of local attention ----------------------------------------------
@pytest.mark.parametrize("T,max_len", [(10, 24), (16, 24), (21, 24), (10, 12),
                                       (21, 16)])
def test_pack_prefill_cache_matches_jax(T, max_len):
    """Window 16: a dense cache of min(max_len, 16) slots below the window,
    a ring of 16 slots from it on (slot i holds position T-1-((T-1-i) mod
    16))."""
    jcfg = jax_smoke_config("recurrentgemma-9b")
    tcfg = smoke_config("recurrentgemma-9b")
    rng = np.random.default_rng(T)
    (jk, tk), (jv, tv) = (_both(rng.normal(size=(2, 1, T, 16)), "float32")
                          for _ in range(2))
    ref = jax_blocks.pack_prefill_cache(jcfg, (jk, jv), max_len,
                                        jnp.bfloat16)
    out = blocks.pack_prefill_cache(tcfg, (tk, tv), max_len, torch.bfloat16)
    for key in ("k", "v"):
        assert tuple(out[key].shape) == ref[key].shape
        assert out[key].dtype == torch.bfloat16
        assert np.array_equal(_np(out[key]), _np(ref[key])), key
    if T >= 16 and max_len >= 16:
        # position T-1 sits in slot (T-1) mod 16
        assert torch.equal(out["k"][:, :, (T - 1) % 16],
                           tk[:, :, T - 1].bfloat16())


@pytest.mark.parametrize("pos", [5, 16, 37])
def test_window_ring_decode_matches_jax(pos):
    jcfg = jax_smoke_config("recurrentgemma-9b")
    tcfg = smoke_config("recurrentgemma-9b")
    rng = np.random.default_rng(pos)
    jq, tq = _both(rng.normal(size=(2, 4, 1, 16)), "float32")
    (jk, tk), (jv, tv) = (_both(rng.normal(size=(2, 1, 1, 16)), "float32")
                          for _ in range(2))
    (jck, tck), (jcv, tcv) = (_both(rng.normal(size=(2, 1, 16, 16)),
                                    "float32") for _ in range(2))
    jo, jc = jax_blocks._window_ring_decode(jcfg, jq, jk, jv, jck, jcv, pos)
    to = blocks._window_ring_decode(tcfg, tq, tk, tv, tck, tcv, pos)
    np.testing.assert_allclose(to.numpy(), _np(jo), **_tol("float32"))
    # the new k/v went into slot pos mod 16, in place
    assert np.array_equal(tck.numpy(), _np(jc["k"]))
    assert np.array_equal(tcv.numpy(), _np(jc["v"]))
