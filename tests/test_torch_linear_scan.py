"""The port's GLA scan (the RWKV6 wkv core) against the JAX package's.

On the CPU the port's ``impl="kernel"`` takes its plain version
(``"xla_chunked"``); the JAX kernel runs as the JAX package's own tests run
it (Pallas ``interpret=True``). Inputs come from one numpy seed and go
through both packages. Tolerances are the reference's GLA tolerance, 2e-4,
in fp32 and its bf16 tolerance, 2e-2, in bf16. The CUDA kernel itself is
tested on the card by tests/test_torch_cuda.py, which imports no jax.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan.ops import gla_scan as jax_gla
from repro.kernels.linear_scan.ref import gla_scan_ref as jax_gla_ref
from repro_torch.kernels import _build
from repro_torch.kernels.linear_scan import kernel as gla_kernel
from repro_torch.kernels.linear_scan.ops import _pad_time, gla_scan
from repro_torch.kernels.linear_scan.ref import gla_scan_ref
from test_torch_cuda import GLA_CASES

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _both(a, dtype_name):
    """The same values as a jnp array and a torch CPU tensor of one dtype."""
    jd, td = DTYPES[dtype_name]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


def _gla_inputs(B, T, Dk, Dv, dtype, seed, w0=0.0):
    rng = np.random.default_rng(seed)
    shapes = {"r": (B, T, Dk), "k": (B, T, Dk), "v": (B, T, Dv)}
    vals = {n: rng.normal(size=s) for n, s in shapes.items()}
    vals["w"] = -np.exp(w0 + rng.normal(size=(B, T, Dk)) * 0.5)  # log decays
    vals["u"] = rng.normal(size=(B, Dk))
    pairs = {n: _both(a, dtype) for n, a in vals.items()}
    order = ("r", "k", "v", "w", "u")
    return [pairs[n][0] for n in order], [pairs[n][1] for n in order]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GLA_CASES)
def test_gla_plain_paths_match_jax(case, dtype):
    """The reference's test_gla_scan_sweep cases, a T that is not a chunk
    multiple and Dv != Dk: o and S_T of every port path against the JAX
    oracle and the interpreted JAX kernel."""
    B, T, Dk, Dv, chunk, w0 = case
    jin, tin = _gla_inputs(B, T, Dk, Dv, dtype, seed=42, w0=w0)
    jo_ref, jS_ref = jax_gla_ref(*jin)
    jo_ker, jS_ker = jax_gla(*jin, impl="kernel", chunk=chunk)
    tol = dict(rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(_np(jo_ker), _np(jo_ref), **tol)
    before = gla_scan.launches
    for impl in ("xla", "xla_chunked", "kernel"):
        o, S = gla_scan(*tin, impl=impl, chunk=chunk)
        assert o.dtype == tin[2].dtype and o.shape == (B, T, Dv), impl
        assert S.dtype == torch.float32 and S.shape == (B, Dk, Dv), impl
        assert torch.isfinite(o).all() and torch.isfinite(S).all(), impl
        for what, ours, ref in (("o", o, jo_ref), ("o", o, jo_ker),
                                ("S", S, jS_ref), ("S", S, jS_ker)):
            np.testing.assert_allclose(_np(ours), _np(ref), **tol,
                                       err_msg=f"{impl} {what}")
    assert gla_scan.launches == before        # CPU: the plain version


def test_gla_chunked_factorisation_overflows_where_the_reference_does():
    """A reference quirk the port mirrors: q_intra = r e^{c_{i-1} - c_L}
    grows with the chunk's total decay. At chunk 64 with the reference
    tests' decays (w0 = 0, about -1.1 a token) the exponent passes fp32's
    88.7 and the chunked paths of both packages give non-finite outputs,
    while the sequential oracles stay finite."""
    jin, tin = _gla_inputs(1, 64, 8, 8, "float32", seed=0, w0=0.5)
    jo, _ = jax_gla(*jin, impl="xla_chunked", chunk=64)
    o, _ = gla_scan(*tin, impl="xla_chunked", chunk=64)
    assert not np.isfinite(_np(jo)).all()
    assert not torch.isfinite(o).all()
    assert np.isfinite(_np(jax_gla_ref(*jin)[0])).all()
    assert torch.isfinite(gla_scan(*tin, impl="xla")[0]).all()


def test_gla_ref_carries_an_initial_state():
    """``s0`` continues a scan: two halves from the first half's state give
    the whole, as the JAX oracle's ``s0`` does."""
    jin, tin = _gla_inputs(2, 20, 8, 12, "float32", seed=3)
    o, S = gla_scan_ref(*tin)
    first = [x[:, :9] for x in tin[:4]]
    second = [x[:, 9:] for x in tin[:4]]
    o1, S1 = gla_scan_ref(*first, tin[4])
    o2, S2 = gla_scan_ref(*second, tin[4], s0=S1)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(), o.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(S2.numpy(), S.numpy(), rtol=1e-5, atol=1e-5)
    jS1 = jax_gla_ref(*[x[:, :9] for x in jin[:4]], jin[4])[1]
    jo2, jS2 = jax_gla_ref(*[x[:, 9:] for x in jin[:4]], jin[4], s0=jS1)
    np.testing.assert_allclose(o2.numpy(), _np(jo2), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(S2.numpy(), _np(jS2), rtol=2e-4, atol=2e-4)


def test_gla_ref_in_fp64_is_the_exact_scan():
    """fp64 inputs keep o and S in fp64 (the witness the fp32 paths are held
    against on the card); the fp32 paths lie within the fp32 tolerance of it
    and the JAX oracle agrees."""
    jin, tin = _gla_inputs(2, 40, 16, 8, "float32", seed=6, w0=-2.0)
    o64, S64 = gla_scan_ref(*(x.double() for x in tin))
    assert o64.dtype == S64.dtype == torch.float64
    for impl in ("xla", "xla_chunked"):
        o, S = gla_scan(*tin, impl=impl, chunk=16)
        np.testing.assert_allclose(o.numpy(), o64.numpy(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(S.numpy(), S64.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(jax_gla_ref(*jin)[0]), o64.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_gla_time_padding_is_inert():
    """Zero rows after the last token change neither o nor S: log-decay 0
    is no decay and k = 0 no update."""
    _, tin = _gla_inputs(1, 10, 8, 8, "float32", seed=5)
    o, S = gla_scan(*tin, impl="xla")
    padded = [_pad_time(x, 6) for x in tin[:4]]
    assert padded[0].shape == (1, 16, 8) and not padded[3][:, 10:].any()
    op, Sp = gla_scan(*padded, tin[4], impl="xla")
    np.testing.assert_allclose(op[:, :10].numpy(), o.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(Sp.numpy(), S.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["device", "dtype", "dtype_mix",
                                 "contiguity", "head_dim", "chunk"])
def test_gla_kernel_raises_on_what_it_does_not_take(bad):
    r = torch.zeros(2, 16, 8)
    k, w = torch.zeros(2, 16, 8), torch.zeros(2, 16, 8)
    v = torch.zeros(2, 16, 12)
    u = torch.zeros(2, 8)
    chunk = 16
    if bad == "dtype":
        r, k, v, w, u = (x.half() for x in (r, k, v, w, u))
    elif bad == "dtype_mix":
        v = v.bfloat16()
    elif bad == "contiguity":
        k = torch.zeros(2, 8, 16).transpose(1, 2)
    elif bad == "head_dim":
        r, k, w = (torch.zeros(2, 16, 160) for _ in range(3))
        u = torch.zeros(2, 160)
    elif bad == "chunk":
        chunk = 12                  # does not divide T
    if bad == "device":
        with pytest.raises(ValueError, match="not a CUDA device"):
            gla_kernel.gla_scan_kernel(r, k, v, w, u, chunk=chunk)
        return
    # checks past the device one: pretend the tensors are on the card
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        with pytest.raises((ValueError, TypeError)):
            gla_kernel.check_kernel_inputs(r, k, v, w, u, chunk)
    if bad == "chunk":
        with pytest.raises(ValueError):
            gla_kernel.check_kernel_inputs(r, k, v, w, u, 128)


@pytest.mark.parametrize("rows,Dv,want", [(128, 80, 40), (2, 16, 8),
                                          (4096, 80, 80), (1, 10, 8),
                                          (64, 128, 48)])
def test_gla_dv_tile_fills_the_card(rows, Dv, want):
    tv = gla_kernel.dv_tile(rows, Dv, num_sms=132)
    assert tv == want
    tiles = -(-Dv // tv)
    assert (tiles - 1) * tv < Dv <= tiles * tv       # no empty tile
    assert tv % 4 == 0 or tv == Dv
    if (rows, Dv) == (128, 80):
        assert rows * tiles >= 132                   # the served prefill


def test_gla_build_and_signature():
    assert "linear_scan" in _build.SOURCES
    assert (_build.CSRC / "linear_scan.cu").exists()
    argtypes, restype = gla_kernel._SIGNATURES["gla_scan_fwd"]
    assert restype is ctypes.c_int
    assert argtypes.count(ctypes.c_void_p) == 8     # 7 tensors + the stream
    assert len(argtypes) == 17
