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
    # the tensor-core route: the same arguments without the dtype
    argtypes, restype = gla_kernel._SIGNATURES["gla_scan_fwd_mma"]
    assert restype is ctypes.c_int
    assert argtypes.count(ctypes.c_void_p) == 8
    assert len(argtypes) == 16
    argtypes, restype = gla_kernel._SIGNATURES["gla_scan_mma_smem"]
    assert restype is ctypes.c_int and argtypes == [ctypes.c_int] * 3


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float32, "fma")])
def test_gla_route_by_dtype(dtype, route):
    """bf16 inputs of every width take the tensor-core route; fp32 keeps
    the FMA kernel (its 2e-4 tolerance rules out rounded operands)."""
    assert gla_kernel.gla_route(dtype) == route
    assert set(gla_kernel.GLA_ROUTES) == {"mma", "fma"}


@pytest.mark.parametrize("case", GLA_CASES + [(128, 512, 80, 80, 64, -2.0),
                                             (200, 128, 128, 128, 64, -2.0)])
def test_gla_mma_tiles_fit_the_card(case):
    """The tensor-core route's Dv tile at GLA_CASES, the served shape and a
    wide head: a block's shared memory within the H100's 227 KB, every
    column covered, and at the served shape (128 rows, Dv 80) two tiles of
    40, so that 256 blocks cover the 132 SMs."""
    B, T, Dk, Dv, chunk, _ = case
    chunk = min(chunk, T)
    tv = gla_kernel.mma_dv_tile(B, Dk, Dv, chunk, num_sms=132)
    assert 1 <= tv <= Dv
    assert gla_kernel.gla_mma_smem(chunk, Dk, tv) <= gla_kernel.SMEM_MAX
    tiles = -(-Dv // tv)
    assert (tiles - 1) * tv < Dv <= tiles * tv          # no empty tile
    if (B, Dk, Dv) == (128, 80, 80):
        assert tv == 40 and B * tiles >= 132


def _round_tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    """x = hi + lo, each a bf16 (the tensor-core route's operand split)."""
    hi = _round_bf16(x)
    return hi, _round_bf16(x - hi)


def _prod(a, b, eq, how):
    """einsum(eq, a, b) with fp32 sums and the operands as ``how`` makes
    them: "bf16" or "tf32" (each rounded once), "split" (a and b split, three
    products) or "split_a" (a split, b exact in bf16: two products)."""
    if how in ("bf16", "tf32"):
        rnd = _round_bf16 if how == "bf16" else _round_tf32
        return torch.einsum(eq, rnd(a), rnd(b))
    ah, al = _split(a)
    if how == "split_a":
        return torch.einsum(eq, ah, b) + torch.einsum(eq, al, b)
    bh, bl = _split(b)
    return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, al, bh))


def _gla_chunked_rounded(r, k, v, w, u, chunk, how):
    """The chunked factorisation with its four products' operands rounded
    as the tensor-core route would: ``how`` for the products of two fp32
    operands (q_inter S, q_intra k_intra^T); v is bf16 (exact), so A v and
    k_intra^T v round only A and k_intra ("split_a" under "split")."""
    B, T, Dk = r.shape
    r, k, v, w = (x.float() for x in (r, k, v, w))
    strict = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool), -1)
    S = torch.zeros((B, Dk, v.shape[-1]))
    one = "split_a" if how == "split" else how
    outs = []
    for s in range(0, T, chunk):
        rc, kc, vc, wc = (x[:, s:s + chunk] for x in (r, k, v, w))
        cum = torch.cumsum(wc, 1)
        ex, cl = cum - wc, cum[:, -1:]
        q_inter, q_intra = rc * torch.exp(ex), rc * torch.exp(ex - cl)
        k_intra = kc * torch.exp(cl - cum)
        A = torch.where(strict, _prod(q_intra, k_intra, "bik,bjk->bij", how),
                        0.0)
        bonus = torch.einsum("blk,bk,blk->bl", rc, u.float(), kc)
        outs.append(_prod(q_inter, S, "blk,bkv->blv", how)
                    + _prod(A.transpose(1, 2), vc, "bji,bjv->biv", one)
                    + bonus[..., None] * vc)
        S = torch.exp(cl).transpose(1, 2) * S \
            + _prod(k_intra, vc, "blk,blv->bkv", one)
    return torch.cat(outs, 1).to(torch.bfloat16), S


def test_gla_operand_rounding_choice():
    """Why the tensor-core route splits its operands: at the served head
    (Dk = Dv = 80, chunk 64, T = 512, rwkv's decays) with unit-scale bf16 r
    and k, operands rounded once to bf16 or to TF32 put o past GLA's bf16
    tolerance (2e-2 of 1 + |o|) against the chunked plain version, and the
    hi + lo split keeps it well within (measured: ~9x, ~1.5x and ~0.36x of
    the tolerance on these 8 rows)."""
    rng = np.random.default_rng(0)
    B, T, D = 8, 512, 80
    r, k, v = (torch.from_numpy(rng.normal(size=(B, T, D))).float()
               for _ in range(3))
    w = -torch.exp(-2 + torch.from_numpy(rng.normal(size=(B, T, D))) * 0.5)
    u = torch.from_numpy(rng.normal(size=(B, D)))
    r, k, v, w, u = (x.to(torch.bfloat16) for x in (r, k, v, w, u))
    ro, rS = gla_scan(r, k, v, w, u, impl="xla_chunked", chunk=64)
    ref = ro.float()

    def share(how):
        o, S = _gla_chunked_rounded(r, k, v, w, u, 64, how)
        return float(((o.float() - ref).abs()
                      / (TOL["bfloat16"] * (1 + ref.abs()))).max())

    assert share("bf16") > 1
    assert share("tf32") > 1
    assert share("split") < 0.5
    o, S = _gla_chunked_rounded(r, k, v, w, u, 64, "split")
    np.testing.assert_allclose(S.numpy(), rS.numpy(), rtol=2e-2, atol=2e-2)
