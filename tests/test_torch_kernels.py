"""The port's attention kernels against the JAX package's.

On the CPU the port's ``impl="kernel"`` takes its plain version; the JAX
kernels run as the JAX package's own tests run them (Pallas
``interpret=True``). Inputs come from one numpy seed and go through both
packages. Tolerances are the reference's: 3e-5 in fp32, 2e-2 in
bf16. The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py, which imports no jax.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as jax_paged_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import _pad_to, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from test_torch_cuda import FLASH_CASES, PAGED_CASES

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype_name):
    t = 2e-2 if dtype_name == "bfloat16" else 3e-5
    return dict(rtol=t, atol=t)


def _both(a, dtype_name):
    """The same values as a jnp array and a torch CPU tensor of one dtype."""
    jd, td = DTYPES[dtype_name]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- flash attention --------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_paths_match_jax(case, dtype):
    B, H, KH, Tq, Tk, D, causal, window = case
    rng = np.random.default_rng(42)
    jq, q = _both(rng.normal(size=(B, H, Tq, D)), dtype)
    jk, k = _both(rng.normal(size=(B, KH, Tk, D)), dtype)
    jv, v = _both(rng.normal(size=(B, KH, Tk, D)), dtype)
    ref = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    jker = jax_flash(jq, jk, jv, causal=causal, window=window, impl="kernel",
                     block_q=32, block_k=32)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(jker), _np(ref), **tol)
    outs = {
        "naive": flash_attention(q, k, v, causal=causal, window=window,
                                 impl="naive"),
        "xla": flash_attention(q, k, v, causal=causal, window=window,
                               impl="xla", block_k=32),
        "kernel": flash_attention(q, k, v, causal=causal, window=window,
                                  impl="kernel", block_q=32, block_k=32),
    }
    for impl, out in outs.items():
        assert out.dtype == q.dtype and out.shape == q.shape, impl
        np.testing.assert_allclose(_np(out), _np(ref), err_msg=impl, **tol)
        np.testing.assert_allclose(_np(out), _np(jker), err_msg=impl, **tol)


def test_flash_kernel_plain_version_counts_no_launch():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8, 16))).float()
    kv = torch.from_numpy(rng.normal(size=(1, 2, 8, 16))).float()
    before = flash_attention.launches
    flash_attention(q, kv, kv, impl="kernel")
    assert flash_attention.launches == before


def test_flash_padding_rows_and_keys_are_masked():
    """The wrapper pads q rows and k/v keys with zeros up to the block
    multiples and cuts the output back to Tq; on the CPU ``impl="kernel"``
    over such shapes is the oracle. That the kernel gives padded keys no
    weight is held on the card (tests/test_torch_cuda.py, Tq=40, Tk=72)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 2, 40, 16))).float()
    k = torch.from_numpy(rng.normal(size=(1, 1, 72, 16))).float()
    v = torch.from_numpy(rng.normal(size=(1, 1, 72, 16))).float()
    qp, kp = _pad_to(q, 2, 32), _pad_to(k, 2, 32)
    assert qp.shape[2] == 64 and kp.shape[2] == 96
    assert torch.equal(qp[:, :, :40], q) and not qp[:, :, 40:].any()
    assert torch.equal(kp[:, :, :72], k) and not kp[:, :, 72:].any()
    for causal in (True, False):
        out = flash_attention(q, k, v, causal=causal, impl="kernel",
                              block_q=32, block_k=32)
        assert out.shape == q.shape
        ref = attention_ref(q, k, v, causal=causal)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=3e-5,
                                   atol=3e-5)


def test_flash_fully_masked_rows_give_zero():
    """A row with no live key gives 0 through the wrapper's CPU path and the
    oracle (the kernel zeroes masked probabilities rather than relying on a
    later block's correction)."""
    q = torch.ones(1, 1, 4, 8)
    k = torch.ones(1, 1, 4, 8)
    v = torch.ones(1, 1, 4, 8)
    out = flash_attention(q, k, v, causal=True, q_offset=-8, impl="kernel")
    assert torch.equal(out, torch.zeros_like(out))
    ref = attention_ref(q, k, v, causal=True, q_offset=-8)
    assert torch.equal(ref, torch.zeros_like(ref))


@pytest.mark.parametrize("bad", ["device", "dtype", "contiguity", "dv",
                                 "head_dim"])
def test_flash_kernel_raises_on_what_it_does_not_take(bad):
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 1, 8, 16)
    v = torch.zeros(1, 1, 8, 16)
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "contiguity":
        q = torch.zeros(1, 8, 2, 16).transpose(1, 2)
    elif bad == "dv":
        v = torch.zeros(1, 1, 8, 32)
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 2, 8, 256), torch.zeros(1, 1, 8, 256),
                   torch.zeros(1, 1, 8, 256))
    if bad != "device":
        # checks past the device one: pretend the tensors are on the card
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
            with pytest.raises((ValueError, TypeError)):
                flash_kernel.check_kernel_inputs(q, k, v)
    else:
        with pytest.raises(ValueError, match="not a CUDA device"):
            flash_kernel.flash_attention_kernel(q, k, v)


# -- paged attention --------------------------------------------------------------
def _paged_inputs(case, dtype, seed):
    B, H, KH, D, P, page, maxp = case
    rng = np.random.default_rng(seed)
    jq, q = _both(rng.normal(size=(B, H, D)), dtype)
    jkv, kv = _both(rng.normal(size=(P, page, 2, KH, D)), dtype)
    bts, lens = [], []
    for _ in range(B):
        n = rng.integers(1, maxp + 1)
        bt = np.full(maxp, -1, np.int32)
        bt[:n] = rng.choice(P, size=n, replace=False)
        bts.append(bt)
        lens.append(rng.integers((n - 1) * page + 1, n * page + 1))
    return jq, q, jkv, kv, np.stack(bts), np.asarray(lens, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_paths_match_jax(case, dtype):
    jq, q, jkv, kv, bt, ln = _paged_inputs(case, dtype, seed=42)
    ref = jax_paged_ref(jq, jkv, jnp.asarray(bt), jnp.asarray(ln))
    jker = jax_paged(jq, jkv, jnp.asarray(bt), jnp.asarray(ln), impl="kernel")
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(jker), _np(ref), **tol)
    for impl in ("xla", "kernel"):
        out = paged_attention(q, kv, bt, ln, impl=impl)
        assert out.dtype == q.dtype and out.shape == q.shape
        np.testing.assert_allclose(_np(out), _np(ref), err_msg=impl, **tol)
        np.testing.assert_allclose(_np(out), _np(jker), err_msg=impl, **tol)


def test_paged_length_zero_documented_disagreement():
    """At length 0 the JAX kernel gives 0 and its ref a mean over page 0;
    the port's plain version mirrors the ref."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 2, 8)).astype(np.float32)
    kv = rng.normal(size=(2, 4, 2, 2, 8)).astype(np.float32)
    bt = np.array([[0, -1]], np.int32)
    ln = np.array([0], np.int32)
    jref = jax_paged_ref(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(bt),
                         jnp.asarray(ln))
    jker = jax_paged(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(bt),
                     jnp.asarray(ln), impl="kernel")
    assert np.allclose(np.asarray(jker), 0.0)
    assert not np.allclose(np.asarray(jref), 0.0)
    out = paged_attention_ref(torch.from_numpy(q), torch.from_numpy(kv),
                              torch.from_numpy(bt), torch.from_numpy(ln))
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("bad", ["device", "dtype_mix", "index_dtype",
                                 "group_width"])
def test_paged_kernel_raises_on_what_it_does_not_take(bad):
    q = torch.zeros(2, 4, 16)
    kv = torch.zeros(4, 8, 2, 2, 16)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    ln = torch.ones(2, dtype=torch.int32)
    if bad == "dtype_mix":
        kv = kv.bfloat16()
    elif bad == "index_dtype":
        bt = bt.long()
    elif bad == "group_width":
        q, kv = torch.zeros(2, 64, 128), torch.zeros(4, 8, 2, 1, 128)
    if bad == "device":
        with pytest.raises(ValueError, match="not a CUDA device"):
            paged_kernel.paged_attention_kernel(q, kv, bt, ln)
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        with pytest.raises((ValueError, TypeError)):
            paged_kernel.check_kernel_inputs(q, kv, bt, ln)


@pytest.mark.parametrize("B,KH,max_pages", [(4, 8, 9), (1, 1, 200), (64, 8, 3),
                                            (2, 2, 0), (3, 1, 6)])
def test_paged_split_plan_covers_the_table(B, KH, max_pages):
    splits, per = paged_kernel.split_plan(B, KH, max_pages, num_sms=132)
    assert 1 <= splits <= paged_kernel.SPLITS_MAX and per >= 1
    assert splits * per >= max_pages              # every entry has a split
    assert (splits - 1) * per < max(max_pages, 1)  # no split is empty
    if (B, KH, max_pages) == (4, 8, 9):
        assert (splits, per) == (9, 1)            # the slice: a page a block


# -- build ---------------------------------------------------------------------------
def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    a = _build._lib_path("flash_attention")
    assert a.parent == _build.BUILD_DIR and a == _build._lib_path(
        "flash_attention")
    assert a != _build._lib_path("paged_attention")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
    # no nvcc anywhere: building raises instead of skipping a kernel
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError):
        _build.build()


def test_pointer_arguments_are_void_p():
    for sig in (flash_kernel._SIGNATURES, paged_kernel._SIGNATURES):
        for argtypes, restype in sig.values():
            assert restype is ctypes.c_int
            assert ctypes.c_void_p in argtypes
