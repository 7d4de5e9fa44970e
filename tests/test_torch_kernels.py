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
from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import _pad_to, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from test_torch_cuda import (FLASH_CASES, FLASH_DV_CASES, FLASH_EDGE_CASES,
                             PAGED_CASES, flash_case)

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
@pytest.mark.parametrize("case", FLASH_CASES + FLASH_EDGE_CASES +
                         FLASH_DV_CASES)
def test_flash_plain_paths_match_jax(case, dtype):
    """Held to the reference's ``attention_ref`` and its Pallas kernel
    (interpreted); where v's head dim Dv differs from D (MLA), to its
    ``"xla"`` path instead, the one route of the reference that takes
    Dv != D (its Pallas kernel sizes v and the output by q's D)."""
    B, H, KH, Tq, Tk, D, causal, window, q_offset, q_scale, Dv = \
        flash_case(case)
    blk = 32 if case in FLASH_CASES + FLASH_DV_CASES else 64   # fewer
    # interpreted grid steps
    rng = np.random.default_rng(42)
    jq, q = _both(rng.normal(size=(B, H, Tq, D)) * q_scale, dtype)
    jk, k = _both(rng.normal(size=(B, KH, Tk, D)), dtype)
    jv, v = _both(rng.normal(size=(B, KH, Tk, Dv)), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref = jax_attention_ref(jq, jk, jv, **kw)
    jker = jax_flash(jq, jk, jv, impl="kernel" if Dv == D else "xla",
                     block_q=blk, block_k=blk, **kw)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(jker), _np(ref), **tol)
    outs = {
        "naive": flash_attention(q, k, v, impl="naive", **kw),
        "xla": flash_attention(q, k, v, impl="xla", block_k=blk, **kw),
        "kernel": flash_attention(q, k, v, impl="kernel", block_q=blk,
                                  block_k=blk, **kw),
    }
    for impl, out in outs.items():
        assert out.dtype == q.dtype and out.shape == (B, H, Tq, Dv), impl
        np.testing.assert_allclose(_np(out), _np(ref), err_msg=impl, **tol)
        np.testing.assert_allclose(_np(out), _np(jker), err_msg=impl, **tol)


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 96, "wgmma"),
    (torch.bfloat16, 36, "scalar"), (torch.bfloat16, 255, "scalar"),
    (torch.float32, 128, "scalar"), (torch.float32, 256, "scalar"),
    (torch.float32, 36, "scalar")])
def test_flash_kernel_route(dtype, head_dim, route):
    """bf16 with D % 8 == 0 takes the tensor-core kernel; fp32 (whose 3e-5
    tolerance rules out TF32) or D % 8 != 0 (TMA's 16-byte strides) the
    scalar one. The choice reads dtype and shape only."""
    assert flash_kernel.kernel_route(dtype, head_dim) == route
    assert route in flash_kernel.ROUTES


@pytest.mark.parametrize("dtype,head_dim,v_head_dim,route", [
    (torch.bfloat16, 192, 128, "wgmma"), (torch.bfloat16, 24, 16, "wgmma"),
    (torch.bfloat16, 16, 24, "wgmma"), (torch.bfloat16, 24, 12, "scalar"),
    (torch.bfloat16, 36, 16, "scalar"), (torch.float32, 192, 128, "scalar")])
def test_flash_kernel_route_reads_both_head_dims(dtype, head_dim, v_head_dim,
                                                 route):
    """With v's head dim unlike q's (MLA), the wgmma route needs both to be
    multiples of 8: V and the output go through TMA as well."""
    assert flash_kernel.kernel_route(dtype, head_dim, v_head_dim) == route


def test_flash_kernel_plain_version_counts_no_launch():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8, 16))).float()
    kv = torch.from_numpy(rng.normal(size=(1, 2, 8, 16))).float()
    before = flash_attention.launches
    flash_attention(q, kv, kv, impl="kernel")
    assert flash_attention.launches == before


def test_flash_padding_rows_and_keys_are_masked():
    """``_pad_to`` pads with zeros up to the block multiples (the "xla"
    path pads k/v so); the kernel route takes the tensors unpadded, and on
    the CPU ``impl="kernel"`` over shapes off the blocks is the oracle. That
    the kernels mask rows and keys past Tq and Tk is held on the card
    (tests/test_torch_cuda.py, Tq=40, Tk=72 and FLASH_EDGE_CASES)."""
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


def test_flash_rows_with_no_live_key_in_a_live_block_documented_disagreement():
    """Causal, q_offset = -4, one block of 8 queries and 8 keys: rows 0-3
    have no live key, but the block is not skipped (rows 4-7 attend). The
    reference's Pallas kernel and its "xla" path (``_chunked_attention``)
    do not zero masked probabilities, so such a row gets exp(-1e30 - (-1e30))
    = 1 for every visited key: the mean of V; the port's "xla" path mirrors
    them. The reference's ``attention_ref``, the port's "kernel" (on the
    CPU its plain version, ``attention_ref``; both CUDA routes zero masked
    probabilities) and "naive" give 0. Rows with a live key agree."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(1, 1, 8, 8)) for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "float32") for a in (q, k, v))
    kw = dict(causal=True, q_offset=-4, block_q=8, block_k=8)
    mean_v = _np(tv).mean(axis=2)[0, 0]
    means = {
        "jax kernel": _np(jax_flash(jq, jk, jv, impl="kernel", **kw)),
        "jax xla": _np(jax_flash(jq, jk, jv, impl="xla", **kw)),
        "port xla": _np(flash_attention(tq, tk, tv, impl="xla", **kw)),
    }
    zeros = {
        "jax attention_ref": _np(jax_attention_ref(jq, jk, jv, causal=True,
                                                   q_offset=-4)),
        "port kernel": _np(flash_attention(tq, tk, tv, impl="kernel", **kw)),
        "port naive": _np(flash_attention(tq, tk, tv, impl="naive", **kw)),
    }
    for name, out in means.items():
        np.testing.assert_allclose(out[0, 0, :4], np.tile(mean_v, (4, 1)),
                                   rtol=3e-5, atol=3e-5, err_msg=name)
    for name, out in zeros.items():
        assert np.array_equal(out[0, 0, :4], np.zeros((4, 8))), name
    live = zeros["jax attention_ref"][0, 0, 4:]
    for name, out in {**means, **zeros}.items():
        np.testing.assert_allclose(out[0, 0, 4:], live, rtol=3e-5, atol=3e-5,
                                   err_msg=name)


@pytest.mark.parametrize("bad", ["device", "dtype", "contiguity", "dv",
                                 "head_dim", "alignment"])
def test_flash_kernel_raises_on_what_it_does_not_take(bad):
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 1, 8, 16)
    v = torch.zeros(1, 1, 8, 16)
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "contiguity":
        q = torch.zeros(1, 8, 2, 16).transpose(1, 2)
    elif bad == "dv":
        # v's head dim may differ from k's (MLA: 192 and 128), up to 256,
        # but v must have k's keys
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
            flash_kernel.check_kernel_inputs(q, k, torch.zeros(1, 1, 8, 256))
            with pytest.raises(ValueError):
                flash_kernel.check_kernel_inputs(q, k,
                                                 torch.zeros(1, 1, 9, 16))
        v = torch.zeros(1, 1, 8, 264)
    elif bad == "alignment":
        # the wgmma route's TMA reads need 16-byte aligned starts
        q = torch.zeros(1 * 2 * 8 * 16 + 1, dtype=torch.bfloat16)[1:].view(
            1, 2, 8, 16)
        k, v = k.bfloat16(), v.bfloat16()
        assert q.is_contiguous() and q.data_ptr() % 16
    elif bad == "head_dim":
        # recurrentgemma's 256 is the widest head the kernel takes
        q, k, v = (torch.zeros(1, 2, 8, 512), torch.zeros(1, 1, 8, 512),
                   torch.zeros(1, 1, 8, 512))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
            flash_kernel.check_kernel_inputs(*(t[..., :256].contiguous()
                                               for t in (q, k, v)))
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
@pytest.mark.parametrize("case", PAGED_CASES + [
    (2, 32, 2, 32, 16, 8, 4)])                  # glm4-9b's group: G = 16
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
                                 "group_width", "group_17", "head_dim",
                                 "bf16_row", "float64", "float16"])
def test_paged_kernel_raises_on_what_it_does_not_take(bad):
    q = torch.zeros(2, 4, 16)
    kv = torch.zeros(4, 8, 2, 2, 16)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    ln = torch.ones(2, dtype=torch.int32)
    if bad == "dtype_mix":
        kv = kv.bfloat16()
    elif bad == "index_dtype":
        bt = bt.long()
    elif bad == "group_width":                  # G = 64, past G_MAX = 16
        q, kv = torch.zeros(2, 64, 128), torch.zeros(4, 8, 2, 1, 128)
    elif bad == "group_17":
        q, kv = torch.zeros(2, 17, 64), torch.zeros(4, 8, 2, 1, 64)
    elif bad == "head_dim":                     # D past D_MAX = 256, G = 1
        q, kv = torch.zeros(2, 2, 264), torch.zeros(4, 8, 2, 2, 264)
    elif bad == "bf16_row":                     # 8-byte bf16 rows
        q, kv = torch.zeros(2, 2, 4).bfloat16(), \
            torch.zeros(4, 4, 2, 2, 4).bfloat16()
    elif bad in ("float64", "float16"):
        q, kv = q.to(getattr(torch, bad)), kv.to(getattr(torch, bad))
    if bad == "device":
        with pytest.raises(ValueError, match="not a CUDA device"):
            paged_kernel.paged_attention_kernel(q, kv, bt, ln)
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        with pytest.raises((ValueError, TypeError)) as err:
            paged_kernel.check_kernel_inputs(q, kv, bt, ln)
    if bad in ("float64", "float16"):
        assert "(float32, bfloat16)" in str(err.value)


@pytest.mark.parametrize("B,KH,max_pages", [(4, 8, 9), (1, 1, 200), (64, 8, 3),
                                            (2, 2, 0), (3, 1, 6)])
def test_paged_split_plan_covers_the_table(B, KH, max_pages):
    """A cluster of ``splits`` blocks divides a sequence's live chunks of
    keys evenly: the widest table's chunks all have a block, and none of its
    blocks is left without one."""
    def capacity(s):                  # the H100's 132 SMs, 2 blocks each
        return 264 - 264 % s

    for elem in (4, 2):
        splits, per = paged_kernel.split_plan(B, KH, max_pages, 64, elem,
                                              capacity)
        chunks = -(-max_pages * 64 // paged_kernel.CHUNK[elem])
        assert 1 <= splits <= paged_kernel.SPLITS_MAX and per >= 1
        assert splits * per >= chunks             # every chunk has a block
        assert splits <= max(chunks, 1)           # no block is empty
        if B * KH * 2 <= capacity(1):
            assert B * KH * splits <= capacity(splits)    # one wave
        if (B, KH, max_pages, elem) == (4, 8, 9, 4):
            assert (splits, per) == (6, 3)        # the slice: 18 chunks


def test_paged_kernel_takes_every_served_group():
    """The groups of the JAX package's configs (qwen3 2, grok 6, glm4 16 at
    D = 128; recurrentgemma 16 at D = 256) and ServingTier's default fp32
    pool (G = 1, D = 4, page 4) pass the checks in both types where the rows
    are whole 16-byte pieces; the parent kernel refused G * D > 1024. (The
    shared memory each takes is the library's count, checked on the card:
    tests/test_torch_cuda.py test_paged_smem_fits_the_card.)"""
    cases = [(16, 8, 128, 64), (48, 8, 128, 64), (32, 2, 128, 64),
             (16, 1, 256, 64), (2, 2, 4, 4)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        for H, KH, D, page in cases:
            for dtype in (torch.float32, torch.bfloat16):
                if D * (4 if dtype == torch.float32 else 2) % 16:
                    continue
                paged_kernel.check_kernel_inputs(
                    torch.zeros(2, H, D, dtype=dtype),
                    torch.zeros(3, page, 2, KH, D, dtype=dtype),
                    torch.zeros(2, 3, dtype=torch.int32),
                    torch.ones(2, dtype=torch.int32))


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
    for sig in (flash_kernel._SIGNATURES, paged_kernel._SIGNATURES,
                adamw_kernel._SIGNATURES):
        for argtypes, restype in sig.values():
            assert restype is ctypes.c_int
            assert ctypes.c_void_p in argtypes
