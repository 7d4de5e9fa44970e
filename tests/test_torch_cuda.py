"""The port's CUDA kernels and its serving path on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA GPU.
The file imports no jax and nothing of the JAX package's models, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs at
the JAX package's tolerances (3e-5 fp32, 2e-2 bf16, 2e-5 over an fp32
pool and 2e-2 over a bf16 one, 2e-4
for the GLA scan in fp32, 1e-5 for the MoE shuffle kernels in fp32).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import PagedKVCache
from repro_torch.kernels import _build
from repro_torch.kernels.adamw.ops import adamw
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_kernel, kernel_route, wgmma_tiles)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.linear_scan import kernel as scan_kernel
from repro_torch.kernels.linear_scan.ops import diag_scan, gla_scan
from repro_torch.kernels.linear_scan.ref import (diag_scan_bwd_ref,
                                                 diag_scan_ref, gla_scan_ref)
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.shuffle_dispatch import kernel as shuffle_kernel
from repro_torch.kernels.shuffle_dispatch.ops import (combine, compute_slots,
                                                      dispatch)
from repro_torch.kernels.shuffle_dispatch.ref import (combine_bwd_ref,
                                                      dispatch_bwd_ref)
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models import blocks
from repro_torch.models.lm import tree_map
from repro_torch.models.model import build_model
from repro_torch.models.moe_shardmap import moe_shardmap_apply
from repro_torch.optim import (AdamWState, adamw_apply, adamw_update,
                               make_train_state, make_train_step)

torch.set_num_threads(2)

# the JAX package's kernel test cases (tests/test_kernels.py)
FLASH_CASES = [
    # B, H, KH, Tq, Tk, D, causal, window
    (1, 4, 2, 64, 64, 32, True, None),
    (2, 4, 4, 40, 72, 16, True, None),
    (1, 2, 1, 64, 64, 32, False, None),
    (1, 2, 2, 96, 96, 32, True, 32),
    (1, 8, 4, 128, 128, 64, True, None),
]
# edges of the flash kernels' tiling and masks (the wgmma route's tiles are
# 128 query rows by 128 keys, 80 keys at D = 256; the scalar route's 64 x
# 64), small enough for the JAX package's interpreted Pallas kernel
FLASH_EDGE_CASES = [
    # B, H, KH, Tq, Tk, D, causal, window, q_offset, q scale
    (1, 4, 2, 100, 260, 64, True, None, 160, 1.0),   # continued prefill
    (2, 6, 1, 200, 200, 96, True, None, 0, 1.0),     # T, D off the tiles; G = 6
    (1, 4, 4, 300, 300, 128, True, 200, 0, 1.0),     # window no multiple of BK
    (1, 2, 1, 257, 257, 256, True, 40, 0, 1.0),      # window shorter than BK:
    # rows from 167 on find their first visited key tile fully masked
    (1, 16, 1, 130, 130, 128, True, None, 0, 1.0),   # G = 16
    (1, 4, 2, 192, 192, 64, True, None, 0, 8.0),     # peaked scores
    (1, 2, 2, 70, 300, 128, False, None, 0, 1.0),    # not causal, Tq < Tk
    (1, 4, 1, 64, 300, 256, True, 100, 236, 1.0),    # continued, in a window
    (1, 2, 1, 90, 90, 36, True, None, 0, 1.0),       # D % 8 != 0: scalar route
]
# v's head dim Dv unlike q's and k's D (MLA): smoke deepseek-v2-lite-16b's
# heads (D = 24 = 16 nope + 8 rope, Dv = 16) and its full ones (192, 128),
# with GQA, causal and not; Dv over D; a V/O tile of 256 beside a q/K tile
# of 64; D % 8 != 0 with Dv % 8 == 0 (the scalar route)
FLASH_DV_CASES = [
    # B, H, KH, Tq, Tk, D, causal, window, q_offset, q scale, Dv
    (2, 4, 2, 40, 72, 24, True, None, 0, 1.0, 16),
    (1, 4, 4, 64, 64, 24, False, None, 0, 1.0, 16),
    (1, 4, 2, 150, 150, 192, True, None, 0, 1.0, 128),
    (1, 2, 2, 130, 200, 192, False, None, 0, 1.0, 128),
    (1, 2, 1, 70, 90, 16, True, None, 20, 1.0, 24),
    (1, 2, 1, 100, 100, 64, True, 40, 0, 1.0, 256),
    (1, 2, 2, 50, 50, 36, True, None, 0, 1.0, 16),
]
PAGED_CASES = [
    # B, H, KH, D, P, page, max_pages
    (2, 4, 2, 32, 16, 8, 4),
    (1, 8, 8, 16, 8, 16, 3),
    (3, 4, 1, 64, 32, 8, 6),
]
# the JAX package's test_gla_scan_sweep cases and more (chip_smoke.py's
# GLA_CASES says why each)
GLA_CASES = [
    # B, T, Dk, Dv, chunk, w0
    (2, 32, 16, 16, 16, 0.0),
    (1, 64, 32, 16, 16, 0.0),
    (2, 48, 8, 24, 16, 0.0),
    (2, 50, 8, 24, 16, 0.0),
    (1, 37, 80, 80, 64, -2.0),
    (1, 100, 80, 80, 64, -2.0),
    (3, 45, 10, 6, 16, 0.0),        # widths that are not whole 16-byte rows
    (2, 130, 128, 128, 64, -2.0),   # the kernel's widest head
]
# the JAX package's test_diag_scan_sweep cases, recurrentgemma-9b's served
# prefill (B = 4, T = 2100, D = 4096) and decode (T = 1), and a width that is
# not a whole number of channel pairs. a = sigmoid(N(0, 1)) as the reference's
# tests draw it, or near 1 (exp(-U(0, 0.02)), as RG-LRU's a is where its gate
# is small): at the served T only then does the carry survive the product of
# a's over hundreds of steps and decide the output
DIAG_CASES = [
    # B, T, D, chunk, a near 1
    (2, 64, 16, 16, False),
    (1, 100, 8, 32, False),
    (3, 32, 32, 32, False),
    (4, 2100, 4096, 256, False),
    (4, 1, 4096, 256, False),
    (2, 77, 33, 16, False),
    (4, 2100, 4096, 256, True),
]
# the JAX package's test_shuffle_dispatch_sweep cases (T, D, E, K, C), a
# width that is not whole 16-byte rows, and grok-1-314b's served prefill and
# decode (4 rows x 8 experts = 32 buffers, top-2, C = 160 and 4, D = 6144)
SHUFFLE_CASES = [
    (64, 32, 4, 2, 32),
    (128, 16, 8, 1, 24),
    (96, 64, 16, 6, 16),
    (50, 37, 5, 3, 12),
    (2048, 6144, 32, 2, 160),
    (4, 6144, 32, 2, 4),
]
SHUFFLE_KINDS = ("slots", "drops", "repeats")
SHUFFLE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # the reference's MoE
# dispatch's walk route lists at most 1024 hits a block (HIT_CAP in
# csrc/shuffle_dispatch.cu; its blocks own 16 rows): "one row" sends all N
# tokens' K pairs to (e = 0, c = 0); "spread" draws every pair's expert and
# slot at random over a few rows, so that each block's rows collect several
# times the list, over the whole token range
OVERFLOW_CASES = [
    # kind, T, D, E, K, C
    ("one row", 4096, 64, 4, 2, 8),
    ("spread", 3001, 40, 3, 3, 8),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def shuffle_inputs(rng, T, D, E, K, C, kind):
    """x [T, D], y [E, C, D] and gates [T, K] (float64), expert ids and
    slots [T, K] (int32), as numpy. ``kind``: "slots" (K distinct experts a
    token, slots the exclusive count of earlier pairs per expert, as
    ``compute_slots`` gives them, some past C), "drops" (as "slots", then
    ids of -1 and E and slots of -1 and C + 3 here and there) or "repeats"
    (ids and slots drawn at random, so that pairs share rows and add up)."""
    x = rng.normal(size=(T, D))
    y = rng.normal(size=(E, C, D))
    gates = rng.random(size=(T, K))
    if kind == "repeats":
        eid = rng.integers(0, E, size=(T, K))
        slot = rng.integers(0, C, size=(T, K))
    else:
        eid = np.argsort(rng.random((T, E)), axis=1)[:, :K]
        count = np.zeros(E, np.int64)
        slot = np.zeros_like(eid)
        for t in range(T):
            for k in range(K):
                slot[t, k] = count[eid[t, k]]
                count[eid[t, k]] += 1
        if kind == "drops":
            u = rng.random(size=(T, K))
            eid = np.where(u < 0.1, -1, np.where(u < 0.15, E, eid))
            v = rng.random(size=(T, K))
            slot = np.where(v < 0.05, -1, np.where(v < 0.1, C + 3, slot))
    return x, y, gates, eid.astype(np.int32), slot.astype(np.int32)


def _tol(dtype_name):
    t = 2e-2 if dtype_name == "bfloat16" else 3e-5
    return dict(rtol=t, atol=t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _close(out, ref, **tol):
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)


def flash_case(case):
    """A FLASH_CASES, FLASH_EDGE_CASES or FLASH_DV_CASES entry as (B, H, KH,
    Tq, Tk, D, causal, window, q_offset, q scale, Dv); Dv is D unless the
    entry names it."""
    case = tuple(case) + (0, 1.0)[len(case) - 8:]
    return case + (case[5],)[len(case) - 10:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES + [
    (4, 16, 8, 512, 512, 128, True, None),      # the served prefill
    (1, 4, 2, 300, 300, 128, True, 100),
    (1, 16, 1, 300, 300, 256, True, 128),       # recurrentgemma's heads
    (4, 16, 1, 2100, 2100, 256, True, 2048),    # and its served prefill
    (4, 48, 8, 512, 512, 128, True, None),      # grok-1-314b's prefill
    (4, 16, 16, 1024, 1024, 64, False, None),   # seamless's encoder
    (4, 64, 8, 512, 512, 128, True, None),      # qwen2-vl-72b's prefill
] + FLASH_EDGE_CASES + FLASH_DV_CASES + [
    (4, 16, 16, 512, 512, 192, True, None, 0, 1.0, 128),   # deepseek's
])
def test_flash_kernel_matches_plain(case, dtype, cuda_device):
    """Both routes: fp32 (and D or Dv % 8 != 0) on the scalar kernel, bf16
    on the wgmma kernel; each case asserts which route it took."""
    B, H, KH, Tq, Tk, D, causal, window, q_offset, q_scale, Dv = \
        flash_case(case)
    rng = np.random.default_rng(42)
    q, k, v = (torch.from_numpy(rng.normal(size=s)).to(cuda_device,
                                                      DTYPES[dtype])
               for s in ((B, H, Tq, D), (B, KH, Tk, D), (B, KH, Tk, Dv)))
    q = q * q_scale
    route = kernel_route(DTYPES[dtype], D, Dv)
    assert route == ("wgmma" if dtype == "bfloat16" and D % 8 == 0
                     and Dv % 8 == 0 else "scalar")
    if route == "wgmma":
        tiles = wgmma_tiles(D, Dv)
        assert D <= tiles["head_dim_tile"] in (64, 128, 256)
        assert Dv <= tiles["v_head_dim_tile"] in (64, 128, 256)
        assert tiles["block_q"] == 128 and tiles["block_k"] in (80, 128)
    before = (flash_attention.launches,
              dict(flash_attention.launches_by_route))
    out = flash_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, impl="kernel", block_q=32,
                          block_k=32)
    torch.cuda.synchronize()
    assert flash_attention.launches == before[0] + 1
    assert flash_attention.launches_by_route[route] == before[1][route] + 1
    assert out.shape == (B, H, Tq, Dv)
    _close(out, attention_ref(q, k, v, causal=causal, window=window,
                              q_offset=q_offset), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_fully_masked_rows_give_zero(dtype, cuda_device):
    """A row with no live key gives 0 on both routes (q_offset -3: rows 0-2
    see no key under the causal mask; q_offset -8: no row sees one); the
    others match the plain version."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 8, 8))).to(
        cuda_device, DTYPES[dtype]) for _ in range(3))
    for q_offset, dead in ((-3, 3), (-8, 8)):
        before = flash_attention.launches_by_route[kernel_route(q.dtype, 8)]
        out = flash_attention(q, k, v, causal=True, q_offset=q_offset,
                              impl="kernel")
        torch.cuda.synchronize()
        assert flash_attention.launches_by_route[
            kernel_route(q.dtype, 8)] == before + 1
        assert not out[:, :, :dead].any()
        _close(out, attention_ref(q, k, v, causal=True, q_offset=q_offset),
               **_tol(dtype))


LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-3}       # relative
GRAD_TOL = {"float32": 3e-4, "bfloat16": 2e-2}
# the JAX package's attention-gradient case (tests/test_kernels.py), the
# masks of tests/test_torch_train.py's GRAD_CASES and the training shapes
# of qwen3-0.6b, seamless-m4t-large-v2's encoder and qwen2-vl-72b: B, H, KH,
# Tq, Tk, D, causal, window, q_offset, block_k; then MLA's
# heads (Dv unlike D), smoke and full: ..., block_k, Dv
FLASH_GRAD_CASES = [
    (1, 4, 2, 48, 48, 16, True, None, 0, 16),
    (2, 4, 1, 40, 72, 16, True, None, 32, 16),
    (1, 2, 2, 96, 96, 32, True, 32, 0, 32),
    (1, 4, 4, 33, 50, 8, False, None, 0, 16),
    (1, 8, 2, 20, 70, 16, True, 16, 50, 32),
    (8, 16, 8, 512, 512, 128, True, None, 0, 128),
    # seamless-m4t-large-v2's encoder and qwen2-vl-72b at their training
    # shapes
    (8, 16, 16, 512, 512, 64, False, None, 0, 128),
    (4, 64, 8, 512, 512, 128, True, None, 0, 128),
    (2, 4, 4, 40, 40, 24, True, None, 0, 16, 16),
    (1, 4, 2, 150, 150, 192, True, None, 0, 128, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES + FLASH_EDGE_CASES + [
    (8, 16, 8, 512, 512, 128, True, None),      # qwen3-0.6b's training shape
    (1, 2, 1, 8, 8, 8, True, None, -3, 1.0),    # rows with no live key
] + FLASH_DV_CASES)
def test_flash_kernel_lse_matches_plain(case, dtype, cuda_device):
    """Both routes write each row's lse: relative 1e-5 (fp32) and 1e-3
    (bf16) to the plain version, +inf on the same rows; the output keeps
    the bits of a launch without lse."""
    B, H, KH, Tq, Tk, D, causal, window, q_offset, q_scale, Dv = \
        flash_case(case)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=s)).to(cuda_device,
                                                      DTYPES[dtype])
               for s in ((B, H, Tq, D), (B, KH, Tk, D), (B, KH, Tk, Dv)))
    q = q * q_scale
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = flash_attention_kernel(q, k, v, return_lse=True, **kw)
    bare = flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, Tq) and lse.dtype == torch.float32
    assert torch.equal(out.view(torch.int16 if dtype == "bfloat16"
                                else torch.int32),
                       bare.view(torch.int16 if dtype == "bfloat16"
                                 else torch.int32))
    _, ref = attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(ref))
    fin = torch.isfinite(ref)
    rel = ((lse[fin] - ref[fin]).abs() / ref[fin].abs().clamp_min(1.0))
    assert float(rel.max()) <= LSE_TOL[dtype] if fin.any() else True


def _naive_fp64(q, k, v, causal, window, q_offset):
    H, KH, Tq, Tk = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    kr, vr = (t.repeat_interleave(H // KH, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, kr) * q.shape[-1] ** -0.5
    qp = torch.arange(Tq, device=q.device)[:, None] + q_offset
    kp = torch.arange(Tk, device=q.device)[None, :]
    live = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        live &= kp <= qp
    if window is not None:
        live &= kp > qp - window
    p = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_function_grads_on_the_card(case, dtype, cuda_device):
    """``_FlashAttention`` through the kernel forward (one launch, with lse)
    and the plain backward: dq, dk, dv against autograd of fp64 attention,
    3e-4 in fp32 and 2e-2 in bf16."""
    B, H, KH, Tq, Tk, D, causal, window, q_offset, bk, Dv = \
        tuple(case) + (case[5],)[len(case) - 10:]
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=s)).to(cuda_device,
                                                      DTYPES[dtype])
               for s in ((B, H, Tq, D), (B, KH, Tk, D), (B, KH, Tk, Dv)))
    w = torch.from_numpy(rng.normal(size=(B, H, Tq, Dv))).to(cuda_device)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (flash_attention.launches, flash_attention.lse_launches)
    out = flash_attention(*leaves, impl="kernel", block_k=bk, **kw)
    (out.double() * w).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.lse_launches) == \
        (before[0] + 1, before[1] + 1)
    ref = [t.double().requires_grad_(True) for t in (q, k, v)]
    (_naive_fp64(*ref, **kw) * w).sum().backward()
    tol = GRAD_TOL[dtype]
    for t, r in zip(leaves, ref):
        _close(t.grad, r.grad, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES + [
    (2, 4, 1, 128, 600, 16, 500),               # several pages per split
    (4, 16, 8, 128, 40, 64, 9)])                # qwen3 heads, page 64
def test_paged_kernel_matches_plain(case, dtype, cuda_device):
    B, H, KH, D, P, page, maxp = case
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(B, H, D))).to(cuda_device,
                                                        DTYPES[dtype])
    kv = torch.from_numpy(rng.normal(size=(P, page, 2, KH, D))).to(
        cuda_device, DTYPES[dtype])
    bt = np.full((B, maxp), -1, np.int32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(1, maxp + 1))
        bt[b, :n] = rng.choice(P, size=n, replace=False)
        lens[b] = rng.integers((n - 1) * page + 1, n * page + 1)
    before = paged_attention.launches
    routes = dict(paged_attention.launches_by_route)
    out = paged_attention(q, kv, bt, lens, impl="kernel")
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    route = paged_kernel.ROUTES[DTYPES[dtype]]
    assert paged_attention.launches_by_route[route] == routes[route] + 1
    assert out.dtype == DTYPES[dtype]
    _close(out, paged_attention(q, kv, bt, lens, impl="xla"), **_tol(dtype))


def _paged_dense_fp64(q, kv, bt, lens):
    """fp64 softmax attention of each sequence's q over its live keys, read
    from the pool through its table: [B, H, D]."""
    B, H, D = q.shape
    page, KH = kv.shape[1], kv.shape[3]
    out = torch.empty(B, H, D, dtype=torch.float64)
    for b in range(B):
        n = int(lens[b])
        rows = kv[torch.as_tensor(bt[b, :-(-n // page)]).long().to(kv.device)]
        rows = rows.double().cpu().reshape(-1, 2, KH, D)[:n]
        k = rows[:, 0].repeat_interleave(H // KH, dim=1)      # [n, H, D]
        v = rows[:, 1].repeat_interleave(H // KH, dim=1)
        p = torch.softmax(torch.einsum("hd,thd->ht", q[b].double().cpu(), k)
                          * D ** -0.5, dim=-1)
        out[b] = torch.einsum("ht,thd->hd", p, v)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # H, KH, D, P, page, lengths, table width
    (16, 8, 128, 40, 64, [552, 471, 300, 65], 9),       # qwen3, page 64
    (32, 2, 128, 40, 64, [552, 300, 65], 9),            # glm4's group
    (16, 1, 256, 40, 64, [470, 129], 8),                # recurrentgemma's
    (4, 2, 8, 40, 4, [9, 4, 17], 6),                    # D = 8, page 4
], ids=["qwen3", "glm4", "recurrentgemma", "D8-page4"])
def test_paged_bf16_route_against_fp64_dense(case, cuda_device):
    """The bf16 route (mma.sync) within 2e-2 of fp64 dense attention over
    the same rounded inputs, one launch on its route."""
    dtype = "bfloat16"
    H, KH, D, P, page, lengths, width = case
    rng = np.random.default_rng(28)
    B = len(lengths)
    q = torch.from_numpy(rng.normal(size=(B, H, D))).to(cuda_device,
                                                        DTYPES[dtype])
    kv = torch.from_numpy(rng.normal(size=(P, page, 2, KH, D))).to(
        cuda_device, DTYPES[dtype])
    bt = _paged_tables(rng, P, page, lengths, width)
    lens = np.asarray(lengths, np.int32)
    route = paged_kernel.ROUTES[DTYPES[dtype]]
    before = paged_attention.launches_by_route[route]
    out = paged_attention(q, kv, bt, lens, impl="kernel")
    torch.cuda.synchronize()
    assert paged_attention.launches_by_route[route] == before + 1
    _close(out, _paged_dense_fp64(q, kv, bt, lens), **_tol(dtype))


def _paged_tables(rng, P, page, lengths, width, shared=False):
    """Tables [B, width] of distinct random pages for each sequence's live
    pages and -1 after them; ``shared``: sequence 1 reads sequence 0's pages
    as its own first pages."""
    bt = np.full((len(lengths), width), -1, np.int32)
    for b, n in enumerate(lengths):
        bt[b, :-(-n // page)] = rng.choice(P, size=-(-n // page), replace=False)
    if shared:
        k = min(-(-lengths[0] // page), -(-lengths[1] // page))
        bt[1, :k] = bt[0, :k]
    return bt


# the served groups (G = H / KH, D) and the edges of the key loop; the
# copy engine (TMA) fills the ring except at D = 256 and at page 4, which
# take the kernel's cp.async route
PAGED_GEOMETRY_CASES = {
    # name: (H, KH, D, P, page, lengths, table width, shared pages)
    "glm4 G=16": (32, 2, 128, 40, 64, [552, 300, 65], 9, False),
    "recurrentgemma G=16 D=256": (16, 1, 256, 40, 64, [470, 129], 8, False),
    "ServingTier fp32 G=1 D=4 page 4": (2, 2, 4, 30, 4, [9, 4, 17], 6, False),
    "grok G=6": (48, 8, 128, 24, 64, [300, 64], 5, False),
    "long ragged, many splits": (16, 8, 128, 400, 16, [3000, 17, 1500, 800],
                                 188, False),
    "length 1 and page multiples": (4, 2, 64, 30, 16, [1, 16, 64, 128], 8,
                                    False),
    "-1 after live pages, shared pages": (8, 2, 32, 20, 8, [40, 23, 7], 9,
                                          True),
    "bf16 D % 16 == 8": (4, 1, 24, 12, 8, [30, 5], 4, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name, case in PAGED_GEOMETRY_CASES.items()
    for dtype in ("float32", "bfloat16")
    if dtype == "float32" or case[2] % 8 == 0])   # bf16 rows of 16-byte pieces
def test_paged_kernel_geometries(name, dtype, cuda_device):
    """Every query-head group the JAX package's configs give (up to G = 16,
    D = 256), ServingTier's default pool (fp32 only: a bf16 row of D = 4 is
    not whole 16-byte pieces, and the kernel raises there) and the key
    loop's edges, against the plain version at the reference's tolerances,
    one launch each."""
    H, KH, D, P, page, lengths, width, shared = PAGED_GEOMETRY_CASES[name]
    rng = np.random.default_rng(18)
    B = len(lengths)
    q = torch.from_numpy(rng.normal(size=(B, H, D))).to(cuda_device,
                                                        DTYPES[dtype])
    kv = torch.from_numpy(rng.normal(size=(P, page, 2, KH, D))).to(
        cuda_device, DTYPES[dtype])
    bt = _paged_tables(rng, P, page, lengths, width, shared)
    lens = np.asarray(lengths, np.int32)
    before = paged_attention.launches
    out = paged_attention(q, kv, bt, lens, impl="kernel")
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    _close(out, paged_attention(q, kv, bt, lens, impl="xla"), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_length_zero_gives_zero(dtype, cuda_device):
    """A sequence of length 0 gives 0 (the TPU kernel's answer); the others
    in the batch are unaffected."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(3, 16, 128))).to(cuda_device,
                                                           DTYPES[dtype])
    kv = torch.from_numpy(rng.normal(size=(12, 16, 2, 1, 128))).to(
        cuda_device, DTYPES[dtype])
    bt = _paged_tables(rng, 12, 16, [40, 1, 33], 3)
    lens = np.array([40, 0, 33], np.int32)
    out = paged_attention(q, kv, bt, lens, impl="kernel")
    torch.cuda.synchronize()
    assert not out[1].any()
    ref = paged_attention(q, kv, bt, lens, impl="xla")
    _close(out[[0, 2]], ref[[0, 2]], **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,D", [(2, 128), (6, 128), (16, 128), (16, 256),
                                 (1, 4), (16, 8)])
def test_paged_smem_fits_the_card(G, D, dtype, cuda_device):
    """The shared memory a block takes at each served group (the library's
    own count, the one its launch passes) fits the card's opt-in limit, and
    past the kernel's limits the library gives none."""
    props = torch.cuda.get_device_properties(cuda_device)
    n = paged_kernel.smem_bytes(DTYPES[dtype], G, D)
    assert 0 < n <= props.shared_memory_per_block_optin
    with pytest.raises(_build.KernelLaunchError, match="paged_attention_smem"):
        paged_kernel.smem_bytes(DTYPES[dtype], paged_kernel.G_MAX + 1, D)


@pytest.mark.cuda
def test_paged_kernel_is_one_device_kernel(cuda_device):
    """One wrapper call is exactly one device kernel: the splits merge
    inside it, with no combine kernel and no fill of a workspace."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(4, 16, 128))).to(
        cuda_device, torch.bfloat16)
    kv = torch.from_numpy(rng.normal(size=(40, 64, 2, 8, 128))).to(
        cuda_device, torch.bfloat16)
    bt = torch.as_tensor(_paged_tables(rng, 40, 64, [552, 471, 300, 65], 9),
                         device=cuda_device)
    lens = torch.tensor([552, 471, 300, 65], dtype=torch.int32,
                        device=cuda_device)
    paged_attention(q, kv, bt, lens, impl="kernel")     # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        paged_attention(q, kv, bt, lens, impl="kernel")
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.count for e in kernels) == 1, [(e.key, e.count)
                                                for e in kernels]
    assert "paged_attention_kernel" in kernels[0].key


@pytest.mark.cuda
def test_pool_evict_restore_then_paged_kernel(cuda_device):
    pool = PagedKVCache(num_layers=2, hbm_pages=6, page_size=16, kv_heads=2,
                        head_dim=32)
    assert pool.kv.device.type == "cuda"
    rng = np.random.default_rng(2)
    written = {}
    for seq in (0, 2, 1):
        pool.start_sequence(seq)
        pool.ensure_capacity(seq, 40)
        pool.advance(seq, 40)
        for k in range(3):
            slab = rng.standard_normal(pool.slab_shape).astype(np.float32)
            pool.write_page(seq, k, slab)
            written[(seq, k)] = slab
    assert pool.stats["offloads"] > 0
    pool.finish_sequence(2)
    tables = np.stack([pool.block_table(s, 3) for s in (0, 1)])
    assert pool.stats["fetches"] > 0
    for k in range(3):
        assert pool.read_page(0, k).tobytes() == written[(0, k)].tobytes()
    q = torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32)
                         ).to(cuda_device)
    lens = np.array([40, 40], np.int32)
    for layer in range(2):
        out = paged_attention(q, pool.kv[layer], tables, lens, impl="kernel")
        ref = paged_attention(q, pool.kv[layer], tables, lens, impl="xla")
        _close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_serve_loop_prefills_through_the_kernel(cuda_device):
    cfg = smoke_config("qwen3-0.6b")
    loop = ServeLoop(cfg, batch_slots=2, max_len=40, hbm_pages=4)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, 24, dtype=np.int32),
                    max_new_tokens=4) for i in range(4)]
    before = flash_attention.launches
    out = loop.run(reqs)
    assert flash_attention.launches - before == cfg.n_layers * 2
    assert all(len(v) == 4 for v in out.values())
    assert loop.stats["offloads"] > 0


@pytest.mark.cuda
def test_lm_kernel_path_matches_plain_path(cuda_device):
    cfg = smoke_config("glm4-9b").with_(compute_dtype="float32",
                                        kv_cache_dtype="float32")
    kern = build_model(cfg)
    plain = build_model(cfg, attn_impl="xla")
    params = kern.init(torch.Generator("cuda").manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 40)))
    lk, _ = kern.forward(params, {"tokens": toks})
    lp, _ = plain.forward(params, {"tokens": toks})
    _close(lk, lp, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", SHUFFLE_KINDS)
@pytest.mark.parametrize("case", SHUFFLE_CASES)
def test_shuffle_kernels_match_plain(case, kind, dtype, cuda_device):
    """dispatch and combine against the dense one-hot oracle, gates in fp32
    and in the data's dtype (the MoE block passes bf16 gates in bf16)."""
    T, D, E, K, C = case
    x, y, gates, eid, slot = shuffle_inputs(np.random.default_rng(T + D),
                                            T, D, E, K, C, kind)
    dt = DTYPES[dtype]
    x, y = (torch.from_numpy(a).to(cuda_device, dt) for a in (x, y))
    eid, slot = (torch.from_numpy(a).to(cuda_device) for a in (eid, slot))
    tol = dict(rtol=SHUFFLE_TOL[dtype], atol=SHUFFLE_TOL[dtype])
    route = shuffle_kernel.dispatch_route(T * K)
    before = dispatch.launches, dispatch.launches_by_route[route]
    out = dispatch(x, eid, slot, E, C, impl="kernel")
    torch.cuda.synchronize()
    assert (dispatch.launches, dispatch.launches_by_route[route]) == \
        (before[0] + 1, before[1] + 1) and out.dtype == dt
    assert route == ("direct" if T * K <= 64 else "walk")
    _close(out, dispatch(x, eid, slot, E, C, impl="xla"), **tol)
    for g_dt in {torch.float32, dt}:
        g = torch.from_numpy(gates).to(cuda_device, g_dt)
        before = combine.launches
        out = combine(y, eid, slot, g, T, impl="kernel")
        torch.cuda.synchronize()
        assert combine.launches == before + 1 and out.dtype == dt
        _close(out, combine(y, eid, slot, g, T, impl="xla"), **tol)


def _served_routing(rng, B, T, E, K, C, device):
    """grok-1-314b's routing as the MoE block hands it to the kernels: K
    distinct experts of E a token, row b's ids offset by b * E, slots from
    ``compute_slots`` over the B * E buffers (at most one pair a row)."""
    eid = np.argsort(rng.random((B, T, E)), axis=2)[..., :K]
    flat = torch.from_numpy(eid + E * np.arange(B)[:, None, None]).reshape(
        B * T, K).int()
    return flat.to(device), compute_slots(flat, B * E, C).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,C", [(512, 160), (1, 4)])
def test_served_dispatch_is_the_gather(T, C, dtype, cuda_device):
    """At grok-1-314b's served prefill and decode (4 rows x 8 experts,
    top-2, D = 6144) every kept pair has a row of its own, so dispatch is a
    gather: each kept token's x at its row, bit for bit, and 0.0 in every
    other row."""
    B, E, K, D = 4, 8, 2, 6144
    rng = np.random.default_rng(T)
    eid, slot = _served_routing(rng, B, T, E, K, C, cuda_device)
    x = torch.from_numpy(rng.normal(size=(B * T, D))).to(cuda_device,
                                                          DTYPES[dtype])
    route = shuffle_kernel.dispatch_route(eid.numel())
    before = dispatch.launches_by_route[route]
    out = dispatch(x, eid, slot, B * E, C, impl="kernel")
    torch.cuda.synchronize()
    assert dispatch.launches_by_route[route] == before + 1
    assert route == ("walk" if T > 1 else "direct")
    kept = (slot >= 0) & (slot < C)
    rows = (eid.long() * C + slot.long())[kept]
    assert torch.unique(rows).numel() == rows.numel()
    expect = torch.zeros((B * E * C, D), dtype=x.dtype, device=cuda_device)
    expect[rows] = x.index_select(0, torch.nonzero(kept)[:, 0])
    assert torch.equal(out.reshape(B * E * C, D), expect)


def _overflow_routing(rng, kind, T, E, K, C):
    if kind == "one row":
        return np.zeros((T, K), np.int32), np.zeros((T, K), np.int32)
    return (rng.integers(0, E, size=(T, K)).astype(np.int32),
            rng.integers(0, C, size=(T, K)).astype(np.int32))


def _in_token_order(x, eid, slot, E, C):
    """Each row's fp32 sum of x over its pairs taken one after another in
    pair (so token) order, as numpy's cumsum takes them, rounded to x's
    dtype: the sum as the kernel defines it, [E, C, D]."""
    xs = x.float().cpu().numpy()
    e, s = eid.reshape(-1), slot.reshape(-1)
    K = eid.shape[1]
    out = np.zeros((E * C, xs.shape[1]), np.float32)
    for row in np.unique(e * C + s):
        toks = np.nonzero(e * C + s == row)[0] // K
        out[row] = np.cumsum(xs[toks], axis=0, dtype=np.float32)[-1]
    return torch.from_numpy(out.reshape(E, C, -1)).to(x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", OVERFLOW_CASES, ids=lambda c: c[0])
def test_dispatch_hit_list_overflow(case, dtype, cuda_device):
    """Rows that collect more pairs than the walk's hit list holds: the sum
    keeps its token order across the list and the pairs found past it
    (bits equal a sequential fp32 sum), and it equals the plain version at
    the reference's tolerance. For the second check x holds small integers:
    every fp32 partial sum is then exact, so the plain version's other
    summation order gives the same value (with normal draws, thousands of
    terms in one row differ by more than 1e-5 between any two orders)."""
    kind, T, D, E, K, C = case
    rng = np.random.default_rng(T)
    eid, slot = _overflow_routing(rng, kind, T, E, K, C)
    assert shuffle_kernel.dispatch_route(T * K) == "walk"
    dt = DTYPES[dtype]
    eid, slot = (torch.from_numpy(a).to(cuda_device) for a in (eid, slot))
    x = torch.from_numpy(rng.normal(size=(T, D))).to(cuda_device, dt)
    before = dispatch.launches_by_route["walk"]
    out = dispatch(x, eid, slot, E, C, impl="kernel")
    torch.cuda.synchronize()
    assert dispatch.launches_by_route["walk"] == before + 1
    assert torch.equal(out.cpu(), _in_token_order(x, eid.cpu().numpy(),
                                                  slot.cpu().numpy(), E, C))
    xi = torch.from_numpy(rng.integers(-8, 9, size=(T, D))).to(cuda_device,
                                                                dt)
    tol = dict(rtol=SHUFFLE_TOL[dtype], atol=SHUFFLE_TOL[dtype])
    _close(dispatch(xi, eid, slot, E, C, impl="kernel"),
           dispatch(xi, eid, slot, E, C, impl="xla"), **tol)


@pytest.mark.cuda
def test_dispatch_route_matches_the_library(cuda_device):
    """The wrapper counts each launch under the route the library takes."""
    for pairs in (0, 1, 8, 63, 64, 65, 128, 4096, 2 ** 31 - 1):
        assert shuffle_kernel.dispatch_route_built(pairs) == \
            shuffle_kernel.dispatch_route(pairs)


@pytest.mark.cuda
def test_shuffle_round_trip_is_the_identity(cuda_device):
    """Mirror of test_dispatch_combine_roundtrip_identity: K = 1, no drops,
    gate 1: combine(dispatch(x)) is x."""
    T, D, E, C = 32, 8, 4, 32
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(T, D))).to(cuda_device,
                                                      torch.float32)
    eid = torch.from_numpy(rng.integers(0, E, size=(T, 1))).to(cuda_device)
    slot = compute_slots(eid, E, C)
    buf = dispatch(x, eid, slot, E, C, impl="kernel")
    back = combine(buf, eid, slot, torch.ones((T, 1), device=cuda_device), T,
                   impl="kernel")
    _close(back, x, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_moe_serve_loop_runs_the_shuffle_kernels(cuda_device):
    """Smoke grok-1-314b on the card: every MoE layer dispatches and
    combines through the kernels in prefill and in every decode step, and
    every attention layer's prefill goes through flash."""
    cfg = smoke_config("grok-1-314b")
    loop = ServeLoop(cfg, batch_slots=2, max_len=40, hbm_pages=4)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, 24, dtype=np.int32),
                    max_new_tokens=4) for i in range(4)]
    before = (dispatch.launches, combine.launches, flash_attention.launches)
    out = loop.run(reqs)
    steps = 2 * (1 + 4)                  # 2 batches: a prefill, 4 decodes
    assert dispatch.launches - before[0] == cfg.n_layers * steps
    assert combine.launches - before[1] == cfg.n_layers * steps
    assert flash_attention.launches - before[2] == cfg.n_layers * 2
    assert all(len(v) == 4 for v in out.values())


@pytest.mark.cuda
def test_moe_kernel_path_matches_plain_path(cuda_device):
    cfg = smoke_config("grok-1-314b").with_(compute_dtype="float32",
                                            kv_cache_dtype="float32",
                                            capacity_factor=1.0)
    kern = build_model(cfg)
    plain = build_model(cfg, attn_impl="xla", moe_impl="xla")
    params = kern.init(torch.Generator("cuda").manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 70)))
    (lk, ak), (lp, ap) = (m.forward(params, {"tokens": toks})
                          for m in (kern, plain))
    _close(lk, lp, rtol=1e-4, atol=1e-4)
    _close(ak, ap, rtol=1e-5, atol=1e-5)
    lk, ck = kern.prefill(params, {"tokens": toks}, max_len=80)
    lp, cp = plain.prefill(params, {"tokens": toks}, max_len=80)
    nxt = lk[:, -1].argmax(-1)[:, None]
    dk, _ = kern.decode_step(params, {"tokens": nxt}, ck, 70)
    dp, _ = plain.decode_step(params, {"tokens": nxt}, cp, 70)
    _close(dk, dp, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_moe_shardmap_runs_the_shuffle_kernels(cf, cuda_device):
    """The world-size-1 expert-parallel path (smoke grok with a shared
    expert, fp32) on the card launches dispatch and combine once each and
    equals its plain versions on the CPU; at capacity factor 1 the global
    capacity drops pairs."""
    cfg = smoke_config("grok-1-314b").with_(
        compute_dtype="float32", capacity_factor=cf, n_shared_experts=1)
    p = blocks.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    yp, ap = moe_shardmap_apply(p, x, cfg=cfg)
    before = (dispatch.launches, combine.launches)
    yk, ak = moe_shardmap_apply({k: (v.to(cuda_device) if torch.is_tensor(v)
                                     else {n: w.to(cuda_device)
                                           for n, w in v.items()})
                                 for k, v in p.items()},
                                x.to(cuda_device), cfg=cfg)
    torch.cuda.synchronize()
    assert (dispatch.launches, combine.launches) == (before[0] + 1,
                                                    before[1] + 1)
    _close(yk, yp, rtol=1e-5, atol=1e-5)
    _close(ak, ap, rtol=1e-5, atol=1e-5)


# the MoE training path: deepseek-v2-lite-16b's batch of 8 x 512 tokens,
# top-6 of 64 experts a row (512 buffers of C = 60), D = 2048
MOE_TRAIN_SHAPE = (8, 512, 64, 6, 60, 2048)     # B, T, E, K, C, D


def _shuffle_counts():
    return (dispatch.launches, dispatch.launches_by_route["walk"],
            combine.launches, dispatch.bwd_launches, combine.bwd_launches,
            dispatch.bwd_calls, combine.bwd_calls)


def _shuffle_grads(x, y, gates, eid, slot, E, C, wd, wc):
    """Leaves of x, y, gates through ``_Dispatch`` and ``_Combine`` on the
    kernels, the gradients of sum(buf wd) + sum(out wc), and the plain
    backwards' on the same cotangents. Checks one forward and one backward
    launch each, the backward as the other kernel."""
    leaves = [t.clone().requires_grad_(True) for t in (x, y, gates)]
    before = _shuffle_counts()
    buf = dispatch(leaves[0], eid, slot, E, C, impl="kernel")
    out = combine(leaves[1], eid, slot, leaves[2], x.shape[0], impl="kernel")
    torch.autograd.backward([buf, out], [wd, wc])
    torch.cuda.synchronize()
    # combine's backward dispatches N * K rows of one pair: the same route
    walk = 2 * int(shuffle_kernel.dispatch_route(eid.numel()) == "walk")
    assert [a - b for a, b in zip(_shuffle_counts(), before)] == \
        [2, walk, 2, 1, 1, 1, 1]
    dx = dispatch_bwd_ref(wd, eid, slot)
    dy, dg = combine_bwd_ref(wc, y, eid, slot, gates)
    return [t.grad for t in leaves], (dx, dy, dg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", SHUFFLE_KINDS)
@pytest.mark.parametrize("case", SHUFFLE_CASES[:4])
def test_shuffle_function_grads_on_the_card(case, kind, dtype, cuda_device):
    """``_Dispatch``'s dx (a combine launch with unit gates) and
    ``_Combine``'s dy (a dispatch launch of the gate-weighted rows) and
    dgates (plain) against ``dispatch_bwd_ref`` / ``combine_bwd_ref`` at the
    reference's MoE tolerance: drops, ids of -1 and E, slots of -1 and C +
    3, repeated rows."""
    T, D, E, K, C = case
    x, y, gates, eid, slot = shuffle_inputs(np.random.default_rng(T + D),
                                            T, D, E, K, C, kind)
    dt = DTYPES[dtype]
    x, y, gates = (torch.from_numpy(a).to(cuda_device, dt)
                   for a in (x, y, gates))
    eid, slot = (torch.from_numpy(a).to(cuda_device) for a in (eid, slot))
    rng = np.random.default_rng(T)
    wd = torch.from_numpy(rng.normal(size=(E, C, D))).to(cuda_device, dt)
    wc = torch.from_numpy(rng.normal(size=(T, D))).to(cuda_device, dt)
    got, want = _shuffle_grads(x, y, gates, eid, slot, E, C, wd, wc)
    tol = dict(rtol=SHUFFLE_TOL[dtype], atol=SHUFFLE_TOL[dtype])
    for g, w in zip(got, want):
        assert g.dtype == dt
        _close(g, w, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shuffle_function_grads_at_the_training_shape(dtype, cuda_device):
    """deepseek-v2-lite-16b's training routing (24576 pairs, so dispatch's
    ``walk`` in the forward and in combine's backward): the Functions'
    gradients against the plain backwards; under served routing every row
    has one pair, so dy is the gate-weighted cotangent, bit for bit, at
    each kept pair's row."""
    B, T, E, K, C, D = MOE_TRAIN_SHAPE
    rng = np.random.default_rng(3)
    eid, slot = _served_routing(rng, B, T, E, K, C, cuda_device)
    dt = DTYPES[dtype]
    x = torch.from_numpy(rng.normal(size=(B * T, D))).to(cuda_device, dt)
    y = torch.from_numpy(rng.normal(size=(B * E, C, D))).to(cuda_device, dt)
    gates = torch.from_numpy(rng.random((B * T, K))).to(cuda_device, dt)
    wd = torch.from_numpy(rng.normal(size=(B * E, C, D))).to(cuda_device, dt)
    # at D^-1/2, so that dgates (a dot over D = 2048) stays O(1): at unit
    # scale two fp32 sums of its terms differ by more than 1e-5 where they
    # cancel
    wc = torch.from_numpy(rng.normal(size=(B * T, D)) * D ** -0.5).to(
        cuda_device, dt)
    got, want = _shuffle_grads(x, y, gates, eid, slot, B * E, C, wd, wc)
    tol = dict(rtol=SHUFFLE_TOL[dtype], atol=SHUFFLE_TOL[dtype])
    for g, w in zip(got, want):
        _close(g, w, **tol)
    kept = (slot >= 0) & (slot < C)
    tok, k = torch.nonzero(kept, as_tuple=True)
    rows = (eid.long() * C + slot.long())[tok, k]
    expect = torch.zeros((B * E * C, D), dtype=dt, device=cuda_device)
    expect[rows] = (wc[tok] * gates[tok, k, None]).to(dt)
    assert torch.equal(got[1].reshape(-1, D), expect)


@pytest.mark.cuda
def test_shuffle_without_grad_keeps_its_bits(cuda_device):
    """With grad off the wrappers launch the forward kernels once each, the
    same bits as under grad, and no backward."""
    T, D, E, K, C = SHUFFLE_CASES[2]
    x, y, gates, eid, slot = shuffle_inputs(np.random.default_rng(9), T, D,
                                            E, K, C, "drops")
    x, y = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
            for a in (x, y))
    gates = torch.from_numpy(gates).to(cuda_device, torch.bfloat16)
    eid, slot = (torch.from_numpy(a).to(cuda_device) for a in (eid, slot))
    xg, yg = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    before = _shuffle_counts()
    with torch.no_grad():
        buf = dispatch(xg, eid, slot, E, C, impl="kernel")
        out = combine(yg, eid, slot, gates, T, impl="kernel")
    assert buf.grad_fn is None and out.grad_fn is None
    assert [a - b for a, b in zip(_shuffle_counts(), before)] == \
        [1, 1, 1, 0, 0, 0, 0]
    assert torch.equal(buf, dispatch(xg, eid, slot, E, C, impl="kernel"))
    assert torch.equal(out, combine(yg, eid, slot, gates, T, impl="kernel"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-lite-16b"])
def test_moe_lm_grads_on_the_card(arch, cuda_device):
    """Smoke grok-1-314b and smoke deepseek-v2-lite-16b (MLA) in fp32: loss
    and every param's gradient through the kernels (a layer's dispatch and
    combine forward, each one's backward a launch of the other; flash
    forward) against the plain path's (the dense dispatch mask, the chunked
    attention), at 1e-4."""
    cfg = smoke_config(arch).with_(compute_dtype="float32")
    kern = build_model(cfg)
    plain = build_model(cfg, attn_impl="xla", moe_impl="xla")
    params = kern.init(torch.Generator("cuda").manual_seed(0))
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 40))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    before = _shuffle_counts() + (flash_attention.launches,)
    flat, grads = [], []
    tree_map(flat.append, params)
    for model in (kern, plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in flat]
        it = iter(leaves)
        loss = model.loss(tree_map(lambda _: next(it), params), batch)
        grads.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    L = cfg.n_layers
    assert [a - b for a, b in zip(_shuffle_counts() + (
        flash_attention.launches,), before)] == [2 * L, 2 * L, 2 * L, L, L,
                                                 L, L, L]
    _close(grads[0][0], grads[1][0], rtol=1e-4, atol=1e-4)
    for x, y in zip(grads[0][1], grads[1][1]):
        _close(x, y, rtol=1e-4, atol=1e-4)


def _gla_inputs(rng, B, T, Dk, Dv, w0, dtype, device, rk_scale=1.0):
    def t(a):
        return torch.from_numpy(a).to(device, dtype)
    r = t(rng.normal(size=(B, T, Dk)) * rk_scale)
    k = t(rng.normal(size=(B, T, Dk)) * rk_scale)
    v = t(rng.normal(size=(B, T, Dv)))
    w = t(-np.exp(w0 + rng.normal(size=(B, T, Dk)) * 0.5))
    u = t(rng.normal(size=(B, Dk)))
    return r, k, v, w, u


def _check_gla(case, dtype, device, rk_scale=1.0):
    B, T, Dk, Dv, chunk, w0 = case
    inputs = _gla_inputs(np.random.default_rng(11), B, T, Dk, Dv, w0,
                         DTYPES[dtype], device, rk_scale)
    route = scan_kernel.gla_route(DTYPES[dtype])
    before = gla_scan.launches, gla_scan.launches_by_route[route]
    o, S = gla_scan(*inputs, impl="kernel", chunk=chunk)
    torch.cuda.synchronize()
    assert (gla_scan.launches, gla_scan.launches_by_route[route]) == \
        (before[0] + 1, before[1] + 1)
    assert route == ("mma" if dtype == "bfloat16" else "fma")
    assert o.dtype == DTYPES[dtype] and S.dtype == torch.float32
    ro, rS = gla_scan(*inputs, impl="xla_chunked", chunk=chunk)
    assert torch.isfinite(o).all() and torch.isfinite(S).all()
    t = 2e-2 if dtype == "bfloat16" else 2e-4
    _close(o, ro, rtol=t, atol=t)
    _close(S, rS, rtol=t, atol=t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GLA_CASES)
def test_gla_kernel_matches_plain(case, dtype, cuda_device):
    """o and S_T against the chunked plain version at 2e-4 (fp32) / 2e-2
    (bf16)."""
    _check_gla(case, dtype, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gla_kernel_matches_plain_at_the_served_shape(dtype, cuda_device):
    """B*H = 128 rows, T = 512, head 80, chunk 64, the served decays. r and
    k are scaled by Dk^-1/2 so that o stays O(1) and the fixed tolerance
    applies; the next test takes unit-scale r and k."""
    _check_gla((128, 512, 80, 80, 64, -2.0), dtype, cuda_device,
               rk_scale=80 ** -0.5)


def _rel_gap(out, exact):
    return float(((out.double() - exact).abs() / (1 + exact.abs())).max())


@pytest.mark.cuda
def test_gla_kernel_at_the_served_shape_against_the_exact_scan(cuda_device):
    """Unit-scale r and k in fp32 at the served shape (the inputs that
    _check_gla draws from its seed): o reaches ~170 and its terms cancel.
    The fp64 oracle is the exact answer; the kernel must come as close to it
    as twice the chunked plain version does."""
    inputs = _gla_inputs(np.random.default_rng(11), 128, 512, 80, 80, -2.0,
                         torch.float32, cuda_device)
    exact_o, exact_S = gla_scan_ref(*(x.double() for x in inputs))
    o, S = gla_scan(*inputs, impl="kernel", chunk=64)
    po, pS = gla_scan(*inputs, impl="xla_chunked", chunk=64)
    assert torch.isfinite(o).all() and torch.isfinite(S).all()
    plain = max(_rel_gap(po, exact_o), _rel_gap(pS, exact_S))
    kernel = max(_rel_gap(o, exact_o), _rel_gap(S, exact_S))
    assert kernel <= 2 * plain, (kernel, plain)


@pytest.mark.cuda
def test_gla_mma_route_at_the_served_shape_against_the_exact_scan(
        cuda_device):
    """bf16, unit-scale r and k at the served shape, on the tensor-core
    route. The exact (fp64) scan of the same bf16 inputs is the witness: o
    (rounded to bf16, what the model reads) must come as close to it as
    twice the chunked plain version does, and S within GLA's bf16
    tolerance."""
    inputs = _gla_inputs(np.random.default_rng(11), 128, 512, 80, 80, -2.0,
                         torch.bfloat16, cuda_device)
    exact_o, exact_S = gla_scan_ref(*(x.double() for x in inputs))
    before = gla_scan.launches_by_route["mma"]
    o, S = gla_scan(*inputs, impl="kernel", chunk=64)
    po, _ = gla_scan(*inputs, impl="xla_chunked", chunk=64)
    torch.cuda.synchronize()
    assert gla_scan.launches_by_route["mma"] == before + 1
    assert torch.isfinite(o).all() and torch.isfinite(S).all()
    assert _rel_gap(o, exact_o) <= 2 * _rel_gap(po, exact_o)
    assert _rel_gap(S, exact_S) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,Dk,tv", [(64, 80, 40), (16, 10, 6),
                                         (64, 128, 32), (37, 80, 8)])
def test_gla_mma_smem_plan_matches_the_library(chunk, Dk, tv, cuda_device):
    """The wrapper's shared-memory plan (``gla_mma_smem``, which picks the
    tiles on the CPU) is the one the built library launches with."""
    lib = scan_kernel._lib()
    assert lib.gla_scan_mma_smem(chunk, Dk, tv) == \
        scan_kernel.gla_mma_smem(chunk, Dk, tv)


@pytest.mark.cuda
def test_rwkv_serve_loop_prefills_through_the_scan_kernel(cuda_device):
    cfg = smoke_config("rwkv6-3b")
    loop = ServeLoop(cfg, batch_slots=2, max_len=40, hbm_pages=4)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, 24, dtype=np.int32),
                    max_new_tokens=4) for i in range(4)]
    before = gla_scan.launches, gla_scan.launches_by_route["mma"]
    out = loop.run(reqs)
    assert gla_scan.launches - before[0] == cfg.n_layers * 2
    # smoke rwkv serves in bf16: every prefill on the tensor-core route
    assert gla_scan.launches_by_route["mma"] - before[1] == cfg.n_layers * 2
    assert all(len(v) == 4 for v in out.values())


@pytest.mark.cuda
def test_rwkv_kernel_path_matches_plain_path(cuda_device):
    cfg = smoke_config("rwkv6-3b").with_(compute_dtype="float32",
                                         kv_cache_dtype="float32")
    kern = build_model(cfg)
    plain = build_model(cfg, scan_impl="xla_chunked")
    params = kern.init(torch.Generator("cuda").manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 70)))
    lk, sk = kern.prefill(params, {"tokens": toks})
    lp, sp = plain.prefill(params, {"tokens": toks})
    _close(lk, lp, rtol=1e-4, atol=1e-4)
    _close(sk["S"], sp["S"], rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DIAG_CASES)
def test_diag_kernel_matches_plain(case, dtype, cuda_device):
    """The kernel against the sequential oracle; with no h0, and with h0 in
    fp32 and in bf16 (recurrentgemma's fp32 layers start from the bf16 zero
    state of the cache), each read in its own dtype. Both routes walk each
    channel in order and round as the plain version does, so h and h_T are
    its bits at every T: the ring for T > 1, the step for T = 1."""
    B, T, D, chunk, near_one = case
    rng = np.random.default_rng(T + D)
    dt = DTYPES[dtype]
    if near_one:
        a = torch.exp(-0.02 * torch.from_numpy(rng.uniform(size=(B, T, D))))
    else:
        a = torch.sigmoid(torch.from_numpy(rng.normal(size=(B, T, D))))
    a = a.to(cuda_device, dt)
    b = torch.from_numpy(rng.normal(size=(B, T, D))).to(cuda_device, dt)
    h0 = torch.from_numpy(rng.normal(size=(B, D))).to(cuda_device)
    route = scan_kernel.diag_route(T)
    for init in (None, h0.float(), h0.bfloat16()):
        before = diag_scan.launches, diag_scan.launches_by_route[route]
        h, hT = diag_scan(a, b, init, impl="kernel", chunk=chunk)
        torch.cuda.synchronize()
        assert (diag_scan.launches, diag_scan.launches_by_route[route]) == \
            (before[0] + 1, before[1] + 1)
        rh, rT = diag_scan(a, b, init, impl="xla")
        assert h.dtype == hT.dtype == dt
        _close(h, rh, **_tol(dtype))
        _close(hT, rT, **_tol(dtype))
        assert torch.equal(h, rh) and torch.equal(hT, rT)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,D", [(4, 2100, 4096), (4, 1, 4096), (2, 77, 33),
                                   (3, 1, 33)])
def test_diag_plan_matches_the_library(B, T, D, dtype, cuda_device):
    """The wrapper's tiling (``diag_plan``, tested on the CPU) is the one
    the built library launches."""
    plan = scan_kernel.diag_plan(B, T, D, DTYPES[dtype])
    plan.pop("access_bytes")
    assert scan_kernel.diag_plan_built(B, T, D, DTYPES[dtype]) == plan


@pytest.mark.cuda
def test_hybrid_serve_loop_runs_both_kernels(cuda_device):
    """Smoke recurrentgemma-9b on the card, prompts longer than its window
    (16): every RG-LRU layer's prefill and decode go through the diag-scan
    kernel, every attention layer's prefill through the flash kernel."""
    cfg = smoke_config("recurrentgemma-9b")
    loop = ServeLoop(cfg, batch_slots=2, max_len=40, hbm_pages=4)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, 24, dtype=np.int32),
                    max_new_tokens=4) for i in range(4)]
    before = (diag_scan.launches, flash_attention.launches)
    routes = dict(diag_scan.launches_by_route)
    out = loop.run(reqs)
    rec = sum(k == "rec" for k in cfg.block_pattern) + 1     # 2 + 1 rem
    steps = 2 * (1 + 4)                  # 2 batches: a prefill, 4 decodes
    assert diag_scan.launches - before[0] == rec * steps
    # prefills on the ring, decode steps (T = 1) on the step kernel
    assert {r: n - routes[r] for r, n in diag_scan.launches_by_route.items()} \
        == {"ring": rec * 2, "step": rec * 2 * 4}
    assert flash_attention.launches - before[1] == 1 * 2
    assert all(len(v) == 4 for v in out.values())


@pytest.mark.cuda
def test_hybrid_kernel_path_matches_plain_path(cuda_device):
    cfg = smoke_config("recurrentgemma-9b").with_(compute_dtype="float32",
                                                  kv_cache_dtype="float32")
    kern = build_model(cfg)
    plain = build_model(cfg, attn_impl="xla", scan_impl="xla")
    params = kern.init(torch.Generator("cuda").manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 70)))
    lk, ck = kern.prefill(params, {"tokens": toks}, max_len=80)
    lp, cp = plain.prefill(params, {"tokens": toks}, max_len=80)
    _close(lk, lp, rtol=1e-4, atol=1e-4)
    for key in ("t0", "t1"):
        _close(ck["super"][key]["h"], cp["super"][key]["h"], rtol=1e-4,
               atol=1e-4)
    nxt = lk[:, -1].argmax(-1)[:, None]
    dk, _ = kern.decode_step(params, {"tokens": nxt}, ck, 70)
    dp, _ = plain.decode_step(params, {"tokens": nxt}, cp, 70)
    _close(dk, dp, rtol=1e-4, atol=1e-4)


# -- the recurrent families' training path -----------------------------------
# the diagonal scan's backward: the forward's cases at small widths, T = 1,
# a width that is not whole 16-byte rows, and recurrentgemma-9b's training
# shape (4 x 512 tokens of d_model 4096)
DIAG_BWD_CASES = [  # B, T, D
    (2, 1, 16),
    (2, 37, 16),
    (2, 64, 16),
    (2, 77, 33),
    (1, 100, 8),
    (4, 512, 4096),
]


def _diag_bwd_inputs(B, T, D, dt, device, seed):
    rng = np.random.default_rng(seed)
    a = torch.sigmoid(torch.from_numpy(rng.normal(size=(B, T, D))))
    b, g = (torch.from_numpy(rng.normal(size=(B, T, D))) for _ in range(2))
    h0, gT = (torch.from_numpy(rng.normal(size=(B, D))) for _ in range(2))
    return [x.to(device, dt) for x in (a, b, g)] + [h0.to(device).float(),
                                                   gT.to(device, dt)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DIAG_BWD_CASES)
def test_diag_bwd_kernel_matches_plain_bit_for_bit(case, dtype, cuda_device):
    """The backward ring kernel against ``diag_scan_bwd_ref`` on the
    forward's own h, with and without h0 and a cotangent of h_T: da, db and
    dh0 are its bits (both walk each channel from the last step down and
    round the multiply and the add apart)."""
    B, T, D = case
    a, b, g, h0, gT = _diag_bwd_inputs(B, T, D, DTYPES[dtype], cuda_device,
                                       T + D)
    for init, cot in ((None, None), (h0, None), (h0, gT), (h0.bfloat16(),
                                                           gT)):
        h, _ = diag_scan(a, b, init, impl="kernel")
        da, db, dh0 = scan_kernel.diag_scan_bwd_kernel(a, h, g, init, cot)
        torch.cuda.synchronize()
        first = (torch.zeros_like(h[:, 0], dtype=torch.float32)
                 if init is None else init.float())
        h_prev = torch.cat([first[:, None], h[:, :-1].float()], dim=1)
        ra, rb, r0 = diag_scan_bwd_ref(a, h_prev, g, cot)
        assert da.dtype == db.dtype == a.dtype
        assert torch.equal(da, ra) and torch.equal(db, rb)
        if init is None:
            assert dh0 is None
        else:
            assert dh0.dtype == torch.float32 and torch.equal(dh0, r0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_diag_scan_function_grads_on_the_card(dtype, cuda_device):
    """``_DiagScan``'s da, db, dh0 through the forward and backward kernels
    (one launch each) against fp64 autograd of the plain version, at 3e-4
    (fp32) and 2e-2 (bf16)."""
    a, b, g, h0, gT = _diag_bwd_inputs(3, 200, 40, DTYPES[dtype],
                                       cuda_device, 5)
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    before = diag_scan.launches, diag_scan.bwd_launches
    h, hT = diag_scan(*leaves, impl="kernel")
    torch.autograd.backward([h, hT], [g, gT])
    assert (diag_scan.launches, diag_scan.bwd_launches) == (before[0] + 1,
                                                            before[1] + 1)
    ref = [t.double().requires_grad_(True) for t in (a, b, h0)]
    rh, rT = diag_scan_ref(*ref)
    torch.autograd.backward([rh, rT], [g.double(), gT.double()])
    tol = 3e-4 if dtype == "float32" else 2e-2
    for t, r in zip(leaves, ref):
        _close(t.grad, r.grad, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gla_scan_function_grads_on_the_card(dtype, cuda_device):
    """``_GLAScan``'s gradients (the kernel forward, on the fp32 ``fma``
    route for either dtype, o in the inputs' dtype; the plain backward by
    recompute, no GLA launch in it) against fp64 autograd of the exact
    scan, at 3e-4 (fp32) and 2e-2 (bf16)."""
    inputs = _gla_inputs(np.random.default_rng(12), 4, 100, 16, 16, -2.0,
                         DTYPES[dtype], cuda_device, rk_scale=0.25)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    go = torch.from_numpy(np.random.default_rng(13).normal(
        size=(4, 100, 16))).to(cuda_device)
    before = (gla_scan.launches, gla_scan.bwd_calls,
              gla_scan.launches_by_route["fma"])
    o, _ = gla_scan(*leaves, impl="kernel", chunk=64)
    (o.float() * go.float()).sum().backward()
    assert o.dtype == DTYPES[dtype]
    assert (gla_scan.launches, gla_scan.bwd_calls,
            gla_scan.launches_by_route["fma"]) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    ref = [t.double().requires_grad_(True) for t in inputs]
    ro, _ = gla_scan_ref(*ref)
    (ro * go).sum().backward()
    tol = 3e-4 if dtype == "float32" else 2e-2
    for t, r in zip(leaves, ref):
        _close(t.grad, r.grad, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_recurrent_lm_grads_on_the_card(arch, cuda_device):
    """Smoke rwkv6-3b and recurrentgemma-9b in fp32: loss and every param's
    gradient through the kernels (GLA forward a layer; the diagonal scan's
    forward and backward a RG-LRU layer; flash a local-attention layer)
    against the plain path's, at 1e-4."""
    cfg = smoke_config(arch).with_(compute_dtype="float32")
    kern = build_model(cfg)
    plain = build_model(cfg, attn_impl="xla", scan_impl="xla" if
                        cfg.family == "hybrid" else "xla_chunked")
    params = kern.init(torch.Generator("cuda").manual_seed(0))
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 40))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    counts = (gla_scan.launches, gla_scan.bwd_calls, diag_scan.launches,
              diag_scan.bwd_launches)
    flat, grads = [], []
    tree_map(flat.append, params)
    for model in (kern, plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in flat]
        it = iter(leaves)
        loss = model.loss(tree_map(lambda _: next(it), params), batch)
        grads.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    rec = sum(k == "rec" for k in cfg.block_pattern) + 1 \
        if cfg.family == "hybrid" else 0
    gla = cfg.n_layers if cfg.family == "ssm" else 0
    assert (gla_scan.launches - counts[0], gla_scan.bwd_calls - counts[1],
            diag_scan.launches - counts[2],
            diag_scan.bwd_launches - counts[3]) == (gla, gla, rec, rec)
    _close(grads[0][0], grads[1][0], rtol=1e-4, atol=1e-4)
    for x, y in zip(grads[0][1], grads[1][1]):
        _close(x, y, rtol=1e-4, atol=1e-4)


# -- the serving tier on the card ---------------------------------------------
def _host_floats(a, dtype):
    """A tier's host-form array (bf16 as ``np.uint16`` bits) as float64."""
    from repro_torch.core.kvcache import host_to_tensor
    return host_to_tensor(np.asarray(a), dtype).double().numpy()


def _tier_dense(tier, seq_id, layer):
    """fp64 softmax attention of the session's q over its K/V as the oracle
    (``expected_slabs``) has them, not as the pool holds them."""
    from repro_torch.core.kvcache import host_array
    from repro_torch.runtime.serving import token_value
    n = tier.sessions[seq_id].length
    kv = _host_floats(np.concatenate(tier.expected_slabs(seq_id), axis=1)
                      [layer, :n], tier.dtype)
    k, v = kv[:, 0], kv[:, 1]
    q = np.full((tier.kv_heads, tier.head_dim), _host_floats(
        host_array(token_value(seq_id, n), tier.dtype), tier.dtype))
    s = np.einsum("hd,thd->ht", q, k) / np.sqrt(tier.head_dim)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return np.einsum("ht,thd->hd", p / p.sum(axis=1, keepdims=True), v)


def _tier_batches(tier):
    """Per-shard batches whose pages fit the shard's pool together."""
    by_node = {}
    for s, sess in sorted(tier.sessions.items()):
        by_node.setdefault(sess.node, []).append(s)
    out = []
    for seqs in by_node.values():
        cur, used = [], 0
        for s in seqs:
            n = tier._pages_for(tier.sessions[s].length)
            if cur and used + n > tier.hbm_pages_per_node:
                out.append(cur)
                cur, used = [], 0
            cur.append(s)
            used += n
        out.append(cur)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [
    dict(),                                             # the tier's default
    dict(num_layers=2, page_tokens=64, kv_heads=8, head_dim=128),
], ids=["default", "D128-page64"])
def test_serving_tier_attend_on_the_card(geometry, cuda_device):
    _tier_attend_on_the_card(geometry, np.float32, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [
    dict(head_dim=8),                   # 16-byte rows, page 4: cp.async
    dict(num_layers=2, page_tokens=64, kv_heads=8, head_dim=128),
], ids=["D8", "D128-page64"])
def test_serving_tier_attend_at_bf16_on_the_card(geometry, cuda_device):
    """The tier at a bf16 pool: one launch a shard on the bf16 route, within
    2e-2 (the JAX package's bf16 tolerance) of the plain version and of fp64
    dense attention; every session verifies."""
    _tier_attend_on_the_card(geometry, torch.bfloat16, 2e-2)


def _tier_attend_on_the_card(geometry, dtype, tol):
    from repro_torch.kernels.paged_attention.kernel import ROUTES
    from repro_torch.runtime.cluster import Cluster
    from repro_torch.runtime.serving import ServingTier
    cluster = Cluster(4, node_capacity=256 << 20, page_size=1 << 16,
                      replication_factor=1, admission=True)
    tier = ServingTier(cluster, hbm_pages_per_node=8, host_budget_bytes=0,
                       dtype=dtype, device="cuda", **geometry)
    route = ROUTES[tier.dtype]
    try:
        pt = tier.page_tokens
        prompts = {s: (2 + s % 5) * pt - s % 3 for s in range(10)}
        tier.admit(prompts)
        assert all(sh.cache.kv.device.type == "cuda"
                   for sh in tier._shards.values())
        tier.decode(sorted(prompts), steps=pt + 1)
        # every shard's pages overflow its pool: evictions and restores
        assert sum(sh.cache.stats["offloads"]
                   for sh in tier._shards.values()) > 0
        cluster.kill_node(tier.sessions[0].node)
        tier.decode(sorted(prompts), steps=2)
        assert tier.stats["failovers"] >= 1
        for batch in _tier_batches(tier):
            for layer in range(tier.num_layers):
                shards = len({tier.sessions[s].node for s in batch})
                before = paged_attention.launches
                on_route = paged_attention.launches_by_route[route]
                ker = tier.attend(batch, layer, impl="kernel")
                assert paged_attention.launches - before == shards == 1
                assert paged_attention.launches_by_route[route] - on_route \
                    == 1
                plain = tier.attend(batch, layer, impl="xla")
                for s in batch:
                    assert ker[s].dtype == tier.host_dtype
                    got = _host_floats(ker[s], tier.dtype)
                    np.testing.assert_allclose(
                        got, _host_floats(plain[s], tier.dtype), rtol=tol,
                        atol=tol)
                    np.testing.assert_allclose(
                        got, _tier_dense(tier, s, layer), rtol=tol, atol=tol)
        # one call over every session: one launch a shard
        seqs = sorted(tier.sessions)
        shards = len({tier.sessions[s].node for s in seqs})
        before = paged_attention.launches
        tier.attend(seqs, 0, impl="kernel")
        assert paged_attention.launches - before == shards > 1
        for s in seqs:
            assert tier.verify(s)
    finally:
        tier.close()
        cluster.shutdown()


@pytest.mark.cuda
def test_serving_tier_proc_failover_after_cuda_init(cuda_device):
    """Node processes forked after CUDA is up never touch the card: a
    SIGKILL of a session's primary mid-decode fails over, the KV verifies,
    attend agrees with its plain version, and close() leaves nothing."""
    from repro_torch.runtime import rpc
    from repro_torch.runtime.cluster import Cluster
    from repro_torch.runtime.serving import ServingTier
    torch.zeros(1, device=cuda_device)          # CUDA is up before the fork
    before = rpc.pickle_fallbacks()
    cluster = Cluster(4, backend="proc", node_capacity=8 << 20,
                      page_size=1 << 14, replication_factor=1, admission=True)
    try:
        tier = ServingTier(cluster, hbm_pages_per_node=3,
                           host_budget_bytes=1024, device="cuda")
        tier.admit({1: 10, 2: 6})
        tier.decode([1, 2], steps=4)
        victim = tier.sessions[1].node
        tier.add_fault_hook("mid_decode", lambda: cluster.kill_node(victim))
        tier.decode([1, 2], steps=6)
        assert tier.stats["failovers"] >= 1
        for s in (1, 2):
            assert tier.verify(s)
            launches = paged_attention.launches
            ker = tier.attend([s], impl="kernel")[s]
            assert paged_attention.launches == launches + 1
            np.testing.assert_allclose(ker, tier.attend([s], impl="xla")[s],
                                       rtol=2e-5, atol=2e-5)
        tier.close()
    finally:
        report = cluster.close()
    assert report.ok, report
    assert rpc.pickle_fallbacks() == before


# AdamW's kernel against the plain adamw_update on the card: each size as a
# rank-1 and a rank-2 leaf (decay on the second only), 1 and 7 elements
# (tails alone), 4097 and 4097 * 4099 (over 2**24), each a tail after whole
# vectors
ADAMW_SHAPES = {1: ((1,), (1, 1)), 7: ((7,), (7, 1)),
                4097: ((4097,), (17, 241)),
                4097 * 4099: ((4097 * 4099,), (4097, 4099))}
# (param, gradient, moments): the param's or an fp32 (accumulated) gradient
ADAMW_DTYPES = [("float32", "float32", "float32"),
                ("float32", "float32", "bfloat16"),
                ("bfloat16", "bfloat16", "float32"),
                ("bfloat16", "bfloat16", "bfloat16"),
                ("bfloat16", "float32", "float32"),
                ("bfloat16", "float32", "bfloat16")]


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["aligned", "offset", "zero_grad"])
@pytest.mark.parametrize("size", sorted(ADAMW_SHAPES))
@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("dtypes", ADAMW_DTYPES, ids="-".join)
def test_adamw_kernel_matches_plain_bit_for_bit(dtypes, rank, size, layout,
                                                cuda_device):
    """``adamw_apply`` (one kernel launch a leaf) writes the functional
    ``adamw_update``'s values, bit for bit, into the leaf's own tensors at
    steps 1, 2 and 3: every dtype the port trains with, rank 1 and 2,
    tails, a leaf viewed one element past a 16-byte boundary (the scalar
    route) and a broadcast zero gradient (an unused leaf's)."""
    pdt, gdt, mdt = (getattr(torch, d) for d in dtypes)
    shape = ADAMW_SHAPES[size][rank - 1]
    skew = int(layout == "offset")
    gen = torch.Generator(device=cuda_device).manual_seed(size + rank)

    def leaf(dt, positive=False):
        x = torch.randn((size,), generator=gen, device=cuda_device)
        buf = torch.empty((size + skew,), dtype=dt, device=cuda_device)
        buf[skew:] = (x.abs() * 1e-2 if positive else x).to(dt)
        return buf[skew:].view(shape)

    p, m, v = leaf(pdt), leaf(mdt), leaf(mdt, positive=True)
    step0 = torch.zeros((), dtype=torch.int32, device=cuda_device)
    params, state = {"w": p}, AdamWState(step0, {"w": m}, {"w": v})
    plain = ({"w": p.clone()},
             AdamWState(step0.clone(), {"w": m.clone()}, {"w": v.clone()}))
    route = "scalar" if layout == "offset" else "vector"
    for step in (1, 2, 3):
        g = torch.zeros((), dtype=gdt, device=cuda_device).expand(shape) \
            if layout == "zero_grad" else leaf(gdt)
        plain = adamw_update(plain[0], {"w": g}, plain[1], lr=1e-2)
        on_route = adamw.launches_by_route[route]
        params, state = adamw_apply(params, [g], state, lr=1e-2)
        torch.cuda.synchronize()
        assert adamw.launches_by_route[route] == on_route + 1
        assert int(state.step) == int(plain[1].step) == step
        for got, want in ((params["w"], plain[0]["w"]),
                          (state.m["w"], plain[1].m["w"]),
                          (state.v["w"], plain[1].v["w"])):
            assert _same_bits(got, want), (step, int(
                (got.float() != want.float()).sum()))
    assert params["w"] is p and state.m["w"] is m and state.v["w"] is v


@pytest.mark.cuda
def test_adamw_deepseek_tree_is_one_vector_launch_a_leaf(cuda_device):
    """Smoke deepseek-v2-lite-16b's 19 leaves (the 4-layer training cell's
    tree, at smoke widths): exactly 19 AdamW launches a train step, all on
    the vector route, and a finite loss that falls."""
    cfg = smoke_config("deepseek-v2-lite-16b")
    model = build_model(cfg, device=cuda_device)
    state = make_train_state(model.init(
        torch.Generator(device=cuda_device).manual_seed(0)))
    flat = []
    tree_map(flat.append, state.params)
    assert len(flat) == 19
    step = make_train_step(model.loss, lr=1e-2)
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (2, 33)),
                        dtype=torch.int32, device=cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = adamw.launches, adamw.launches_by_route["vector"]
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert adamw.launches - before[0] == 3 * 19
    assert adamw.launches_by_route["vector"] - before[1] == 3 * 19
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
