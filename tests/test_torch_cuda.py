"""The port's CUDA kernels and its serving path on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA GPU.
The file imports no jax and nothing of the JAX package's models, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs at
the JAX package's tolerances (3e-5 fp32, 2e-2 bf16, 2e-5 over the pool).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import PagedKVCache
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models.model import build_model

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
PAGED_CASES = [
    # B, H, KH, D, P, page, max_pages
    (2, 4, 2, 32, 16, 8, 4),
    (1, 8, 8, 16, 8, 16, 3),
    (3, 4, 1, 64, 32, 8, 6),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES + [
    (4, 16, 8, 512, 512, 128, True, None),      # the served prefill
    (1, 4, 2, 300, 300, 128, True, 100)])
def test_flash_kernel_matches_plain(case, dtype, cuda_device):
    B, H, KH, Tq, Tk, D, causal, window = case
    rng = np.random.default_rng(42)
    q, k, v = (torch.from_numpy(rng.normal(size=s)).to(cuda_device,
                                                      DTYPES[dtype])
               for s in ((B, H, Tq, D), (B, KH, Tk, D), (B, KH, Tk, D)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window,
                          impl="kernel", block_q=32, block_k=32)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _close(out, attention_ref(q, k, v, causal=causal, window=window),
           **_tol(dtype))


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
    out = paged_attention(q, kv, bt, lens, impl="kernel")
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    _close(out, paged_attention(q, kv, bt, lens, impl="xla"), **_tol(dtype))


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
