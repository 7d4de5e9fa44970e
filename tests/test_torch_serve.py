"""The port's ServeLoop against the JAX package's, in the case of
tests/test_system.py::test_serve_loop_with_paging (smoke glm4-9b, 6 requests,
2 slots, max_len 32, 3 pool pages) with fp32 compute and KV so that no greedy
argmax tie flips: identical token ids and identical pager stats; the same for
smoke olmo-1b, minitron-8b, rwkv6-3b, recurrentgemma-9b, grok-1-314b and
deepseek-v2-lite-16b."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import ServeLoop as JaxServeLoop
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.linear_scan.ops import diag_scan, gla_scan
from repro_torch.kernels.shuffle_dispatch.ops import combine, dispatch
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, ServeLoop

torch.set_num_threads(2)

FP32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
PAGER_KEYS = ("offloads", "fetches", "offload_bytes", "prefill_tokens",
              "decode_tokens")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 12, dtype=np.int32) for _ in range(6)]


def test_serve_loop_matches_jax_tokens_and_pager_stats():
    jcfg = jax_smoke_config("glm4-9b").with_(**FP32)
    jloop = JaxServeLoop(jcfg, batch_slots=2, max_len=32, hbm_pages=3)
    jout = jloop.run([JaxRequest(i, p, max_new_tokens=4)
                      for i, p in enumerate(_prompts(jcfg.vocab))])

    params = params_from_numpy(jax.tree.map(np.asarray, jloop.params),
                               device="cpu")
    cfg = smoke_config("glm4-9b").with_(**FP32)
    loop = ServeLoop(cfg, batch_slots=2, max_len=32, hbm_pages=3,
                     params=params, device="cpu")
    before = flash_attention.launches
    out = loop.run([Request(i, p, max_new_tokens=4)
                    for i, p in enumerate(_prompts(cfg.vocab))])

    assert len(out) == 6 and all(len(v) == 4 for v in out.values())
    assert out == jout
    assert loop.stats["offloads"] > 0          # paging policy exercised
    for key in PAGER_KEYS:
        assert loop.stats[key] == jloop.stats[key], key
    assert loop.pager.kv.device.type == "cpu"
    assert flash_attention.launches == before  # CPU: the plain version


@pytest.mark.parametrize("arch", ["olmo-1b", "minitron-8b"])
def test_dense_serve_loop_matches_jax_tokens_and_pager_stats(arch):
    """The dense archs ported with the trainer (olmo-1b: non-parametric
    LayerNorm and MHA; minitron-8b: GQA) in the same case."""
    jcfg = jax_smoke_config(arch).with_(**FP32)
    jloop = JaxServeLoop(jcfg, batch_slots=2, max_len=32, hbm_pages=3)
    jout = jloop.run([JaxRequest(i, p, max_new_tokens=4)
                      for i, p in enumerate(_prompts(jcfg.vocab))])
    params = params_from_numpy(jax.tree.map(np.asarray, jloop.params),
                               device="cpu")
    loop = ServeLoop(smoke_config(arch).with_(**FP32), batch_slots=2,
                     max_len=32, hbm_pages=3, params=params, device="cpu")
    out = loop.run([Request(i, p, max_new_tokens=4)
                    for i, p in enumerate(_prompts(jcfg.vocab))])
    assert len(out) == 6 and all(len(v) == 4 for v in out.values())
    assert out == jout
    assert loop.stats["offloads"] > 0
    for key in PAGER_KEYS:
        assert loop.stats[key] == jloop.stats[key], key


def test_rwkv_serve_loop_matches_jax_tokens_and_pager_stats():
    """Smoke rwkv6-3b in the same case (fp32, 6 requests, 2 slots, max_len
    32, 3 pool pages): identical token ids and pager stats. The pool is
    bookkeeping only here, as in the reference; it still offloads."""
    jcfg = jax_smoke_config("rwkv6-3b").with_(**FP32)
    jloop = JaxServeLoop(jcfg, batch_slots=2, max_len=32, hbm_pages=3)
    jout = jloop.run([JaxRequest(i, p, max_new_tokens=4)
                      for i, p in enumerate(_prompts(jcfg.vocab))])

    params = params_from_numpy(jax.tree.map(np.asarray, jloop.params),
                               device="cpu")
    cfg = smoke_config("rwkv6-3b").with_(**FP32)
    loop = ServeLoop(cfg, batch_slots=2, max_len=32, hbm_pages=3,
                     params=params, device="cpu")
    assert loop.pager.kv.shape[-2:] == (1, cfg.d_model)   # reference geometry
    before = gla_scan.launches
    out = loop.run([Request(i, p, max_new_tokens=4)
                    for i, p in enumerate(_prompts(cfg.vocab))])

    assert len(out) == 6 and all(len(v) == 4 for v in out.values())
    assert out == jout
    assert loop.stats["offloads"] > 0
    for key in PAGER_KEYS:
        assert loop.stats[key] == jloop.stats[key], key
    assert gla_scan.launches == before         # CPU: the plain version


def test_hybrid_serve_loop_matches_jax_tokens_and_pager_stats():
    """Smoke recurrentgemma-9b (window 16) in the same case, with prompts of
    20 tokens: the prefill packs a ring of 16 slots and decode writes into
    it. Identical token ids and pager stats; the pool (38 layers' geometry
    cut to the smoke's 4, one kv head of 16) offloads."""
    jcfg = jax_smoke_config("recurrentgemma-9b").with_(**FP32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab, 20, dtype=np.int32)
               for _ in range(6)]
    jloop = JaxServeLoop(jcfg, batch_slots=2, max_len=32, hbm_pages=3)
    jout = jloop.run([JaxRequest(i, p, max_new_tokens=4)
                      for i, p in enumerate(prompts)])

    params = params_from_numpy(jax.tree.map(np.asarray, jloop.params),
                               device="cpu")
    cfg = smoke_config("recurrentgemma-9b").with_(**FP32)
    loop = ServeLoop(cfg, batch_slots=2, max_len=32, hbm_pages=3,
                     params=params, device="cpu")
    assert loop.pager.kv.shape[-2:] == (1, cfg.resolved_head_dim)
    before = (diag_scan.launches, flash_attention.launches)
    out = loop.run([Request(i, p, max_new_tokens=4)
                    for i, p in enumerate(prompts)])

    assert len(out) == 6 and all(len(v) == 4 for v in out.values())
    assert out == jout
    assert loop.stats["offloads"] > 0
    for key in PAGER_KEYS:
        assert loop.stats[key] == jloop.stats[key], key
    # CPU: the plain versions
    assert (diag_scan.launches, flash_attention.launches) == before


def test_moe_serve_loop_matches_jax_tokens_and_pager_stats():
    """Smoke grok-1-314b in the same case (fp32, 6 requests, 2 slots,
    max_len 32, 3 pool pages): identical token ids and pager stats. The
    reference's ServeLoop runs its dense dispatch mask; the port's runs the
    shuffle path (its plain versions on the CPU), at the smoke config's
    capacity, so prefill drops pairs."""
    jcfg = jax_smoke_config("grok-1-314b").with_(**FP32)
    jloop = JaxServeLoop(jcfg, batch_slots=2, max_len=32, hbm_pages=3)
    jout = jloop.run([JaxRequest(i, p, max_new_tokens=4)
                      for i, p in enumerate(_prompts(jcfg.vocab))])

    params = params_from_numpy(jax.tree.map(np.asarray, jloop.params),
                               device="cpu")
    cfg = smoke_config("grok-1-314b").with_(**FP32)
    loop = ServeLoop(cfg, batch_slots=2, max_len=32, hbm_pages=3,
                     params=params, device="cpu")
    assert loop.model.moe_impl == "kernel"
    before = (dispatch.launches, combine.launches)
    out = loop.run([Request(i, p, max_new_tokens=4)
                    for i, p in enumerate(_prompts(cfg.vocab))])

    assert len(out) == 6 and all(len(v) == 4 for v in out.values())
    assert out == jout
    assert loop.stats["offloads"] > 0
    for key in PAGER_KEYS:
        assert loop.stats[key] == jloop.stats[key], key
    assert (dispatch.launches, combine.launches) == before   # CPU: plain


def test_mla_serve_loop_matches_jax_tokens_and_pager_stats():
    """Smoke deepseek-v2-lite-16b (MLA, MoE in every layer) in the same case:
    identical token ids and pager stats. Both loops decode over the
    expanded per-head cache (the reference's default); the port's prefill
    attention is the flash kernel's plain version at D = 24, Dv = 16, its
    MoE the shuffle path's; the pager's geometry (kv_heads 2, head_dim 16)
    is bookkeeping, as in the reference."""
    jcfg = jax_smoke_config("deepseek-v2-lite-16b").with_(**FP32)
    jloop = JaxServeLoop(jcfg, batch_slots=2, max_len=32, hbm_pages=3)
    jout = jloop.run([JaxRequest(i, p, max_new_tokens=4)
                      for i, p in enumerate(_prompts(jcfg.vocab))])

    params = params_from_numpy(jax.tree.map(np.asarray, jloop.params),
                               device="cpu")
    cfg = smoke_config("deepseek-v2-lite-16b").with_(**FP32)
    loop = ServeLoop(cfg, batch_slots=2, max_len=32, hbm_pages=3,
                     params=params, device="cpu")
    assert not loop.model.mla_absorbed and loop.model.moe_impl == "kernel"
    assert (loop.pager.kv_heads, loop.pager.head_dim) == (2, 16)
    before = (flash_attention.launches, dispatch.launches, combine.launches)
    out = loop.run([Request(i, p, max_new_tokens=4)
                    for i, p in enumerate(_prompts(cfg.vocab))])

    assert len(out) == 6 and all(len(v) == 4 for v in out.values())
    assert out == jout
    assert loop.stats["offloads"] > 0
    for key in PAGER_KEYS:
        assert loop.stats[key] == jloop.stats[key], key
    assert (flash_attention.launches, dispatch.launches,
            combine.launches) == before                   # CPU: plain


def test_serve_loop_default_params_and_bf16_run():
    cfg = smoke_config("qwen3-0.6b")
    loop = ServeLoop(cfg, batch_slots=2, max_len=24, hbm_pages=2,
                     device="cpu")
    assert loop.params_c["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert loop.params["layers"]["attn"]["wq"].dtype == torch.float32
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(0, cfg.vocab, 10, dtype=np.int32),
                    max_new_tokens=3) for i in range(3)]
    out = loop.run(reqs)
    assert sorted(out) == [0, 1, 2]
    assert all(len(v) == 3 and all(0 <= t < cfg.vocab for t in v)
               for v in out.values())
    assert loop.stats["decode_tokens"] == 3 * 2 + 3 * 1
    assert loop.stats["offloads"] > 0


def test_main_runs_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--smoke", "--device", "cpu",
                                     "--requests", "2", "--prompt-len", "6",
                                     "--new-tokens", "2"])
    serve.main()
    assert "served 2 requests" in capsys.readouterr().out


def test_main_serves_rwkv_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "rwkv6-3b", "--smoke",
                                     "--device", "cpu", "--requests", "2",
                                     "--prompt-len", "6", "--new-tokens", "2"])
    serve.main()
    assert "served 2 requests" in capsys.readouterr().out


def test_main_serves_recurrentgemma_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "recurrentgemma-9b",
                                     "--smoke", "--device", "cpu",
                                     "--requests", "2", "--prompt-len", "18",
                                     "--new-tokens", "2"])
    serve.main()
    assert "served 2 requests" in capsys.readouterr().out


def test_main_serves_grok_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "grok-1-314b",
                                     "--smoke", "--device", "cpu",
                                     "--requests", "2", "--prompt-len", "6",
                                     "--new-tokens", "2"])
    serve.main()
    assert "served 2 requests" in capsys.readouterr().out


def test_main_serves_deepseek_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--arch",
                                     "deepseek-v2-lite-16b", "--smoke",
                                     "--device", "cpu", "--requests", "2",
                                     "--prompt-len", "6", "--new-tokens", "2"])
    serve.main()
    assert "served 2 requests" in capsys.readouterr().out


def test_entry_points_raise_without_cuda(monkeypatch):
    """Asked for no device, the entry points want the card; without one they
    raise instead of running on the CPU."""
    from repro_torch.core import PagedKVCache
    from repro_torch.models.lm import LM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("glm4-9b")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeLoop(cfg, batch_slots=2, max_len=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(num_layers=2, hbm_pages=4, page_size=8, kv_heads=2,
                     head_dim=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg)
