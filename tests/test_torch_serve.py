"""The port's ServeLoop against the JAX package's, in the case of
tests/test_system.py::test_serve_loop_with_paging (smoke glm4-9b, 6 requests,
2 slots, max_len 32, 3 pool pages) with fp32 compute and KV so that no greedy
argmax tie flips: identical token ids and identical pager stats."""
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
