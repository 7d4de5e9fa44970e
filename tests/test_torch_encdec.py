"""The port's encoder-decoder (``models/encdec.py``, seamless-m4t-large-v2's
backbone) against the JAX package's, on the reference's own params
(bridged) and the same inputs, at the smoke size (2 + 2 layers, d 64, 4
heads of 16).

``sinusoidal``; ``encode`` (the flash kernel's plain version on the CPU,
non-causal); ``forward`` and ``loss``'s value; ``decode_cache_init`` with
and without memory; a 10-token prompt through one ``decode_step`` at pos 0
and 4 one-token steps, each against the reference's ``decode_step`` and
the port's own ``forward``; ``build_model``'s dispatch; the params' layout,
bridge and checkpoint keys. fp32 is held at 1e-4; bf16 at 2e-2 against
the reference run op by op (``jax.disable_jit``), as the model tests do.
"""
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten as jax_flatten
from repro.configs import smoke_config as jax_smoke_config
from repro.models.encdec import sinusoidal as jax_sinusoidal
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch.serve import ServeLoop
from repro_torch.models.encdec import EncDecLM, sinusoidal
from repro_torch.models.lm import LM
from repro_torch.models.model import build_model

torch.set_num_threads(2)

ARCH = "seamless-m4t-large-v2"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, T = 2, 20, 10          # batch, source frames, decoder prompt


def _ctx(dtype):
    return jax.disable_jit() if dtype == "bfloat16" else nullcontext()


def _close(t, j, tol, what):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _pair(dtype, seed=0):
    jcfg = jax_smoke_config(ARCH).with_(compute_dtype=dtype,
                                        kv_cache_dtype=dtype)
    tcfg = smoke_config(ARCH).with_(compute_dtype=dtype, kv_cache_dtype=dtype)
    assert jcfg == jcfg.__class__(**{f: getattr(tcfg, f)
                                     for f in tcfg.__dataclass_fields__})
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(B, S, 64)).astype(np.float32)
    toks = rng.integers(0, 256, (B, T + 4)).astype(np.int32)
    return src, toks


def test_smoke_seamless_keeps_two_encoder_layers():
    """The reference's smoke config cuts the encoder to 2 layers too."""
    cfg = smoke_config(ARCH)
    assert (cfg.n_encoder_layers, cfg.n_layers) == (2, 2)
    assert get_config(ARCH).n_encoder_layers == 24


@pytest.mark.parametrize("T_,d,offset", [(16, 64, 0), (9, 32, 7),
                                         (1, 1024, 300)])
def test_sinusoidal_matches_jax(T_, d, offset):
    ours = sinusoidal(T_, d, offset)
    assert ours.dtype == torch.float32 and ours.shape == (T_, d)
    _close(ours, jax_sinusoidal(T_, d, offset), 1e-5, "sinusoidal")
    # sines first, then cosines, not interleaved
    assert torch.allclose(ours[:, 0], torch.sin(torch.arange(T_) +
                                                torch.tensor(offset).float()))
    assert torch.allclose(ours[:, d // 2], torch.cos(
        torch.arange(T_) + torch.tensor(offset).float()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    jm, jp, tm, tp = _pair(dtype)
    src, _ = _inputs()
    jd = jnp.dtype(dtype)
    with _ctx(dtype):
        ref = jm.encode(jm._compute_cast(jp), jnp.asarray(src).astype(jd))
    before = flash_attention.launches
    mem = tm.encode(tp, torch.from_numpy(src))
    assert flash_attention.launches == before       # CPU: the plain version
    assert mem.shape == (B, S, 64) and str(mem.dtype).endswith(dtype)
    _close(mem, ref, TOL[dtype], "encode")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_jax(dtype):
    jm, jp, tm, tp = _pair(dtype)
    src, toks = _inputs(1)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    jbatch = {"src_embeds": jnp.asarray(src), "tokens": jnp.asarray(toks),
              "labels": jnp.asarray(labels)}
    tbatch = {"src_embeds": torch.from_numpy(src),
              "tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)}
    with _ctx(dtype):
        jl, jaux = jm.forward(jp, jbatch)
        jloss = jm.loss(jp, jbatch)
    tl, aux = tm.forward(tp, tbatch)
    assert tl.shape == (B, T + 4, 256) and str(tl.dtype).endswith(dtype)
    assert float(aux) == float(jaux) == 0.0
    _close(tl, jl, TOL[dtype], "forward")
    loss = tm.loss(tp, tbatch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    _close(loss, jloss, TOL[dtype], "loss")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_cache_init_matches_jax(dtype):
    jm, jp, tm, tp = _pair(dtype)
    src, _ = _inputs(2)
    jd = jnp.dtype(dtype)
    with _ctx(dtype):
        jempty = jm.decode_cache_init(B, 16)
        jmem = jm.encode(jm._compute_cast(jp), jnp.asarray(src).astype(jd))
        jfull = jm.decode_cache_init(B, 16, memory=jmem, params=jp)
    empty = tm.decode_cache_init(B, 16)
    full = tm.decode_cache_init(B, 16, memory=tm.encode(
        tp, torch.from_numpy(src)), params=tp)
    for ours, ref, what in ((empty, jempty, "no memory"),
                            (full, jfull, "memory")):
        flat, jflat = _flatten(ours), jax_flatten(
            jax.tree.map(np.asarray, ref))
        assert sorted(flat) == sorted(jflat) == [
            "cross_k", "cross_v", "self/k", "self/v"], what
        for key, j in jflat.items():
            t = {"cross_k": ours["cross_k"], "cross_v": ours["cross_v"],
                 "self/k": ours["self"]["k"],
                 "self/v": ours["self"]["v"]}[key]
            assert tuple(t.shape) == j.shape, f"{what} {key}"
            assert str(t.dtype).endswith(dtype), f"{what} {key}"
            _close(t, j, TOL[dtype], f"{what} {key}")
    assert empty["cross_k"].shape == (2, B, 2, 1, 16)
    assert full["cross_k"].shape == (2, B, 2, S, 16)
    assert not full["cross_k"].eq(0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prompt_and_decode_steps_match_jax_and_forward(dtype):
    """A 10-token decoder prompt through one ``decode_step`` at pos 0
    (the cached branch at T > 1), then 4 one-token steps. Each step's
    logits and cache against the reference's, and against the port's own
    ``forward`` over the tokens so far."""
    jm, jp, tm, tp = _pair(dtype)
    src, toks = _inputs(3)
    tol = TOL[dtype]
    jd = jnp.dtype(dtype)
    with _ctx(dtype):
        jmem = jm.encode(jm._compute_cast(jp), jnp.asarray(src).astype(jd))
        jc = jm.decode_cache_init(B, 16, memory=jmem, params=jp)
    mem = tm.encode(tp, torch.from_numpy(src))
    cache = tm.decode_cache_init(B, 16, memory=mem, params=tp)
    ck = cache["self"]["k"]
    pos, n = 0, T
    while pos + n <= T + 4:
        with _ctx(dtype):
            jd_, jc = jm.decode_step(
                jp, {"tokens": jnp.asarray(toks[:, pos:pos + n])}, jc, pos)
        out, cache = tm.decode_step(
            tp, {"tokens": torch.from_numpy(toks[:, pos:pos + n])}, cache,
            pos)
        assert cache["self"]["k"] is ck                # written in place
        assert out.shape == (B, n, 256)
        _close(out, jd_, tol, f"decode at {pos}")
        _close(cache["self"]["k"], jc["self"]["k"], tol, f"cache k at {pos}")
        _close(cache["self"]["v"], jc["self"]["v"], tol, f"cache v at {pos}")
        full, _ = tm.forward(tp, {"src_embeds": torch.from_numpy(src),
                                  "tokens": torch.from_numpy(
                                      toks[:, :pos + n])})
        np.testing.assert_allclose(out.float().numpy(),
                                   full[:, pos:].float().numpy(), rtol=tol,
                                   atol=tol, err_msg=f"forward at {pos}")
        pos, n = pos + n, 1


def test_build_model_dispatch():
    cfg = smoke_config(ARCH)
    m = build_model(cfg, attn_impl="xla", scan_impl="xla", moe_impl="xla",
                    mla_absorbed=True, device="cpu")
    assert type(m) is EncDecLM and m.attn_impl == "xla"
    assert type(build_model(smoke_config("qwen2-vl-72b"),
                            device="cpu")) is LM
    with pytest.raises(ValueError):
        EncDecLM(smoke_config("qwen3-0.6b"), device="cpu")
    with pytest.raises(NotImplementedError):
        LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="no prefill"):
        ServeLoop(cfg, device="cpu")


def test_init_layout_bridge_and_checkpoint_keys_match_jax():
    """``EncDecLM.init``'s tree (enc, dec with self and cross) has the
    reference's names and shapes, bridges leaf for leaf, and the port's
    checkpoint manager flattens it to the reference's keys."""
    jcfg = jax_smoke_config(ARCH)
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jflat = jax_flatten(jax.tree.map(np.asarray, jp))
    ours = EncDecLM(smoke_config(ARCH), device="cpu").init(
        torch.Generator().manual_seed(0))
    flat = _flatten(ours)
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in jflat.items()}
    assert all(v.dtype == np.float32 for v in flat.values())
    assert "dec/cross/wq" in flat and "enc/attn/wo" in flat
    bridged = _flatten(params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    assert sorted(bridged) == sorted(jflat)
    for key, j in jflat.items():
        assert bridged[key].tobytes() == j.tobytes(), key
    bf16 = EncDecLM(smoke_config(ARCH), device="cpu").init(
        torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert bf16["dec"]["cross"]["wk"].dtype == torch.bfloat16
    assert bf16["final_norm"].dtype == torch.float32
