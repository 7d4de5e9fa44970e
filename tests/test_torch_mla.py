"""The port's MLA (deepseek-v2's low-rank compressed KV attention) and smoke
deepseek-v2-lite-16b against the JAX package's, on the reference's own
params (bridged) and the same inputs.

``blocks.mla_apply`` in prefill (the expanded per-head K/V through
``flash_attention``, D = nope + rope = 24 and Dv = 16 at the smoke width),
in the expanded decode (per-head cache, ``attention_ref``) and in the
absorbed decode (latent cache, W_uk folded into q); ``mla_prefill_cache``
and ``mla_cache_init`` in both forms. fp32 is held at 1e-4; bf16 at 2e-2
against the reference run op by op (``jax.disable_jit``), as the model
tests do. Then the whole smoke LM: the mirror of tests/test_models.py's
``test_decode_matches_full_forward[deepseek-v2-lite-16b]`` and
``test_moe_aux_loss_nonzero``, and the absorbed decode against the
expanded one.
"""
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import smoke_config as jax_smoke_config
from repro.models import blocks as jax_blocks
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import blocks
from repro_torch.models.lm import LM
from repro_torch.models.model import build_model

torch.set_num_threads(2)

ARCH = "deepseek-v2-lite-16b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _ctx(dtype):
    return jax.disable_jit() if dtype == "bfloat16" else nullcontext()


def _close(t, j, tol, what):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _close_dicts(ours, ref, tol, what):
    assert sorted(ours) == sorted(ref), what
    for key, j in ref.items():
        assert tuple(ours[key].shape) == j.shape, f"{what} {key}"
        assert str(ours[key].dtype).split(".")[-1] == j.dtype.name, \
            f"{what} {key}"
        _close(ours[key], j, tol, f"{what} {key}")


def _block(dtype, B=2, T=12, seed=0):
    """The reference's MLA params (rank >= 2 leaves in ``dtype``, as the
    compute cast leaves them) and an input, and their port copies."""
    jcfg = jax_smoke_config(ARCH)
    tcfg = smoke_config(ARCH)
    p, _ = jax_blocks.mla_init(jax.random.PRNGKey(seed), jcfg)
    jd = jnp.dtype(dtype)
    p = jax.tree.map(lambda w: w.astype(jd) if w.ndim >= 2 else w, p)
    x = np.random.default_rng(seed).normal(size=(B, T, jcfg.d_model))
    jx = jnp.asarray(x, jd)
    tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    tx = torch.from_numpy(np.array(jx, np.float32)).to(DTYPES[dtype])
    return jcfg, tcfg, p, jx, tp, tx


def test_smoke_heads_are_mla_heads():
    """Smoke deepseek keeps MLA's shape: q and k of nope + rope = 24, v of
    16, H heads of K/V whatever ``kv_heads`` says (2)."""
    cfg = smoke_config(ARCH)
    assert (cfg.kv_lora, cfg.qk_nope_dim, cfg.qk_rope_dim,
            cfg.v_head_dim) == (32, 16, 8, 16)
    assert cfg.kv_heads == 2 and cfg.n_heads == 4
    jcfg = jax_smoke_config(ARCH)
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_prefill_matches_jax(dtype):
    jcfg, tcfg, p, jx, tp, tx = _block(dtype)
    pos = jnp.arange(jx.shape[1])
    with _ctx(dtype):
        jy, jc = jax_blocks.mla_apply(p, jx, cfg=jcfg, positions=pos,
                                      attn_impl="xla")
    assert jc is None
    before = flash_attention.launches
    for impl in ("kernel", "xla", "naive"):
        y, c = blocks.mla_apply(tp, tx, cfg=tcfg,
                                positions=torch.arange(tx.shape[1]),
                                attn_impl=impl)
        assert c is None and y.dtype == tx.dtype
        _close(y, jy, TOL[dtype], impl)
    assert flash_attention.launches == before          # CPU: plain version


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_cache_matches_jax(dtype, absorbed):
    """Both forms, padded (max_len past the prompt) and cut (max_len under
    it, as the reference's slice cuts it)."""
    jcfg, tcfg, p, jx, tp, tx = _block(dtype)
    T = jx.shape[1]
    for max_len in (20, 8):
        with _ctx(dtype):
            jc = jax_blocks.mla_prefill_cache(
                p, jx, cfg=jcfg, positions=jnp.arange(T), max_len=max_len,
                dtype=jnp.dtype(dtype), absorbed=absorbed)
        c = blocks.mla_prefill_cache(tp, tx, cfg=tcfg,
                                     positions=torch.arange(T),
                                     max_len=max_len, dtype=DTYPES[dtype],
                                     absorbed=absorbed)
        _close_dicts(c, {k: np.asarray(v) if v.dtype != jnp.bfloat16 else v
                         for k, v in jc.items()}, TOL[dtype],
                     f"max_len {max_len}")


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_cache_init_matches_jax(dtype, absorbed):
    jcfg, tcfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jc = jax_blocks.mla_cache_init(jcfg, 3, 16, jnp.dtype(dtype),
                                   absorbed=absorbed)
    c = blocks.mla_cache_init(tcfg, 3, 16, DTYPES[dtype], "cpu",
                              absorbed=absorbed)
    assert sorted(c) == sorted(jc)
    for key, j in jc.items():
        assert tuple(c[key].shape) == j.shape, key
        assert str(c[key].dtype).split(".")[-1] == j.dtype.name, key
        assert not c[key].any(), key


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(dtype, absorbed):
    """A prompt of 10 tokens packed into a cache of 14 slots, then 3 decode
    steps of one token at positions 10-12: each step's output and cache
    held to the reference's (the port writes its cache in place)."""
    jcfg, tcfg, p, jx, tp, tx = _block(dtype, T=13)
    T0, max_len = 10, 14
    with _ctx(dtype):
        jc = jax_blocks.mla_prefill_cache(
            p, jx[:, :T0], cfg=jcfg, positions=jnp.arange(T0),
            max_len=max_len, dtype=jnp.dtype(dtype), absorbed=absorbed)
    c = blocks.mla_prefill_cache(tp, tx[:, :T0], cfg=tcfg,
                                 positions=torch.arange(T0), max_len=max_len,
                                 dtype=DTYPES[dtype], absorbed=absorbed)
    for t in range(T0, 13):
        with _ctx(dtype):
            jy, jc = jax_blocks.mla_apply(
                p, jx[:, t:t + 1], cfg=jcfg, positions=jnp.arange(1) + t,
                cache=jc, pos=t, absorbed=absorbed)
        y, c2 = blocks.mla_apply(tp, tx[:, t:t + 1], cfg=tcfg,
                                 positions=torch.arange(1) + t, cache=c,
                                 pos=t, absorbed=absorbed)
        assert c2 is c                                  # written in place
        assert y.dtype == tx.dtype
        _close(y, jy, TOL[dtype], f"decode {t}")
        _close_dicts(c, {k: v for k, v in jc.items()}, TOL[dtype],
                     f"decode {t} cache")


def test_absorbed_and_expanded_decode_agree_in_fp32():
    """The two decodes of one layer compute one function: within 1e-4 of
    each other in fp32, step after step."""
    _, tcfg, _, _, tp, tx = _block("float32", T=14, seed=3)
    T0, max_len = 9, 16
    caches = {ab: blocks.mla_prefill_cache(
        tp, tx[:, :T0], cfg=tcfg, positions=torch.arange(T0),
        max_len=max_len, dtype=torch.float32, absorbed=ab)
        for ab in (False, True)}
    for t in range(T0, 14):
        ys = {ab: blocks.mla_apply(tp, tx[:, t:t + 1], cfg=tcfg,
                                   positions=torch.arange(1) + t,
                                   cache=caches[ab], pos=t, absorbed=ab)[0]
              for ab in (False, True)}
        np.testing.assert_allclose(ys[True].numpy(), ys[False].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {t}")


# -- the smoke LM -------------------------------------------------------------------
def _pair(dtype="float32", absorbed=False, **over):
    jcfg = jax_smoke_config(ARCH).with_(compute_dtype=dtype,
                                        kv_cache_dtype=dtype, **over)
    tcfg = smoke_config(ARCH).with_(compute_dtype=dtype,
                                    kv_cache_dtype=dtype, **over)
    jm = jax_build_model(jcfg, mla_absorbed=absorbed)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(tcfg, mla_absorbed=absorbed, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("absorbed", [False, True])
def test_decode_matches_full_forward_and_the_reference(absorbed):
    """Mirror of tests/test_models.py::test_decode_matches_full_forward for
    smoke deepseek-v2-lite-16b in fp32 at capacity factor 8 (no pair
    dropped): prefill of 10 tokens, then 4 decode steps, each held against
    ``forward`` and the reference's logits and caches, at 1e-4; for both
    decodes, as the reference's ``LM(mla_absorbed=...)`` runs them."""
    jm, jp, tm, tp = _pair(absorbed=absorbed, capacity_factor=8.0)
    B, T0, T = 2, 10, 14
    toks = np.random.default_rng(4).integers(0, 256, (B, T)).astype(np.int32)
    full, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    jfull, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    _close(full, jfull, 1e-4, "forward")
    _close(aux, jaux, 1e-5, "aux")
    pre, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :T0])},
                            max_len=T)
    jpre, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :T0])},
                              max_len=T)
    assert sorted(cache) == (["c_kv", "k_rope"] if absorbed else ["k", "v"])
    np.testing.assert_allclose(pre.numpy(), full[:, :T0].numpy(), rtol=1e-4,
                               atol=1e-4)
    _close(pre, jpre, 1e-4, "prefill")
    _close_dicts(cache, dict(jcache), 1e-4, "prefill cache")
    for t in range(T0, T):
        lg, cache = tm.decode_step(
            tp, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, cache, t)
        jlg, jcache = jm.decode_step(
            jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jcache, t)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4)
        _close(lg, jlg, 1e-4, f"decode {t}")
        _close_dicts(cache, dict(jcache), 1e-4, f"decode {t} cache")


def test_absorbed_and_expanded_lm_decodes_agree_in_fp32():
    """The whole smoke LM decodes the same logits both ways, within 1e-4."""
    _, _, tm, tp = _pair()
    ta = build_model(tm.cfg, mla_absorbed=True, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 15)))
    outs = {}
    for name, m in (("expanded", tm), ("absorbed", ta)):
        _, cache = m.prefill(tp, {"tokens": toks[:, :11]}, max_len=16)
        outs[name] = [m.decode_step(tp, {"tokens": toks[:, t:t + 1]}, cache,
                                    t)[0] for t in range(11, 15)]
    for a, e in zip(outs["absorbed"], outs["expanded"]):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=1e-4, atol=1e-4)


def test_moe_aux_loss_nonzero():
    """Mirror of tests/test_models.py::test_moe_aux_loss_nonzero: smoke
    deepseek's forward gives a positive aux loss, the reference's value."""
    jm, jp, tm, tp = _pair()
    toks = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32)
    _, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    assert float(aux) > 0
    _close(aux, jaux, 1e-5, "aux")


def test_kernel_and_plain_attention_give_the_same_logits():
    """Prefill attention through ``"kernel"`` (its plain version on the
    CPU), ``"xla"`` and ``"naive"`` at Dv != D: one set of logits."""
    _, _, tm, tp = _pair()
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 9)))
    outs = [build_model(tm.cfg, attn_impl=impl, device="cpu").forward(
        tp, {"tokens": toks})[0] for impl in ("kernel", "xla", "naive")]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_mla_bridge_round_trip_and_reference_layout():
    """MLA's leaves (wq [d, H, nope + rope], w_dkv, w_kr, w_uk, w_uv,
    kv_norm, wo [H, v, d]) cross the bridge byte for byte, and the port's
    own init has the reference's names, shapes and fp32."""
    cfg = jax_smoke_config(ARCH)
    jp = jax.tree.map(np.asarray, jax_build_model(cfg).init(
        jax.random.PRNGKey(3)))
    flat = _flatten(jp)
    L, d, H = cfg.n_layers, cfg.d_model, cfg.n_heads
    assert flat["layers/attn/wq"].shape == (L, d, H, 24)
    assert flat["layers/attn/wo"].shape == (L, H, 16, d)
    assert flat["layers/attn/kv_norm"].shape == (L, 32)
    back = _flatten(params_to_numpy(params_from_numpy(jp, device="cpu")))
    assert sorted(flat) == sorted(back)
    for key in flat:
        assert back[key].dtype == flat[key].dtype
        assert back[key].tobytes() == flat[key].tobytes(), key
    ours = _flatten(params_to_numpy(LM(smoke_config(ARCH), device="cpu").init(
        torch.Generator().manual_seed(0))))
    assert {k: v.shape for k, v in ours.items()} == \
        {k: v.shape for k, v in flat.items()}
    assert all(v.dtype == np.float32 for v in ours.values())


def test_decode_cache_init_matches_the_reference():
    for absorbed in (False, True):
        jm, _, tm, _ = _pair(absorbed=absorbed)
        cache, jcache = tm.decode_cache_init(3, 16), jm.decode_cache_init(3, 16)
        assert sorted(cache) == sorted(jcache)
        for key, j in jcache.items():
            assert tuple(cache[key].shape) == j.shape, key
            assert str(cache[key].dtype).split(".")[-1] == j.dtype.name, key
            assert not cache[key].any(), key


def test_full_config_builds_on_the_card_by_default(monkeypatch):
    """``LM(get_config("deepseek-v2-lite-16b"))`` wants the card: without
    CUDA it raises unless the CPU is asked for."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_lora,
            cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.n_experts,
            cfg.top_k, cfg.n_shared_experts, cfg.d_expert, cfg.vocab) == \
        (27, 2048, 16, 512, 128, 64, 128, 64, 6, 2, 1408, 102400)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg)
    assert LM(cfg, device="cpu").device.type == "cpu"
