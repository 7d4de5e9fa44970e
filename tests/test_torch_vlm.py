"""The port's M-RoPE and embedding inputs (qwen2-vl-72b, family "vlm")
against the JAX package's, on the reference's own params (bridged) and the
same inputs, at the smoke size (2 layers, d 64, 4 heads over 2 of 16).

``apply_mrope`` at D = 16 and 128; ``LM.forward`` from embeddings and 3-D
positions and from tokens; ``prefill`` and ``decode_step`` with the
positions in the batch; the port's ``ServeLoop`` against the reference's.
Positions are drawn so that t, h and w differ everywhere: three equal rows
would hide a wrong section split. fp32 is held at 1e-4; bf16 at 2e-2
against the reference run op by op (``jax.disable_jit``).
"""
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten as jax_flatten
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import ServeLoop as JaxServeLoop
from repro.models.common import apply_mrope as jax_apply_mrope
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch.serve import Request, ServeLoop
from repro_torch.models.common import apply_mrope, apply_rope
from repro_torch.models.model import build_model

torch.set_num_threads(2)

ARCH = "qwen2-vl-72b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, T = 2, 12


def _ctx(dtype):
    return jax.disable_jit() if dtype == "bfloat16" else nullcontext()


def _close(t, j, tol, what):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _positions(rng, B_, T_, start=0):
    """[B, 3, T] int32 positions whose t, h and w rows differ at every
    token: t counts up from ``start``, h and w are drawn."""
    t = np.arange(start, start + T_)[None].repeat(B_, 0)
    h = t + rng.integers(1, 40, (B_, T_))
    w = t + rng.integers(41, 90, (B_, T_))
    return np.stack([t, h, w], axis=1).astype(np.int32)


def _pair(dtype, **over):
    jcfg = jax_smoke_config(ARCH).with_(compute_dtype=dtype,
                                        kv_cache_dtype=dtype, **over)
    tcfg = smoke_config(ARCH).with_(compute_dtype=dtype, kv_cache_dtype=dtype,
                                    **over)
    assert jcfg == jcfg.__class__(**{f: getattr(tcfg, f)
                                     for f in tcfg.__dataclass_fields__})
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 128])
def test_apply_mrope_matches_jax(D, dtype):
    rng = np.random.default_rng(D)
    x = rng.normal(size=(B, T, 3, D)).astype(np.float32)
    pos = _positions(rng, B, T, start=5)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    ref = jax_apply_mrope(jx, jnp.asarray(pos), theta=1e6)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(DTYPES[dtype])
    ours = apply_mrope(tx, torch.from_numpy(pos), theta=1e6)
    assert ours.dtype == DTYPES[dtype] and ours.shape == tx.shape
    _close(ours, ref, 1e-5 if dtype == "float32" else 1e-2, f"mrope {D}")
    # each section turns by its own coordinate: (44, 10, 10) at D = 128
    d6 = D // 2 // 3
    sections = (D // 2 - 2 * d6, d6, d6)
    edges = np.cumsum((0,) + sections)
    for i in range(3):
        one = torch.from_numpy(pos[:, i])
        rot = apply_rope(tx, one, 1e6).float()
        for half in (0, D // 2):
            cols = slice(half + edges[i], half + edges[i + 1])
            assert torch.allclose(ours.float()[..., cols], rot[..., cols]), i
    # equal rows reduce to RoPE
    flat = torch.from_numpy(pos[:, :1].repeat(3, 1))
    assert torch.equal(apply_mrope(tx, flat, theta=1e6),
                       apply_rope(tx, flat[:, 0], 1e6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inputs", ["embeds", "tokens"])
def test_forward_matches_jax(inputs, dtype):
    """From embeddings with 3-D positions (the stubbed vision frontend's
    output) and from tokens with the broadcast positions."""
    jm, jp, tm, tp = _pair(dtype)
    rng = np.random.default_rng(1)
    if inputs == "embeds":
        emb = rng.normal(size=(B, T, 64)).astype(np.float32)
        pos = _positions(rng, B, T)
        jb = {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)}
        tb = {"embeds": torch.from_numpy(emb),
              "positions": torch.from_numpy(pos)}
    else:
        toks = rng.integers(0, 256, (B, T)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
            toks)}
    with _ctx(dtype):
        jl, _ = jm.forward(jp, jb)
    before = flash_attention.launches
    tl, aux = tm.forward(tp, tb)
    assert flash_attention.launches == before       # CPU: the plain version
    assert float(aux) == 0.0
    assert tl.shape == (B, T, 256) and str(tl.dtype).endswith(dtype)
    _close(tl, jl, TOL[dtype], f"forward from {inputs}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_with_batch_positions_match_jax(dtype):
    """Prefill from embeddings at 3-D positions, then 3 greedy token steps
    whose positions come from the batch (as the reference's ``decode_step``
    takes them under M-RoPE), each side feeding its own argmax."""
    jm, jp, tm, tp = _pair(dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(B, T, 64)).astype(np.float32)
    pos = _positions(rng, B, T)
    with _ctx(dtype):
        jl, jc = jm.prefill(jp, {"embeds": jnp.asarray(emb),
                                 "positions": jnp.asarray(pos)}, max_len=20)
    tl, tc = tm.prefill(tp, {"embeds": torch.from_numpy(emb),
                             "positions": torch.from_numpy(pos)}, max_len=20)
    _close(tl, jl, tol, "prefill")
    flat, jflat = _flatten(tc), jax_flatten(jax.tree.map(np.asarray, jc))
    assert sorted(flat) == sorted(jflat) == ["k", "v"]
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jflat[key].shape == (2, B, 2, 20, 16)
        _close(tc[key], jc[key], tol, f"prefill cache {key}")
    jlast = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    tlast = tl[:, -1].argmax(-1)[:, None]
    nxt = pos[:, :, -1:].max(axis=1, keepdims=True) + 1    # [B, 1, 1]
    for step in range(3):
        p = np.concatenate([nxt + step, nxt + 2 * step + 1,
                            nxt + 3 * step + 2], axis=1).astype(np.int32)
        with _ctx(dtype):
            jd, jc = jm.decode_step(jp, {"tokens": jnp.asarray(jlast),
                                         "positions": jnp.asarray(p)},
                                    jc, T + step)
        td, tc = tm.decode_step(tp, {"tokens": tlast,
                                     "positions": torch.from_numpy(p)},
                                tc, T + step)
        assert np.array_equal(tlast.numpy(), jlast)
        _close(td, jd, tol, f"decode step {step}")
        for key in ("k", "v"):
            _close(tc[key], jc[key], tol, f"decode step {step} cache {key}")
        jlast = np.asarray(jnp.argmax(jd[:, 0], -1))[:, None].astype(np.int32)
        tlast = td[:, 0].argmax(-1)[:, None]


def test_decode_without_positions_takes_pos_on_all_three():
    """With no positions in the batch, a decode step rotates by ``pos`` on
    t, h and w, which is the step with [pos, pos, pos] given."""
    _, _, tm, tp = _pair("float32")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (B, T)))
    _, cache = tm.prefill(tp, {"tokens": toks}, max_len=T + 1)
    saved = {k: v.clone() for k, v in cache.items()}
    a, _ = tm.decode_step(tp, {"tokens": toks[:, :1]}, cache, T)
    b, _ = tm.decode_step(tp, {"tokens": toks[:, :1],
                               "positions": torch.full((B, 3, 1), T)},
                          saved, T)
    assert torch.equal(a, b)


def test_serve_loop_matches_jax_tokens():
    """The port's ServeLoop on smoke qwen2-vl-72b (token prompts, the
    broadcast M-RoPE positions) with the reference ServeLoop's params gives
    the reference ServeLoop's tokens and pager stats, in fp32 so that no
    greedy tie flips."""
    fp32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
    jcfg = jax_smoke_config(ARCH).with_(**fp32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 12, dtype=np.int32) for _ in range(6)]
    jloop = JaxServeLoop(jcfg, batch_slots=2, max_len=32, hbm_pages=3)
    jout = jloop.run([JaxRequest(i, p, max_new_tokens=4)
                      for i, p in enumerate(prompts)])
    params = params_from_numpy(jax.tree.map(np.asarray, jloop.params),
                               device="cpu")
    loop = ServeLoop(smoke_config(ARCH).with_(**fp32), batch_slots=2,
                     max_len=32, hbm_pages=3, params=params, device="cpu")
    out = loop.run([Request(i, p, max_new_tokens=4)
                    for i, p in enumerate(prompts)])
    assert len(out) == 6 and all(len(v) == 4 for v in out.values())
    assert out == jout
    assert loop.stats["offloads"] > 0
    for key in ("offloads", "fetches", "offload_bytes", "prefill_tokens",
                "decode_tokens"):
        assert loop.stats[key] == jloop.stats[key], key


def test_config_is_the_reference_copy():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.rope, cfg.embed_inputs, cfg.n_layers,
            cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab) == ("vlm", "mrope", True, 80, 8192, 64, 8,
                                     128, 29568, 152064)
