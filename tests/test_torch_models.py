"""The port's dense LM against the JAX package's on bridged params: forward,
prefill and three decode steps of smoke qwen3-0.6b and glm4-9b.

fp32 is held at 1e-4 (two layers of fp32 sums taken in another order). bf16
is held at 2e-2 against the reference run op by op (``jax.disable_jit``):
XLA's fusions in the compiled reference keep some bf16 intermediates in fp32,
so the compiled reference lands outside 2e-2 of its own op-by-op run (a test
below pins this), while an eager framework rounds after every op as written.
"""
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.models import common
from repro_torch.models.lm import LM
from repro_torch.models.model import build_model

torch.set_num_threads(2)

ARCHS = ["qwen3-0.6b", "glm4-9b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _pair(arch, dtype):
    jcfg = jax_smoke_config(arch).with_(compute_dtype=dtype,
                                        kv_cache_dtype=dtype)
    tcfg = smoke_config(arch).with_(compute_dtype=dtype, kv_cache_dtype=dtype)
    assert jcfg == jcfg.__class__(**{f: getattr(tcfg, f)
                                     for f in tcfg.__dataclass_fields__})
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _close(t, j, tol, what):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(arch, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    tol = TOL[dtype]
    toks = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(np.int32)

    def ctx():
        return jax.disable_jit() if dtype == "bfloat16" else nullcontext()

    with ctx():
        jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
        jpl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=20)
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    tpl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len=20)
    assert tl.shape == (2, 12, 256) and float(aux) == 0.0
    _close(tl, jl, tol, "forward")
    _close(tpl, jpl, tol, "prefill")
    assert tc["k"].shape == tuple(jc["k"].shape)
    _close(tc["k"], jc["k"], tol, "prefill cache k")
    # three greedy decode steps, each side feeding its own argmax
    jlast = np.asarray(jnp.argmax(jpl[:, -1], -1))[:, None].astype(np.int32)
    tlast = tpl[:, -1].argmax(-1)[:, None]
    for step in range(3):
        with ctx():
            jd, jc = jm.decode_step(jp, {"tokens": jnp.asarray(jlast)}, jc,
                                    12 + step)
        td, tc = tm.decode_step(tp, {"tokens": tlast}, tc, 12 + step)
        assert np.array_equal(tlast.numpy(), jlast)
        _close(td, jd, tol, f"decode step {step}")
        jlast = np.asarray(jnp.argmax(jd[:, 0], -1))[:, None].astype(np.int32)
        tlast = td[:, 0].argmax(-1)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_bf16_reference_is_outside_tolerance_of_its_op_by_op_run(
        arch):
    """Why the bf16 parity above runs the reference op by op: compiled, the
    reference itself lands outside 2e-2 of its own op-by-op logits."""
    jm, jp, _, _ = _pair(arch, "bfloat16")
    toks = jnp.asarray(np.random.default_rng(0).integers(0, 256, (2, 12)),
                       jnp.int32)
    compiled = np.asarray(jm.forward(jp, {"tokens": toks})[0], np.float32)
    with jax.disable_jit():
        eager = np.asarray(jm.forward(jp, {"tokens": toks})[0], np.float32)
    assert not np.allclose(compiled, eager, rtol=2e-2, atol=2e-2), \
        float(np.abs(compiled - eager).max())


def test_kernel_and_plain_attention_give_the_same_logits():
    _, _, tm, tp = _pair("qwen3-0.6b", "float32")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 9)))
    outs = [build_model(tm.cfg, attn_impl=impl, device="cpu").forward(
        tp, {"tokens": toks})[0] for impl in ("kernel", "xla", "naive")]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_bridge_round_trip_is_byte_identical_with_reference_names():
    cfg = jax_smoke_config("qwen3-0.6b")
    jp = jax_build_model(cfg).init(jax.random.PRNGKey(3))
    flat = _flatten(jax.tree.map(np.asarray, jp))
    back = _flatten(params_to_numpy(params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")))
    assert sorted(flat) == sorted(back)
    for key in flat:
        assert back[key].dtype == flat[key].dtype
        assert back[key].tobytes() == flat[key].tobytes(), key
    # bf16 leaves travel as their bytes
    jb = jnp.asarray(np.asarray(jp["embed"])[:4], jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(jb)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    out = params_to_numpy({"w": t})["w"]
    assert out.dtype == np.uint16
    assert out.tobytes() == np.asarray(jb).tobytes()


def test_init_has_the_reference_layout():
    cfg = jax_smoke_config("qwen3-0.6b")
    ref = _flatten(jax.tree.map(np.asarray,
                                jax_build_model(cfg).init(jax.random.PRNGKey(0))))
    model = LM(smoke_config("qwen3-0.6b"), device="cpu")
    ours = _flatten(params_to_numpy(model.init(torch.Generator().manual_seed(0))))
    assert {k: v.shape for k, v in ours.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == np.float32 for v in ours.values())


def test_compute_cast_is_idempotent_and_matches_the_reference():
    model = LM(smoke_config("glm4-9b"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    once = model._compute_cast(params)
    twice = model._compute_cast(once)
    assert once["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert once["layers"]["attn"]["norm"].dtype == torch.bfloat16   # [L, d]
    assert once["final_norm"].dtype == torch.float32                # [d]
    assert twice["layers"]["ffn"]["w1"] is once["layers"]["ffn"]["w1"]


def test_silu_rounds_like_the_reference_in_bf16():
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 3
    jx = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax.nn.silu(jx), np.float32)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).bfloat16()
    assert np.array_equal(common.silu(tx).float().numpy(), ref)


def test_unported_archs_raise():
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        if arch in ARCHS:
            assert get_config(arch).family == "dense"
        else:
            with pytest.raises(NotImplementedError):
                get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(NotImplementedError):
        LM(smoke_config("glm4-9b").with_(family="moe", n_experts=4),
           device="cpu")


def test_generator_must_live_on_the_model_device():
    model = LM(smoke_config("glm4-9b"), device="cpu")
    meta = type("G", (), {"device": torch.device("meta")})()
    with pytest.raises(ValueError):
        model.init(meta)
