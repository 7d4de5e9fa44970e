"""Parallelism presets change where tensors live, never what is computed:
the port's sharded runs on eight CPU ranks against the JAX package's
single-device values.

The ranks are gloo processes (``_torch_ranks``: a ``FileStore`` in
``tmp_path``, no network) on a (2, 4) ("data", "model") mesh; params and
batches are DTensors with ``launch/mesh``'s placements and every step runs
under ``sharding.use_rules``. The reference's own sharded runs cannot be
had here: under JAX 0.9.0 its 8-device tests fail in the reference itself
(``tests/test_presets.py``, ``tests/test_system.py``; ROADMAP queue 3), so
the port is held to the reference's single-device loss on bridged params,
the criterion of the reference's presets test.

- The reference presets test's smoke deepseek-v2-lite-16b (fp32, 4 heads
  over 4, d_model 64, 8 experts, top-2, capacity factor 8): the loss under
  fsdp_tp, dp, fsdp_tp_sp and serve_2d, and through the
  ``expert_parallel_shardmap`` mesh branch, within 1e-4 max(|ref|, 1).
- GQA with fewer kv heads than "model" ranks: smoke glm4-9b (4 heads over
  2, d_model 64), one fsdp_tp train step: the loss, every gradient and
  every updated param at the reference's 3e-4. The same step for smoke
  rwkv6-3b and recurrentgemma-9b (fp32), and for smoke deepseek through
  the ``expert_parallel_shardmap`` mesh branch.
- World size 1 (the card's case): for every family, the sharded loss and
  gradients, and ``run_training(mesh=)``'s losses, equal the unsharded
  ones bit for bit.

Each sharded backward runs on a thread of its own, as a CUDA backward runs
on autograd's device thread, where ``use_rules`` is not set.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from repro.configs import smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model
from repro.optim import make_train_step as jax_make_train_step
from repro.optim.train_state import make_train_state as jax_train_state
from repro_torch.configs import ARCH_IDS

torch.set_num_threads(2)

PRESETS = ["fsdp_tp", "dp", "fsdp_tp_sp", "serve_2d"]
MOE = dict(compute_dtype="float32", n_heads=4, kv_heads=4, d_model=64,
           n_experts=8, top_k=2, capacity_factor=8.0)
GQA = dict(n_heads=4, kv_heads=2, d_model=64, compute_dtype="float32")


def _inputs(tmp, arch, over, B, T, seed=0):
    cfg = jax_smoke_config(arch).with_(**over)
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
             for k in ("tokens", "labels")}
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    np.savez(tmp / "params.npz",
             **_torch_ranks.flatten(jax.tree.map(np.asarray, params)))
    np.savez(tmp / "batch.npz", **batch)
    return cfg, params, {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def moe_losses(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("presets")
    cfg, params, batch = _inputs(tmp, "deepseek-v2-lite-16b", MOE, 8, 16)
    ranks = _torch_ranks.start(
        {"kind": "losses", "arch": "deepseek-v2-lite-16b", "overrides": MOE,
         "mesh": [2, 4], "params": str(tmp / "params.npz"),
         "batch": str(tmp / "batch.npz"), "presets": PRESETS,
         "shardmap": True}, tmp, 8)
    # the single-device loss, the same whatever the preset
    single = float(jax_build_model(cfg).loss(params, batch))
    ref = {p: single for p in PRESETS}
    ref["shardmap"] = float(jax_build_model(
        cfg.with_(moe_strategy="expert_parallel_shardmap")).loss(
            params, batch))
    return ref, _torch_ranks.finish(ranks)


@pytest.mark.parametrize("preset", PRESETS + ["shardmap"])
def test_sharded_loss_matches_the_single_device_reference(moe_losses,
                                                          preset):
    ref, got = moe_losses
    loss = float(got[preset])
    assert abs(loss - ref[preset]) <= 1e-4 * max(abs(ref[preset]), 1.0), (
        preset, loss, ref[preset])


def _train_step(tmp, arch, over, T):
    """One fsdp_tp train step of smoke ``arch`` on the (2, 4) mesh against
    the reference's single-device ``value_and_grad`` and train step."""
    cfg, params, batch = _inputs(tmp, arch, over, 8, T)
    ranks = _torch_ranks.start(
        {"kind": "train_step", "arch": arch, "overrides": over,
         "mesh": [2, 4], "params": str(tmp / "params.npz"),
         "batch": str(tmp / "batch.npz"), "presets": ["fsdp_tp"]}, tmp, 8)
    model = jax_build_model(cfg)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
    new_state, _ = jax.jit(jax_make_train_step(model.loss))(
        jax_train_state(params), batch)
    got = _torch_ranks.finish(ranks)
    flat = lambda t: _torch_ranks.flatten(jax.tree.map(np.asarray, t))
    return float(loss), flat(grads), flat(new_state.params), got


def _check_loss(step):
    loss, _, _, got = step
    for key in ("loss", "step_loss"):
        assert abs(float(got[key]) - loss) <= 3e-4 * max(abs(loss), 1.0)


def _check_gradients(step):
    _, grads, _, got = step
    for name, g in grads.items():
        np.testing.assert_allclose(got["grad/" + name], g, rtol=3e-4,
                                   atol=3e-4 * np.abs(g).max(), err_msg=name)


def _check_updated_params(step):
    _, _, new, got = step
    for name, p in new.items():
        np.testing.assert_allclose(got["param/" + name], p, rtol=3e-4,
                                   atol=3e-4, err_msg=name)


@pytest.fixture(scope="module")
def gqa_step(tmp_path_factory):
    return _train_step(tmp_path_factory.mktemp("gqa"), "glm4-9b", GQA, 32)


def test_gqa_train_step_loss(gqa_step):
    _check_loss(gqa_step)


def test_gqa_train_step_gradients(gqa_step):
    _check_gradients(gqa_step)


def test_gqa_train_step_updated_params(gqa_step):
    _check_updated_params(gqa_step)


# weights that a kernel call takes whole on the batch axes (RWKV6's bonus u
# beside the GLA scan; the shardmap branch's expert weights beside dispatch
# and combine), whose gradients are partial sums over those axes
STEPS = {
    "rwkv6-3b": ("rwkv6-3b", dict(compute_dtype="float32")),
    "recurrentgemma-9b": ("recurrentgemma-9b",
                          dict(compute_dtype="float32")),
    "deepseek-shardmap": ("deepseek-v2-lite-16b",
                          dict(MOE, moe_strategy="expert_parallel_shardmap")),
}


@pytest.fixture(scope="module", params=list(STEPS))
def step(request, tmp_path_factory):
    arch, over = STEPS[request.param]
    return _train_step(tmp_path_factory.mktemp(request.param), arch, over,
                       16)


def test_train_step_loss(step):
    _check_loss(step)


def test_train_step_gradients(step):
    _check_gradients(step)


def test_train_step_updated_params(step):
    _check_updated_params(step)


@pytest.fixture(scope="module")
def same_bits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("same_bits")
    return _torch_ranks.run({"kind": "same_bits", "archs": ARCH_IDS,
                             "mesh": [1, 1]}, tmp, 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_world_size_one_gives_the_unsharded_bits(same_bits, arch):
    grads_equal, losses_equal = same_bits[arch]
    assert grads_equal, "loss or gradients differ"
    assert losses_equal, "run_training's losses differ"
