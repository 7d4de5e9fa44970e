"""The port's MoE block against the JAX package's, on the reference's own
params (bridged): ``blocks.moe_apply`` with impl "xla" (the dense dispatch
mask) and "kernel" (the shuffle kernels' contract; their plain versions on
the CPU), on smoke grok-1-314b and smoke deepseek-v2-lite-16b (one shared
expert), at capacity factor 1.0 (pairs dropped) and 4.0 (none), and at
T = 1 (capacity 4, as in decode). The routed expert ids are held equal
first: a flipped top-k choice changes a token's whole output.

fp32 is held at the reference's MoE tolerance, 1e-5; bf16 at 2e-2 against
the reference run op by op (``jax.disable_jit``), as the model tests do.
Also: mirrors of tests/test_moe_shardmap.py against the port's
``moe_shardmap`` at world size 1.
"""
import types
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import blocks as jax_blocks
from repro.models.moe_shardmap import _dispatch_indices as jax_indices
from repro.models.moe_shardmap import moe_shardmap_apply as jax_shardmap
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.shuffle_dispatch.ops import compute_slots
from repro_torch.models import blocks
from repro_torch.models.moe_shardmap import (_dispatch_indices,
                                             moe_shardmap_apply)

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ARCHS = ["grok-1-314b", "deepseek-v2-lite-16b"]


def _cfgs(arch, dtype, cf):
    """The JAX package's smoke config and the same config in the port's
    schema (deepseek is not ported as a model: MLA; its MoE block is)."""
    j = jax_smoke_config(arch).with_(compute_dtype=dtype, capacity_factor=cf)
    return j, ArchConfig(**{f: getattr(j, f) for f in j.__dataclass_fields__})


def _block(arch, dtype, cf, B, T, seed=0):
    """Reference params (rank >= 2 leaves in ``dtype``, as the compute cast
    leaves them) and input, and their port copies."""
    jcfg, tcfg = _cfgs(arch, dtype, cf)
    p, _ = jax_blocks.moe_init(jax.random.PRNGKey(seed), jcfg)
    jd = jnp.dtype(dtype)
    p = jax.tree.map(lambda w: w.astype(jd) if w.ndim >= 2 else w, p)
    x = np.random.default_rng(seed).normal(size=(B, T, jcfg.d_model))
    jx = jnp.asarray(x, jd)
    tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    tx = torch.from_numpy(np.array(jx, np.float32)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jcfg, tcfg, p, jx, tp, tx


def _jax_routing(p, jx, cfg):
    """The reference's routing, op for op as its moe_apply has it: expert
    ids [B, T, K] and the per-row slots of its cumsum."""
    h = jax_blocks.apply_norm(cfg, p.get("norm"), jx)
    logits = jnp.einsum("btd,de->bte", h, p["w_router"]).astype(jnp.float32)
    _, eid = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    B, T, K = eid.shape
    flat = jax.nn.one_hot(eid, cfg.n_experts, dtype=jnp.int32).reshape(
        B, T * K, cfg.n_experts)
    slot = ((jnp.cumsum(flat, axis=1) - flat) * flat).sum(-1)
    return np.asarray(eid), np.asarray(slot).reshape(B, T, K)


def _close(t, j, tol, what):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T", [(2, 32), (3, 1)])
@pytest.mark.parametrize("cf", [1.0, 4.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, cf, B, T, dtype):
    jcfg, tcfg, p, jx, tp, tx = _block(arch, dtype, cf, B, T)
    ctx = jax.disable_jit() if dtype == "bfloat16" else nullcontext()
    with ctx:
        jy, jaux = jax_blocks.moe_apply(p, jx, cfg=jcfg)
        jeid, jslot = _jax_routing(p, jx, jcfg)
    # routing first: the same experts for every (token, k)
    h = blocks.apply_norm(tcfg, tp.get("norm"), tx)
    _, _, eid = blocks.moe_route(tp["w_router"], h, tcfg.top_k)
    assert np.array_equal(eid.numpy(), jeid)
    # the kernels' flat contract gives the reference's per-row slots
    E = tcfg.n_experts
    flat = (eid + E * torch.arange(B)[:, None, None]).reshape(B * T, -1)
    slot = compute_slots(flat, B * E, blocks._capacity(tcfg, T))
    assert np.array_equal(slot.reshape(eid.shape).numpy(), jslot)
    # and counted per row, as moe_apply counts them
    assert np.array_equal(compute_slots(eid, E, blocks._capacity(tcfg, T)
                                        ).numpy(), jslot)
    C = blocks._capacity(tcfg, T)
    if cf == 1.0 and T > 1:
        assert (jslot >= C).any()          # pairs dropped, as meant
    for impl in ("xla", "kernel"):
        y, aux = blocks.moe_apply(tp, tx, cfg=tcfg, impl=impl)
        assert y.dtype == tx.dtype and aux.dtype == torch.float32
        _close(y, jy, TOL[dtype], f"{impl} y")
        _close(aux, jaux, 1e-5, f"{impl} aux")


def test_kernel_and_xla_impls_agree_bit_for_bit_in_bf16():
    """With unique slots the kernel path sums the same products in the same
    order as the dense mask: bf16 outputs are identical."""
    _, tcfg, _, _, tp, tx = _block("grok-1-314b", "bfloat16", 1.0, 2, 32)
    yk, ak = blocks.moe_apply(tp, tx, cfg=tcfg, impl="kernel")
    yx, ax = blocks.moe_apply(tp, tx, cfg=tcfg, impl="xla")
    assert torch.equal(yk, yx) and torch.equal(ak, ax)
    with pytest.raises(ValueError):
        blocks.moe_apply(tp, tx, cfg=tcfg, impl="pallas")


def test_moe_init_has_the_reference_layout():
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b", "float32", 1.25)
    ref, _ = jax_blocks.moe_init(jax.random.PRNGKey(0), jcfg)
    ours = blocks.moe_init(torch.Generator().manual_seed(0), tcfg, lead=(3,))
    assert sorted(ours) == sorted(ref) and sorted(ours["shared"]) == \
        sorted(ref["shared"])
    for k in ("w_router", "w1", "w3", "w2", "norm"):
        assert tuple(ours[k].shape) == (3, *ref[k].shape), k
    for k in ("w1", "w3", "w2"):
        assert tuple(ours["shared"][k].shape) == (3, *ref["shared"][k].shape)
    bf = blocks.moe_init(torch.Generator().manual_seed(0), tcfg,
                         dtype=torch.bfloat16)
    assert bf["w1"].dtype == torch.bfloat16 and bf["norm"].dtype == \
        torch.float32                      # [d]: the compute cast leaves it


# -- moe_shardmap at world size 1 ---------------------------------------------------
def test_dispatch_indices_group_and_cap():
    """Mirror of tests/test_moe_shardmap.py::test_dispatch_indices_group_and_cap,
    and the reference's indices on a random draw."""
    eid = torch.tensor([2, 0, 2, 1, 2, 0], dtype=torch.int32)
    idx, valid = _dispatch_indices(eid, E=3, C=2)
    assert idx[0, 0] == 1 and idx[0, 1] == 5
    assert idx[1, 0] == 3 and not valid[1, 1]
    assert valid[2].all()
    assert set(idx[2].tolist()) <= {0, 2, 4}
    r = np.random.default_rng(3).integers(0, 5, size=40).astype(np.int32)
    ours = _dispatch_indices(torch.from_numpy(r), 5, 12)
    ref = jax_indices(jnp.asarray(r), 5, 12)
    for o, j in zip(ours, ref):
        assert np.array_equal(o.numpy(), np.asarray(j))
    # the grouping _local_moe runs through the kernels: flat position
    # idx[e, c] is the pair with expert e and slot c
    idx, valid = ours
    slot = compute_slots(torch.from_numpy(r)[:, None], 5, 12)[:, 0]
    e, c = torch.nonzero(valid, as_tuple=True)
    assert torch.equal(torch.from_numpy(r)[idx[e, c]].long(), e)
    assert torch.equal(slot[idx[e, c]].long(), c)
    assert int(valid.sum()) == int((slot < 12).sum())


@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_shardmap_matches_jax(cf):
    """The port's world-size-1 path against the reference's no-mesh path
    (deepseek's MoE block, fp32): y and aux. At capacity factor 4 nothing
    is dropped, and it also equals the einsum MoE (the mirror of
    test_matches_einsum_moe_no_drops); at 1 the global flat capacity drops
    pairs."""
    jcfg, tcfg, p, jx, tp, tx = _block("deepseek-v2-lite-16b", "float32", cf,
                                       2, 16)
    jy, jaux = jax_shardmap(p, jx, cfg=jcfg, mesh=None)
    y, aux = moe_shardmap_apply(tp, tx, cfg=tcfg)
    _close(y, jy, 1e-5, "y")
    _close(aux, jaux, 1e-5, "aux")
    if cf == 4.0:
        ye, _ = blocks.moe_apply(tp, tx, cfg=tcfg, impl="kernel")
        np.testing.assert_allclose(y.numpy(), ye.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # a mesh without a "model" axis takes the single-device branch too
    no_model = types.SimpleNamespace(mesh_dim_names=("data",), shape=(1,))
    y1, aux1 = moe_shardmap_apply(tp, tx, cfg=tcfg, mesh=no_model)
    assert torch.equal(y1, y) and torch.equal(aux1, aux)
