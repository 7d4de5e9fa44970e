"""The port's cost counter (``launch/hlo_analysis.py``) and dry-run
(``launch/dryrun.py``) on the CPU, under a fake process group (no data
moves, ``meta`` tensors allocate nothing).

- The counter, as ``tests/test_hlo_analysis.py`` holds the reference's: a
  10-trip matmul loop counts 10 x one trip, nested loops multiply.
- On a fake (2, 4) mesh, DTensor's collectives are counted by type and by
  their local result bytes.
- Under the dp preset every product runs on a batch shard: per-device dot
  FLOPs x 8 equal the unsharded train step's exactly.
- Under fsdp_tp, smoke dense archs' per-device dot FLOPs are an eighth of
  the unsharded step's but for the k and v projections (2 kv heads over 4
  "model" ranks), as reckoned from the config.
- Smoke dense archs' unsharded loss: dot FLOPs equal the reference's
  ``analyze_hlo`` of a jit with no mesh (exactly, in these cases; the
  stated tolerance is 1e-6 relative).
- ``lower_cell`` at smoke size for all 10 archs x train, prefill, decode
  and a decode of batch 1 on a fake (2, 4) mesh: status ok, and the
  argument bytes equal the inputs' shard bytes reckoned from the rules and
  axes alone.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro.configs import smoke_config as jax_smoke_config
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import IMPLS, fake_group, lower_cell
from repro_torch.launch.hlo_analysis import CostCounter, count_costs
from repro_torch.launch.mesh import (batch_specs_for, cache_specs_for,
                                     make_mesh, param_specs, sharding_rules)
from repro_torch.models.lm import compute_cast, torch_dtype
from repro_torch.models.model import _on_meta, build_model, input_specs
from repro_torch.optim import make_train_state, make_train_step

torch.set_num_threads(2)

META = torch.device("meta")
MESH = (2, 4)
SMALL = {"train": ShapeConfig("t", 32, 8, "train"),
         "prefill": ShapeConfig("p", 32, 8, "prefill"),
         "decode": ShapeConfig("d", 32, 8, "decode"),
         # long_500k's batch of 1, which no mesh axis divides
         "decode_b1": ShapeConfig("d1", 32, 1, "decode")}


@pytest.fixture(scope="module")
def group():
    with fake_group(8):
        yield make_mesh(MESH, ("data", "model"), device_type="cpu")


def test_dot_flops_scale_with_loop_trip_count():
    x = torch.empty((32, 128), device=META)

    def f(w):
        y = x
        for wi in w:
            y = torch.tanh(y @ wi)
        return y.sum()

    one = 2 * 32 * 128 * 128
    for n in (1, 10):
        _, st = count_costs(f, torch.empty((n, 128, 128), device=META))
        assert st.dot_flops == n * one


def test_nested_loop_trip_counts_multiply():
    x = torch.empty((16, 64), device=META)
    w = torch.empty((3, 4, 64, 64), device=META)

    def f():
        y = x
        for wo in w:
            for wi in wo:
                y = torch.tanh(y @ wi)
        return y

    _, st = count_costs(f)
    assert st.dot_flops == 12 * 2 * 16 * 64 * 64
    # bytes: each matmul and tanh reads its operands and writes its result
    assert st.hbm_bytes > 0 and st.collective_count == {}


def test_collectives_counted_by_type_and_bytes(group):
    local = 4 * 64 * 4                      # [8 / 2, 64] fp32 on "data"
    x = distribute_tensor(torch.empty((8, 64), device=META), group,
                          [Shard(0), Replicate()], src_data_rank=None)
    with CostCounter() as c:
        x.redistribute(group, [Replicate(), Replicate()])
    assert c.stats.collective_count == {"all-gather": 1}
    assert c.stats.collective_bytes == {"all-gather": 2 * local}
    p = DTensor.from_local(torch.empty((8, 64), device=META), group,
                           [Replicate(), Partial()], run_check=False)
    with CostCounter() as c:
        p.redistribute(group, [Replicate(), Replicate()])
    assert c.stats.collective_count == {"all-reduce": 1}
    assert c.stats.collective_bytes == {"all-reduce": 8 * 64 * 4}
    with CostCounter() as c:
        p.redistribute(group, [Replicate(), Shard(0)])
    assert c.stats.collective_count == {"reduce-scatter": 1}
    assert c.stats.collective_bytes == {"reduce-scatter": 2 * 64 * 4}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "glm4-9b",
                                  "deepseek-v2-lite-16b", "rwkv6-3b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_dp_flops_per_device_are_an_eighth(group, arch):
    cfg = smoke_config(arch).with_(parallelism="dp")
    rec = lower_cell(arch, SMALL["train"], False, cfg=cfg, mesh_shape=MESH)
    model = _on_meta(cfg, build_model(cfg, device="cpu", **IMPLS))
    batch = input_specs(cfg, SMALL["train"])["batch"]
    with CostCounter() as c:
        make_train_step(model.loss)(make_train_state(model.init(None)), batch)
    assert rec["hlo"]["dot_flops"] * 8 == c.stats.dot_flops


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "glm4-9b", "olmo-1b"])
def test_fsdp_tp_flops_per_device_as_reckoned(group, arch):
    """Under fsdp_tp every product of the train step runs on an eighth of
    its work but the k and v projections, whose 2 kv heads do not divide
    over the 4 "model" ranks: those run on the "data" half."""
    cfg = smoke_config(arch).with_(parallelism="fsdp_tp")
    shape = SMALL["train"]
    rec = lower_cell(arch, shape, False, cfg=cfg, mesh_shape=MESH)
    model = _on_meta(cfg, build_model(cfg, device="cpu", **IMPLS))
    batch = input_specs(cfg, shape)["batch"]
    with CostCounter() as c:
        make_train_step(model.loss)(make_train_state(model.init(None)), batch)
    assert cfg.kv_heads == 2 and cfg.n_heads % MESH[1] == 0
    tokens = shape.global_batch * shape.seq_len
    kv = 3 * cfg.n_layers * 2 * (2 * tokens * cfg.d_model * cfg.kv_heads
                                 * cfg.head_dim)   # k and v, fwd + bwd
    want = c.stats.dot_flops / 8 + kv * (1 / MESH[0] - 1 / 8)
    assert rec["hlo"]["dot_flops"] == want


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "glm4-9b", "olmo-1b"])
def test_unsharded_loss_flops_equal_the_reference(arch):
    B, T = 4, 64
    jm = jax_build_model(jax_smoke_config(arch))
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    spec = jax.ShapeDtypeStruct((B, T), jnp.int32)
    text = jax.jit(jm.loss).lower(params, {"tokens": spec, "labels": spec}
                                  ).compile().as_text()
    ref = analyze_hlo(text).dot_flops
    cfg = smoke_config(arch)
    model = _on_meta(cfg, build_model(cfg, device="cpu", **IMPLS))
    ids = torch.empty((B, T), dtype=torch.int32, device=META)
    with torch.no_grad():
        _, st = count_costs(model.loss, model.init(None),
                            {"tokens": ids, "labels": ids})
    assert abs(st.dot_flops - ref) <= 1e-6 * ref, (st.dot_flops, ref)


def _shard_bytes(tree, specs, sizes):
    """Σ over leaves of rank 0's shard bytes under their specs (each
    sharded dim cut by its mesh axes in turn, the first shard the larger)."""
    if isinstance(tree, dict):
        return sum(_shard_bytes(tree[k], specs[k], sizes) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(_shard_bytes(t, s, sizes) for t, s in zip(tree, specs))
    if tree is None:
        return 0
    shape = list(tree.shape)
    for d, entry in enumerate(specs):
        for a in (() if entry is None else (entry,) if isinstance(
                entry, str) else entry):
            shape[d] = -(-shape[d] // sizes[a])
    n = 1
    for s in shape:
        n *= s
    return n * tree.element_size()


CELLS = [(arch, kind) for arch in ARCH_IDS for kind in SMALL]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_lower_cell_smoke(group, arch, kind):
    cfg = smoke_config(arch)
    rec = lower_cell(arch, SMALL[kind], False, cfg=cfg, mesh_shape=MESH)
    assert rec["status"] == "ok" and rec["mesh"] == "2x4"
    assert rec["hlo"]["dot_flops"] > 0 and rec["lower_s"] >= 0
    sizes = dict(zip(("data", "model"), MESH))
    rules = sharding_rules(cfg, group)
    model = _on_meta(cfg)
    params = model.init(None)
    pspec = param_specs(model, cfg, group, rules)
    specs = input_specs(cfg, SMALL[kind], model=model)
    want = _shard_bytes(specs["batch"], batch_specs_for(specs["batch"],
                                                        group), sizes)
    if SMALL[kind].kind == "train":
        # fp32 params, two moments in opt_state_dtype, the int32 step
        p = _shard_bytes(params, pspec, sizes)
        moment = torch.empty((), dtype=torch_dtype(cfg.opt_state_dtype))
        want += p + 2 * (p // 4) * moment.element_size() + 4
    else:
        want += _shard_bytes(compute_cast(params, cfg.compute_dtype), pspec,
                             sizes)
    if SMALL[kind].kind == "decode":
        want += _shard_bytes(specs["cache"], cache_specs_for(
            specs["cache"], cfg, group, rules), sizes) + 4
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["per_device_total"] >= want
