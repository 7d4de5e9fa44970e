"""The port's sharding layer (``repro_torch/sharding.py``,
``repro_torch/launch/mesh.py``) against the JAX package's, on the CPU.

- ``DEFAULT_RULES``, ``sharding_rules`` and ``spec_for`` equal the
  reference's for every arch x preset x production mesh (16 x 16 and 2 x 16
  x 16) and every leaf of ``param_axes()``. Both sides' rules and specs
  read only the mesh's axis names and sizes, so stand-in meshes give them
  with no devices.
- ``param_axes()`` equals the reference's tree, leaf for leaf, for every
  arch, the ``expert_parallel_shardmap`` variant of the MoE archs too.
- ``dp_axes_for``, the batch specs and the decode-cache specs equal the
  reference's ``NamedSharding`` specs for every (arch x shape) cell on both
  production meshes, taken in a subprocess that forces 512 host devices,
  as the reference's dry-run does.
- ``constrain`` outside ``use_rules`` (or on a plain tensor) returns its
  argument itself; ``placements_for`` puts ``Shard(d)`` on each mesh axis
  of a dim sharded over several.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import sharding as jax_sharding
from repro.configs import get_config as jax_get_config
from repro.launch import mesh as jax_mesh
from repro.models.model import build_model as jax_build_model
from repro_torch import sharding
from repro_torch.configs import ARCH_IDS, get_config, shapes_for
from repro_torch.launch import mesh
from repro_torch.models.model import build_model, input_specs

torch.set_num_threads(2)

PRESETS = ("fsdp_tp", "dp", "fsdp_tp_sp", "serve_2d")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHARDMAP = "expert_parallel_shardmap"


def jax_stand_in(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, object))


def torch_stand_in(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(mesh_dim_names=axes, shape=shape)


def spec_list(spec):
    """A spec (PartitionSpec or the port's tuple) as JSON-like lists, with
    trailing Nones trimmed."""
    out = [list(e) if isinstance(e, tuple) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def axes_leaves(tree, prefix=""):
    """{path: axes tuple} of an axes tree (tuples are leaves)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(axes_leaves(v, f"{prefix}/{k}"))
    return out


def variants(arch):
    out = [{}]
    if get_config(arch).n_experts:
        out.append({"moe_strategy": SHARDMAP})
    return out


def test_default_rules_equal_the_reference():
    assert sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_the_reference(arch):
    for kw in variants(arch):
        ours = build_model(get_config(arch).with_(**kw),
                           device="cpu").param_axes()
        ref = jax_build_model(jax_get_config(arch).with_(**kw)).param_axes()
        assert axes_leaves(ours) == axes_leaves(ref), kw


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_specs_equal_the_reference(arch):
    """Every preset on both production meshes: the rules dict, then the
    spec of every param leaf (the shardmap variant's too)."""
    n = 0
    for kw in variants(arch):
        cfg = get_config(arch).with_(**kw)
        jcfg = jax_get_config(arch).with_(**kw)
        leaves = axes_leaves(build_model(cfg, device="cpu").param_axes())
        for preset in PRESETS:
            for name in MESHES:
                jm, tm = jax_stand_in(name), torch_stand_in(name)
                rules = mesh.sharding_rules(cfg, tm, preset)
                jrules = jax_mesh.sharding_rules(jcfg, jm, preset)
                assert rules == jrules, (preset, name)
                for path, ax in leaves.items():
                    if ax is None:
                        continue
                    ours = sharding.spec_for(ax, rules, tm)
                    ref = jax_sharding.spec_for(ax, jrules, jm)
                    assert spec_list(ours) == spec_list(ref), (
                        preset, name, path)
                    n += 1
    assert n > 0


def test_dp_axes_equal_the_reference():
    for name in MESHES:
        for batch in (1, 2, 3, 8, 16, 24, 32, 64, 128, 256, 512, 1024):
            assert mesh.dp_axes_for(torch_stand_in(name), batch) == \
                jax_mesh.dp_axes_for(jax_stand_in(name), batch), (name, batch)


# the reference's batch and cache shardings need a real jax Mesh: its
# specs are taken in a process with 512 host devices, as its dry-run does
REF_SPECS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax
from repro.configs import ARCH_IDS, get_config, shapes_for
from repro.launch.mesh import (batch_shardings, cache_shardings,
                               make_production_mesh)
from repro.models.model import build_model, input_specs

def lst(spec):
    out = [list(e) if isinstance(e, tuple) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: lst(tree.spec)}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}"))
    return out

res = {}
for mp, name in ((False, "16x16"), (True, "2x16x16")):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = build_model(cfg)
        for shape in shapes_for(cfg):
            specs = input_specs(cfg, shape, model=model)
            rec = {"batch": flat(batch_shardings(specs["batch"], mesh))}
            if shape.kind == "decode":
                rec["cache"] = flat(cache_shardings(specs["cache"], cfg,
                                                    mesh))
            res[f"{arch}|{shape.name}|{name}"] = rec
print("SPECS", json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref_specs():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", REF_SPECS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("SPECS "))
    return json.loads(line[len("SPECS "):])


def flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: spec_list(tree)}
    out = {}
    for k, v in items:
        out.update(flat_specs(v, f"{prefix}/{k}"))
    return out


CELLS = [(arch, shape) for arch in ARCH_IDS
         for shape in shapes_for(get_config(arch))]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s.name}" for a, s in CELLS])
def test_batch_and_cache_specs_equal_the_reference(ref_specs, arch, shape):
    cfg = get_config(arch)
    specs = input_specs(cfg, shape,
                        model=build_model(cfg, device="cpu"))
    for name in MESHES:
        tm = torch_stand_in(name)
        ref = ref_specs[f"{arch}|{shape.name}|{name}"]
        assert flat_specs(mesh.batch_specs_for(specs["batch"], tm)) == \
            ref["batch"], name
        if shape.kind == "decode":
            ours = flat_specs(mesh.cache_specs_for(specs["cache"], cfg, tm))
            assert ours == ref["cache"], name


def test_constrain_outside_rules_is_the_identity():
    x = torch.randn(2, 3, 4)
    assert sharding.constrain(x, ("batch", "seq", None)) is x
    assert sharding.constrain_seq(x) is x
    # with rules but no DTensor: the same object too
    with sharding.use_rules(dict(sharding.DEFAULT_RULES, seq="model")):
        assert sharding.constrain(x, ("batch", None, None)) is x
        assert sharding.constrain_seq(x) is x
    assert sharding.get_rules() is None and sharding.get_mesh() is None


def test_placements_for_shards_a_dim_over_each_of_its_axes():
    tm = torch_stand_in("2x16x16")
    assert sharding.placements_for((("pod", "data"), None, "model"), tm) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements_for((), tm) == (Replicate(),) * 3
    # the first dim wins a mesh axis; trailing Nones are trimmed
    rules = dict(sharding.DEFAULT_RULES, mlp="model")
    assert sharding.spec_for(("heads", "mlp", None), rules, tm) == ("model",)
