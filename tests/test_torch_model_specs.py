"""The port's model registry (``models/model.py``) against the JAX
package's: ``count_params`` and ``active_params`` equal the reference's
for every architecture at full size, and ``input_specs`` gives, for every
architecture x shape cell, the reference's keys, shapes and dtypes, each
leaf a tensor on ``meta`` (no memory). The mirrors of
``tests/test_models.py``'s registry tests follow.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, shapes_for, smoke_config
from repro_torch.models.model import (active_params, build_model,
                                      count_params, decode_cache_specs,
                                      input_specs)

CELLS = [(arch, shape.name) for arch in ARCH_IDS
         for shape in shapes_for(get_config(arch))]


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict/list, None leaves dropped."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_equal_the_reference(arch):
    cfg = get_config(arch)
    assert count_params(cfg) == jax_model.count_params(jax_get_config(arch))
    assert active_params(cfg) == jax_model.active_params(
        jax_get_config(arch))


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_equal_the_reference(arch, shape_name):
    cfg = get_config(arch)
    shape = next(s for s in shapes_for(cfg) if s.name == shape_name)
    ours = _flat(input_specs(cfg, shape))
    ref = _flat(jax_model.input_specs(jax_get_config(arch), shape))
    assert sorted(ours) == sorted(ref)
    for key, leaf in ours.items():
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(ref[key].shape), key
        assert str(leaf.dtype).replace("torch.", "") == str(ref[key].dtype), \
            key


def test_param_counts_match_published_scale():
    """Full configs land near their published parameter counts."""
    expect = {
        "grok-1-314b": (280e9, 345e9),
        "deepseek-v2-lite-16b": (14e9, 18e9),
        "glm4-9b": (8e9, 10.5e9),
        "olmo-1b": (0.9e9, 1.4e9),
        "qwen3-0.6b": (0.55e9, 0.85e9),
        "minitron-8b": (7e9, 10.2e9),   # untied embeddings add ~1B
        "rwkv6-3b": (2.5e9, 3.8e9),
        "recurrentgemma-9b": (7.5e9, 12e9),
        "qwen2-vl-72b": (65e9, 78e9),
        "seamless-m4t-large-v2": (1.4e9, 2.8e9),
    }
    for arch, (lo, hi) in expect.items():
        n = count_params(get_config(arch))
        assert lo <= n <= hi, f"{arch}: {n/1e9:.2f}B not in [{lo/1e9},{hi/1e9}]"


def test_active_params_moe():
    cfg = get_config("deepseek-v2-lite-16b")
    total, act = count_params(cfg), active_params(cfg)
    assert act < total * 0.35  # top-6 of 64 routed → far fewer active


def test_input_specs_cover_all_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            model = build_model(cfg, device="cpu")
            specs = input_specs(cfg, shape, model=model)
            assert "batch" in specs
            leaves = jax.tree.leaves(specs)
            assert all(hasattr(l, "shape") for l in leaves)


def test_meta_stays_inside_the_specs():
    """A given model's decode cache comes on ``meta`` and the model keeps
    its own device; the entry points still refuse ``meta``; an init without
    a generator draws nothing on a real device; the counts of a smoke
    config equal its init's."""
    cfg = get_config("qwen3-0.6b")
    shape = next(s for s in shapes_for(cfg) if s.kind == "decode")
    model = build_model(cfg, device="cpu")
    cache = decode_cache_specs(model, cfg, shape)
    assert {t.device.type for t in _flat(cache).values()} == {"meta"}
    assert model.device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        build_model(cfg, device="meta")
    with pytest.raises(ValueError, match="generator on meta"):
        model.init(None)
    for arch in ("seamless-m4t-large-v2", "recurrentgemma-9b"):
        small = smoke_config(arch)
        params = build_model(small, device="cpu").init(
            torch.Generator().manual_seed(0))
        assert count_params(small) == sum(
            int(np.prod(t.shape)) for t in _flat(params).values())


def test_all_configs_equal_the_reference():
    """``all_configs`` gives the ten configs, each ``get_config``'s, field
    for field the JAX package's (``kv_cache_dtype`` included)."""
    import dataclasses

    from repro.configs import all_configs as jax_all_configs
    from repro_torch.configs import all_configs
    got, want = all_configs(), jax_all_configs()
    assert list(got) == list(want) == ARCH_IDS
    for arch, cfg in got.items():
        assert cfg == get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want[arch]), arch
