"""Production mesh and per-arch sharding rules on DTensor.

The port of the JAX package's ``launch/mesh.py``. ``make_production_mesh``
is a function: importing this module touches no distributed state. Single
pod: (16, 16) over ("data", "model") = 256 ranks. Multi-pod: (2, 16, 16)
over ("pod", "data", "model") = 512 ranks; the "pod" axis extends data
parallelism. Both call ``init_device_mesh``, so the process group must be
up (NCCL on the card, gloo or the fake backend on the CPU).

Shardings are placement tuples (one ``Shard``/``Replicate`` per mesh dim),
the DTensor form of the reference's ``NamedSharding``; ``distribute`` makes
DTensors of a tree of plain or ``meta`` tensors with them.
"""
from __future__ import annotations

from typing import Dict, Optional

from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor

from ..configs.base import ArchConfig
from ..models.lm import tree_map
from ..sharding import DEFAULT_RULES, mesh_sizes, placements_for, spec_for

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """Any mesh over the process group's ranks (tests use small ones)."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def axis_size(mesh, name: str) -> int:
    return mesh_sizes(mesh).get(name, 1)


def sharding_rules(cfg: ArchConfig, mesh,
                   parallelism: Optional[str] = None) -> Dict:
    """Per-arch logical -> mesh rules, aware of divisibility, as the
    reference's; ``parallelism`` overrides ``cfg.parallelism``."""
    preset = parallelism or cfg.parallelism
    model_sz = axis_size(mesh, "model")
    rules = dict(DEFAULT_RULES)
    rules["batch"] = ("pod", "data")
    rules["ffn_batch"] = ("pod", "data")          # FFN/MoE-block batch axis
    rules["embed"] = "data"                       # FSDP/ZeRO
    rules["mlp"] = "model"
    rules["mlp_out"] = "model"                    # rg-lru gate outputs
    rules["heads"] = "model" if (cfg.n_heads and
                                 cfg.n_heads % model_sz == 0) else None
    kv_ok = cfg.kv_heads and cfg.kv_heads % model_sz == 0
    rules["kv"] = "model" if kv_ok else None
    # decode caches: if kv heads can't shard, shard the cache's seq dim
    rules["kv_seq"] = None if kv_ok else "model"
    rules["vocab"] = "model" if cfg.vocab % model_sz == 0 else None
    if cfg.n_experts and cfg.moe_strategy in ("expert_parallel",
                                              "expert_parallel_shardmap"):
        rules["experts"] = ("model" if cfg.n_experts % model_sz == 0 else None)
    else:
        rules["experts"] = None
    rules["heads_embed"] = "model"                # rwkv channel projections
    rules["embed_vec"] = None
    rules["embed_out"] = None

    if preset == "fsdp_tp_sp":
        # sequence parallelism: the residual stream stays sequence-sharded
        # over "model" between the TP regions
        rules["seq"] = "model"
    elif preset == "dp":
        # pure data parallelism: no tensor sharding; batch over every axis
        rules["batch"] = ("pod", "data", "model")
        rules["ffn_batch"] = ("pod", "data", "model")
        for ax in ("mlp", "mlp_out", "heads", "kv", "vocab", "experts",
                   "heads_embed"):
            rules[ax] = None
        rules["kv_seq"] = None
    elif preset == "serve_2d":
        # weight-stationary decode: no FSDP dim, the FFN width sharded over
        # both axes where it divides, activations gathered over "data"
        # around the FFN/MoE blocks
        rules["ffn_batch"] = None
        rules["embed"] = None
        total = axis_size(mesh, "data") * model_sz
        wide = ("data", "model")
        rules["mlp"] = wide if cfg.d_ff % total == 0 else rules["mlp"]
        if cfg.n_experts and cfg.moe_strategy == "expert_tp":
            rules["mlp"] = wide if cfg.d_expert % total == 0 else rules["mlp"]
        rules["mlp_out"] = wide if cfg.d_model % total == 0 else rules["mlp_out"]
    return rules


def _axes_map(fn, axes):
    """Map ``fn`` over an axes or spec tree (dicts and lists; the leaves
    tuples, or None)."""
    if isinstance(axes, dict):
        return {k: _axes_map(fn, v) for k, v in axes.items()}
    if isinstance(axes, list):
        return [_axes_map(fn, v) for v in axes]
    return None if axes is None else fn(axes)


def param_specs(model, cfg: ArchConfig, mesh, rules: Optional[Dict] = None):
    """The spec tree of the model's params (from their logical axes)."""
    rules = rules or sharding_rules(cfg, mesh)
    return _axes_map(lambda a: spec_for(a, rules, mesh), model.param_axes())


def param_shardings(model, cfg: ArchConfig, mesh,
                    rules: Optional[Dict] = None):
    """The placements tree of the model's params."""
    return _axes_map(lambda s: placements_for(s, mesh),
                     param_specs(model, cfg, mesh, rules))


def dp_axes_for(mesh, batch: int):
    """The largest ("pod", "data") prefix that divides the batch dim."""
    sizes = mesh_sizes(mesh)
    cands = [a for a in ("pod", "data") if a in sizes]
    options = [tuple(cands)] + ([("data",)] if "data" in sizes else []) + [()]
    for opt in options:
        prod = 1
        for a in opt:
            prod *= sizes[a]
        if batch % prod == 0:
            return opt if len(opt) > 1 else (opt[0] if opt else None)
    return None


def batch_specs_for(batch_specs, mesh):
    """The spec of every batch leaf: its leading (batch) dim sharded where
    it divides."""
    return tree_map(lambda leaf: _trim((dp_axes_for(mesh, leaf.shape[0]),)),
                    batch_specs)


def batch_shardings(batch_specs, mesh):
    return _axes_map(lambda s: placements_for(s, mesh),
                     batch_specs_for(batch_specs, mesh))


def _trim(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _cache_spec(name: str, shp, rules: Dict, mesh):
    """One decode-cache leaf's spec, by its leaf name, as the reference's
    ``cache_shardings``: batch on data (+pod); kv heads on "model" where
    they divide, else the cache's sequence dim. A leaf may carry a leading
    stacked-layer dim or not."""
    model_sz = axis_size(mesh, "model")
    nd = len(shp)
    if name in ("k", "v", "cross_k", "cross_v"):       # [(L,)B,KH,T,hd]
        dp = dp_axes_for(mesh, shp[nd - 4])
        seq_ax = rules.get("kv_seq") if shp[-2] % model_sz == 0 else None
        return _trim([None] * (nd - 4) + [dp, rules.get("kv"), seq_ax, None])
    if name in ("c_kv", "k_rope"):                     # [(L,)B,T,lora/rope]
        dp = dp_axes_for(mesh, shp[nd - 3])
        seq_ax = "model" if shp[-2] % model_sz == 0 else None
        return _trim([None] * (nd - 3) + [dp, seq_ax, None])
    if name == "S":                                    # [(L,)B,H,dk,dv]
        dp = dp_axes_for(mesh, shp[nd - 4])
        h_ax = "model" if shp[-3] % model_sz == 0 else None
        return _trim([None] * (nd - 4) + [dp, h_ax, None, None])
    if name == "conv":                                 # [(L,)B,CONV_W-1,w]
        dp = dp_axes_for(mesh, shp[nd - 3])
        w_ax = "model" if shp[-1] % model_sz == 0 else None
        return _trim([None] * (nd - 3) + [dp, None, w_ax])
    # [(L,)B,d] token-shift / h states
    dp = dp_axes_for(mesh, shp[nd - 2])
    d_ax = "model" if shp[-1] % model_sz == 0 else None
    return _trim([None] * (nd - 2) + [dp, d_ax])


def _named_map(fn, tree, name: str = ""):
    """Map ``fn(leaf name, leaf)`` over a cache tree: a leaf's name is its
    dict key, or its index in a list, as the reference's path keys give."""
    if isinstance(tree, dict):
        return {k: _named_map(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_named_map(fn, v, str(i))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(name, tree)


def cache_specs_for(cache_specs, cfg: ArchConfig, mesh,
                    rules: Optional[Dict] = None):
    rules = rules or sharding_rules(cfg, mesh)
    return _named_map(lambda n, leaf: _cache_spec(n, tuple(leaf.shape),
                                                  rules, mesh), cache_specs)


def cache_shardings(cache_specs, cfg: ArchConfig, mesh,
                    rules: Optional[Dict] = None):
    """The placements of every decode-cache leaf."""
    return _axes_map(lambda s: placements_for(s, mesh),
                     cache_specs_for(cache_specs, cfg, mesh, rules))


def _tree_zip(fn, tree, shardings):
    """Map ``fn(leaf, placements)`` over a tree and its placements tree."""
    if isinstance(tree, dict):
        return {k: _tree_zip(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_zip(fn, v, s)
                          for v, s in zip(tree, shardings))
    return None if tree is None else fn(tree, shardings)


def distribute(tree, mesh, shardings):
    """DTensors of a tree of tensors (plain or ``meta``), each leaf with its
    placements. Every rank holds the whole tensor and keeps its own shard:
    nothing is sent (``src_data_rank=None``)."""
    def one(t, placements):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, placements)
        return distribute_tensor(t, mesh, placements, src_data_rank=None)
    return _tree_zip(one, tree, shardings)


__all__ = ["PRODUCTION_SHAPES", "axis_size", "batch_shardings",
           "batch_specs_for", "cache_shardings", "cache_specs_for",
           "distribute", "dp_axes_for", "make_mesh", "make_production_mesh",
           "param_shardings", "param_specs", "sharding_rules"]
