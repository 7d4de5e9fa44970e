"""Multi-pod dry-run on the ``meta`` device.

The counterpart of the JAX package's ``launch/dryrun.py``. For every
(architecture x input shape x mesh) cell of ``shapes_for``: build params,
the AdamW state, the batch and the decode caches as DTensors of ``meta``
tensors (shapes and placements, no memory) over a production mesh of a
fake process group (256 or 512 ranks in this one process, which sends
nothing), run the step function once (the train step's loss, backward and
AdamW update; the prefill; or one decode step) on the plain impls, and
count its per-device costs with ``hlo_analysis.CostCounter``. The
reference's placeholder CPU devices are the fake group's ranks; its
lowering is this run (``lower_s``); there is no compile step.

The impls are chosen explicitly: attention on the chunked plain path
(``"xla"``, the mirror of the reference's default), RWKV6's wkv chunked
(``"xla_chunked"``), RG-LRU's scan the sequential oracle, MoE the dense
dispatch mask (``"xla"``, the reference's einsum). No kernel is built.

Each record has ``params``, ``active_params``, ``memory.argument_bytes``
(the local bytes of every input on one device, exact),
``memory.output_bytes`` (the local bytes of the outputs that are not
inputs updated in place), ``memory.per_device_total`` (their sum: no
temporaries are counted), the counter's ``hlo`` fields and ``lower_s``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod  # 2x16x16
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import sharding as shardlib
from ..sharding import placements_for
from ..configs import ARCH_IDS, get_config, shapes_for
from ..configs.base import ALL_SHAPES, ArchConfig, ShapeConfig
from ..models.lm import compute_cast, torch_dtype, tree_map
from ..models.model import (_on_meta, active_params, build_model,
                            count_params, input_specs)
from ..optim import AdamWState, TrainState, make_train_step
from .hlo_analysis import CostCounter
from .mesh import (PRODUCTION_SHAPES, batch_shardings, cache_shardings,
                   distribute, make_mesh, param_shardings, sharding_rules)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

IMPLS = dict(attn_impl="xla", scan_impl="xla_chunked", moe_impl="xla")

PER_DEVICE_TOTAL = ("argument bytes + the bytes of outputs that are not "
                    "inputs updated in place; no temporaries")


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks in this process (this one is
    rank 0): meshes and DTensors of any size, collectives that send
    nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(shape: Sequence[int]) -> str:
    return "x".join(str(n) for n in shape)


def local_bytes(tree) -> int:
    """Σ local numel x itemsize over a tree's tensors (a DTensor's shard)."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):            # NamedTuples too
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        loc = tree.to_local() if isinstance(tree, DTensor) else tree
        return loc.numel() * loc.element_size()
    return 0


def _meta_params(model, cfg: ArchConfig, serve: bool):
    """The params on ``meta``: fp32 as ``init`` draws them, or for serving
    with the compute cast applied, as the reference's dry-run casts its
    abstract params."""
    params = model.init(None)
    return compute_cast(params, cfg.compute_dtype) if serve else params


def lower_cell(arch_id: str, shape: ShapeConfig, multi_pod: bool,
               overrides: Optional[Dict[str, Any]] = None,
               mla_absorbed: bool = False, *, cfg: Optional[ArchConfig] = None,
               mesh_shape: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """Run one cell under the fake process group already up (its world
    the mesh's size); returns the analysis record. ``cfg`` and
    ``mesh_shape`` replace the arch's config and the production mesh
    (tests run smoke configs on small meshes)."""
    cfg = cfg or get_config(arch_id)
    if overrides:
        cfg = cfg.with_(**overrides)
    prod_shape, axes = PRODUCTION_SHAPES[multi_pod]
    mshape = tuple(mesh_shape or prod_shape)
    mesh = make_mesh(mshape, axes[-len(mshape):], device_type="cpu")
    rules = sharding_rules(cfg, mesh)
    model = _on_meta(cfg, build_model(cfg, mla_absorbed=mla_absorbed,
                                      device="cpu", **IMPLS))
    rec: Dict[str, Any] = {
        "arch": arch_id, "shape": shape.name, "mesh": mesh_name(mshape),
        "kind": shape.kind, "params": count_params(cfg),
        "active_params": active_params(cfg), "impls": IMPLS,
    }
    params = _meta_params(model, cfg, serve=shape.kind != "train")
    pshard = param_shardings(model, cfg, mesh, rules)
    specs = input_specs(cfg, shape, model=model)
    t0 = time.time()
    with shardlib.use_rules(rules, mesh), CostCounter() as counter:
        params = distribute(params, mesh, pshard)
        batch = distribute(specs["batch"], mesh,
                           batch_shardings(specs["batch"], mesh))
        if shape.kind == "train":
            odt = torch_dtype(cfg.opt_state_dtype)
            zeros = lambda p: torch.zeros_like(p, dtype=odt)
            state = TrainState(params=params, opt=AdamWState(
                step=torch.zeros((), dtype=torch.int32, device="meta"),
                m=tree_map(zeros, params), v=tree_map(zeros, params)))
            args = (state, batch)
            step = make_train_step(model.loss, microbatches=cfg.microbatches)
            _, metrics = step(state, batch)
            outputs = metrics              # the state is updated in place
        elif shape.kind == "prefill":
            args = (params, batch)
            if cfg.family == "encdec":
                memory = model.encode(params, batch["src_embeds"])
                outputs = (memory, model.decode_cache_init(
                    batch["tokens"].shape[0], shape.seq_len, memory=memory,
                    params=params))
            else:
                outputs = model.prefill(params, batch)
        else:
            cache = distribute(specs["cache"], mesh, cache_shardings(
                specs["cache"], cfg, mesh, rules))
            pos = distribute(specs["pos"], mesh, placements_for((), mesh))
            args = (params, batch, cache, pos)
            logits, _ = model.decode_step(params, batch, cache,
                                          shape.seq_len - 1)
            outputs = logits               # the cache is updated in place
    rec["lower_s"] = round(time.time() - t0, 2)
    arg_bytes = local_bytes(list(args))
    out_bytes = local_bytes(outputs)
    rec["memory"] = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                     "per_device_total": arg_bytes + out_bytes,
                     "per_device_total_includes": PER_DEVICE_TOTAL}
    stats = counter.stats
    rec["hlo"] = {
        "dot_flops": stats.dot_flops,
        "hbm_bytes": stats.hbm_bytes,
        "collective_bytes": stats.collective_bytes,
        "collective_count": stats.collective_count,
        "total_collective_bytes": stats.total_collective_bytes,
    }
    rec["status"] = "ok"
    return rec


def cell_path(arch_id: str, shape_name: str, multi_pod: bool,
              tag: str = "") -> str:
    mesh = mesh_name(PRODUCTION_SHAPES[multi_pod][0])
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    return os.path.join(RESULTS_DIR,
                        f"{arch_id}_{shape_name}_{mesh}{suffix}.json")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id")
    ap.add_argument("--shape", default=None, help="single shape name")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="results filename tag")
    ap.add_argument("--mla-absorbed", action="store_true")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ArchConfig overrides")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else ARCH_IDS
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    overrides = json.loads(args.override) if args.override else None

    failures = []
    t_all = time.time()
    for arch_id in archs:
        shapes = shapes_for(get_config(arch_id))
        for s in ALL_SHAPES:
            if s not in shapes and (not args.shape or s.name == args.shape):
                print(f"SKIP  {arch_id:24s} {s.name:12s} "
                      f"(full-attention arch; see DESIGN.md)")
    for mp in meshes:
        mname = mesh_name(PRODUCTION_SHAPES[mp][0])
        world = 1
        for n in PRODUCTION_SHAPES[mp][0]:
            world *= n
        with fake_group(world):
            for arch_id in archs:
                for shape in shapes_for(get_config(arch_id)):
                    if args.shape and shape.name != args.shape:
                        continue
                    path = cell_path(arch_id, shape.name, mp, args.tag)
                    label = f"{arch_id:24s} {shape.name:12s} {mname}"
                    if os.path.exists(path) and not args.force:
                        print(f"CACHED {label}")
                        continue
                    try:
                        rec = lower_cell(arch_id, shape, mp,
                                         overrides=overrides,
                                         mla_absorbed=args.mla_absorbed)
                        with open(path, "w") as f:
                            json.dump(rec, f, indent=1)
                        mem = rec["memory"]
                        print(f"OK    {label} lower={rec['lower_s']}s "
                              f"args/dev={mem['argument_bytes']/2**30:.3f}GiB "
                              f"dotTF={rec['hlo']['dot_flops']/1e12:.2f} "
                              f"coll={rec['hlo']['total_collective_bytes']/2**30:.3f}GiB",
                              flush=True)
                    except Exception as e:  # noqa: BLE001 - a cell's failure is reported, the sweep goes on
                        failures.append((label, repr(e)))
                        print(f"FAIL  {label}: {e!r}", flush=True)
                        traceback.print_exc()
    print(f"\nsweep seconds: {time.time() - t_all:.1f}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for label, err in failures:
            print(" ", label, err)
        raise SystemExit(1)
    print("\nALL CELLS OK")


if __name__ == "__main__":
    main()
