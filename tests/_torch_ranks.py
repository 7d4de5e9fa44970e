"""Multi-rank runs of the port's sharded models on the CPU, for the tests.

``run(job, tmp_path, world)`` starts ``world`` processes of this file, each
one rank of a gloo process group (a ``FileStore`` in ``tmp_path``, no
network), and returns what rank 0 wrote. A job is a dict:

- ``kind``: ``"losses"`` (the loss under each preset of ``presets``, and
  with ``shardmap`` through the ``expert_parallel_shardmap`` mesh branch),
  ``"train_step"`` (one train step under ``presets[0]``: the loss, every
  gradient and every updated param, each gathered whole) or ``"same_bits"``
  (world size 1: for each arch of ``archs``, the loss and every gradient
  of the unsharded model against the sharded one on a 1 x 1 mesh, and
  ``run_training``'s losses with and without ``mesh=``);
- ``arch``, ``overrides``: the smoke config;
- ``mesh``: the mesh shape over ("data", "model");
- ``params``, ``batch``: npz files of the bridged params (flattened names)
  and the batch.

Every sharded backward runs on a thread of its own, as autograd runs a
CUDA backward on its device thread: there neither ``use_rules`` nor
DTensor's implicit replication is set. The rank processes import no JAX:
they are the port alone.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import numpy as np
import torch

TIMEOUT_S = 240


def flatten(tree, prefix=""):
    """A tree of dicts and lists -> {"a/b": leaf}; list item i is "#i"."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else ((f"#{i}", v) for i, v in enumerate(tree)))
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(flatten(v, name + "/"))
        elif v is not None:
            out[name] = v
    return out


def unflatten(flat):
    out = {}
    for name, v in flat.items():
        node = out
        *path, last = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return _lists(out)


def _lists(tree):
    """The "#i" dicts of ``unflatten`` back to lists."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(k.startswith("#") for k in tree):
        return [_lists(tree[f"#{i}"]) for i in range(len(tree))]
    return {k: _lists(v) for k, v in tree.items()}


def run(job: dict, tmp_path, world: int) -> dict:
    """Run ``job`` on ``world`` ranks; rank 0's results as numpy arrays."""
    return finish(start(job, tmp_path, world))


def start(job: dict, tmp_path, world: int):
    """Start ``job`` on ``world`` ranks; ``finish`` waits for it (the
    caller works meanwhile)."""
    job = dict(job, store=str(tmp_path / "store"), out=str(tmp_path / "out"))
    spec = tmp_path / "job.json"
    spec.write_text(json.dumps(job))
    env = dict(os.environ, WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, __file__, str(spec)],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    return job, procs


def finish(started) -> dict:
    """Wait for ``start``'s ranks; rank 0's results as numpy arrays."""
    job, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, (bad, logs[bad[0][0]][-4000:])
    with np.load(job["out"] + ".npz") as f:
        return dict(f)


def grads_on_a_thread(loss, leaves):
    """``torch.autograd.grad`` run on a new thread (see above)."""
    out = {}

    def run():
        try:
            out["grads"] = torch.autograd.grad(loss, leaves)
        except BaseException as e:  # re-raised below, on the caller
            out["error"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["grads"]


def _main(spec_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import (batch_shardings, distribute,
                                         make_mesh, param_shardings,
                                         sharding_rules)
    from repro_torch.models.model import build_model
    from repro_torch.optim import make_train_state, make_train_step
    from repro_torch.optim.adamw import _leaves, _unflatten_like
    from repro_torch.sharding import use_rules

    torch.set_num_threads(1)
    job = json.loads(open(spec_path).read())
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method="file://" + job["store"],
                            rank=rank, world_size=world)
    mesh = make_mesh(job["mesh"], ("data", "model"), device_type="cpu")
    if job["kind"] == "same_bits":
        out = _same_bits(job["archs"], mesh)
        np.savez(job["out"] + ".npz", **out)
        dist.destroy_process_group()
        return
    cfg0 = smoke_config(job["arch"]).with_(**job["overrides"])
    with np.load(job["params"]) as f:
        params0 = params_from_numpy(unflatten(dict(f)), device="cpu")
    with np.load(job["batch"]) as f:
        batch = {k: torch.from_numpy(v) for k, v in f.items()}

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    def sharded(cfg):
        model = build_model(cfg, device="cpu")
        rules = sharding_rules(cfg, mesh)
        params = distribute(params0, mesh,
                            param_shardings(model, cfg, mesh, rules))
        return model, rules, params, distribute(
            batch, mesh, batch_shardings(batch, mesh))

    out = {}
    if job["kind"] == "losses":
        for preset in job["presets"]:
            cfg = cfg0.with_(parallelism=preset)
            model, rules, params, dbatch = sharded(cfg)
            with use_rules(rules, mesh), torch.no_grad():
                out[preset] = whole(model.loss(params, dbatch)).numpy()
        if job.get("shardmap"):
            cfg = cfg0.with_(moe_strategy="expert_parallel_shardmap")
            model, rules, params, dbatch = sharded(cfg)
            with use_rules(rules, mesh), torch.no_grad():
                out["shardmap"] = whole(model.loss(params, dbatch)).numpy()
    else:
        cfg = cfg0.with_(parallelism=job["presets"][0])
        model, rules, params, dbatch = sharded(cfg)
        step = make_train_step(model.loss)
        with use_rules(rules, mesh):
            leaves = [t.detach().requires_grad_(True)
                      for t in _leaves(params)]
            loss = model.loss(_unflatten_like(params, leaves), dbatch)
        grads = grads_on_a_thread(loss, leaves)
        with use_rules(rules, mesh):
            state, metrics = step(make_train_state(params), dbatch)
        out["loss"] = whole(loss).numpy()
        out["step_loss"] = whole(metrics["loss"]).numpy()
        names = list(flatten(params0).keys())
        for name, g in zip(names, grads):
            out["grad/" + name] = whole(g).float().numpy()
        for name, p in zip(names, _leaves(state.params)):
            out["param/" + name] = whole(p).float().numpy()
    if rank == 0:
        np.savez(job["out"] + ".npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def _same_bits(archs, mesh) -> dict:
    """World size 1: per arch (smoke config, remat per layer), 1 where the
    sharded loss, every gradient (its backward on a thread of its own) and
    three ``run_training`` losses equal the unsharded ones bit for bit."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import (batch_shardings, distribute,
                                         param_shardings, sharding_rules)
    from repro_torch.launch.train import run_training
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import _leaves, _unflatten_like
    from repro_torch.sharding import use_rules

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    out = {}
    for arch in archs:
        cfg = smoke_config(arch).with_(remat="layer")
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        B, T = 2, 16
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (B, T)))
                 for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            batch["src_embeds"] = torch.randn(
                (B, T, cfg.d_model), generator=torch.Generator().manual_seed(1))
        if cfg.rope == "mrope":
            batch["positions"] = torch.arange(T).expand(B, 3, T)

        def loss_and_grads(p, b):
            leaves = [t.detach().requires_grad_(True) for t in _leaves(p)]
            loss = model.loss(_unflatten_like(p, leaves), b)
            return loss, leaves
        loss0, leaves0 = loss_and_grads(params, batch)
        grads0 = torch.autograd.grad(loss0, leaves0)
        rules = sharding_rules(cfg, mesh)
        with use_rules(rules, mesh):
            loss1, leaves1 = loss_and_grads(
                distribute(params, mesh,
                           param_shardings(model, cfg, mesh, rules)),
                distribute(batch, mesh, batch_shardings(batch, mesh)))
        grads1 = grads_on_a_thread(loss1, leaves1)
        same = torch.equal(loss0, whole(loss1)) and all(
            torch.equal(a, whole(b)) for a, b in zip(grads0, grads1))
        kw = dict(steps=3, batch_size=2, seq_len=16, num_sequences=4,
                  seed=5, log_every=100, device="cpu")
        runs = [run_training(cfg, **kw).losses,
                run_training(cfg, mesh=mesh, **kw).losses]
        out[arch] = np.array([same, runs[0] == runs[1]])
    return out


if __name__ == "__main__":
    _main(sys.argv[1])
