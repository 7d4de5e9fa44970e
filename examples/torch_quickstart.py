"""Quickstart on the PyTorch port: the public API in ~60 lines.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The script of examples/quickstart.py over ``repro_torch``: builds the smoke
qwen3-0.6b, trains 10 steps on synthetic data staged through the Pangea
buffer pool (attention's forward on the flash kernel), checkpoints in two
heterogeneous layouts, restores into a state made from torch templates (so
that each leaf comes back in its own dtype), and greedily decodes a few
tokens through the prefill/decode path.

It prints the JAX example's lines, then one JSON line of the numbers it
printed; ``main(argv)`` returns that dict.
"""
import argparse
import json
import tempfile

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.launch.train import run_training
from repro_torch.models.lm import tree_map
from repro_torch.models.model import build_model
from repro_torch.optim.train_state import make_train_state


def restore_params(cfg, model, ckdir: str):
    """The params of the latest checkpoint in ``ckdir``, on the model's
    device, restored into a train state whose templates are a fresh
    ``init``'s; returns ``(params, step)``."""
    params = model.init(torch.Generator(model.device).manual_seed(0))
    mgr = CheckpointManager(ckdir, layouts=("row", "col"), num_shards=4)
    state = mgr.restore(make_train_state(params, cfg.opt_state_dtype))
    return tree_map(lambda t: t.to(model.device), state.params), \
        mgr.latest_step()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_config("qwen3-0.6b")
    print(f"arch={cfg.name} (reduced): {cfg.n_layers}L d={cfg.d_model}")

    with tempfile.TemporaryDirectory() as ckdir:
        # -- train (data flows through the unified buffer pool) --
        result = run_training(cfg, steps=10, batch_size=8, seq_len=32,
                              ckpt_dir=ckdir, ckpt_every=5, log_every=5,
                              device=dev)
        print(f"trained {result.steps} steps; "
              f"loss {result.losses[0]:.3f} -> {result.losses[-1]:.3f}")

        # -- restore from the checkpoint (row OR col layout both work) --
        model = build_model(cfg, device=dev)
        params, step = restore_params(cfg, model, ckdir)
        print(f"restored checkpoint at step {step}")

        # -- greedy decode --
        prompt = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab, (1, 8))
            .astype(np.int32))
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": prompt},
                                          max_len=16)
            tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
            out = [int(tok[0, 0])]
            for t in range(8, 12):
                logits, cache = model.decode_step(params, {"tokens": tok},
                                                  cache, t)
                tok = logits.argmax(dim=-1).to(torch.int32)
                out.append(int(tok[0, 0]))
        print("generated token ids:", out)
    res = dict(device=str(dev), arch=cfg.name, layers=cfg.n_layers,
               d_model=cfg.d_model, steps=result.steps,
               losses=result.losses, restored_step=step, generated=out)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
