"""End-to-end training on the PyTorch port: a ~100M-parameter LM trained
for a few hundred steps on synthetic data through the full stack —
buffer-pool data pipeline, AdamW, async heterogeneous-layout checkpoints,
straggler timer, simulated crash + restart.

  PYTHONPATH=src python examples/torch_train_100m.py --steps 300
  PYTHONPATH=src python examples/torch_train_100m.py --steps 40 --quick
  PYTHONPATH=src python examples/torch_train_100m.py --steps 40 \\
      --simulate-failure --device cpu

The script of examples/train_100m.py over ``repro_torch``: the same
OLMo-family config (14 layers, d=512, 8 heads of 64, ff=3072,
vocab=32768), computing in fp32 with no remat, so every attention forward
is one launch of the flash kernel's fp32 route, writing the rows' lse for
the plain backward. ``--simulate-failure`` crashes at ``steps // 2`` and
restarts from the last checkpoint (one every 20 steps).

It prints the JAX example's lines, then one JSON line of the numbers it
printed; ``main(argv)`` returns that dict.
"""
import argparse
import json
import shutil
import tempfile

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.train import SimulatedFailure, run_training
from repro_torch.models.model import count_params


def config_100m():
    return get_config("olmo-1b").with_(
        n_layers=14, d_model=512, n_heads=8, kv_heads=8, head_dim=64,
        d_ff=3072, vocab=32768, remat="none",
        compute_dtype="float32")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--quick", action="store_true",
                    help="smaller batch/seq for a fast sanity run")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--simulate-failure", action="store_true",
                    help="crash mid-run, then restart from checkpoint")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config_100m()
    if args.quick:
        args.batch_size, args.seq_len = 4, 64
    n_params = count_params(cfg)
    print(f"model: {n_params/1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model} ff={cfg.d_ff} "
          f"vocab={cfg.vocab})")
    out = dict(device=str(dev), params=n_params, layers=cfg.n_layers,
               d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab,
               batch_size=args.batch_size, seq_len=args.seq_len,
               crashed_at=None)

    ckdir = args.ckpt_dir or tempfile.mkdtemp(prefix="train100m_")
    try:
        if args.simulate_failure:
            try:
                run_training(cfg, steps=args.steps,
                             batch_size=args.batch_size,
                             seq_len=args.seq_len, ckpt_dir=ckdir,
                             ckpt_every=20, log_every=20,
                             fail_at_step=args.steps // 2, device=dev)
            except SimulatedFailure as e:
                print(f"!! {e} — restarting from checkpoint")
                out["crashed_at"] = int(e.state.opt.step)
        res = run_training(cfg, steps=args.steps, batch_size=args.batch_size,
                           seq_len=args.seq_len, ckpt_dir=ckdir,
                           ckpt_every=20, log_every=20, device=dev)
        if res.restored_from is not None:
            print(f"(restored from step {res.restored_from})")
        print(f"finished: {res.steps} steps, "
              f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}, "
              f"{res.tokens_per_s:.0f} tok/s")
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckdir, ignore_errors=True)
    out.update(steps=res.steps, restored_from=res.restored_from,
               losses=res.losses, tokens_per_s=res.tokens_per_s)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
