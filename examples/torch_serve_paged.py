"""Batched serving over the Pangea paged KV cache, on the PyTorch port.

  PYTHONPATH=src python examples/torch_serve_paged.py [--requests 12]
  PYTHONPATH=src python examples/torch_serve_paged.py --device cpu

The script of examples/serve_paged.py over ``repro_torch``: ``ServeLoop``
on the smoke config of ``--arch``, its params drawn from seed 0 by torch's
generator, with a deliberately small device page budget, so that the Eq.-1
paging policy offloads cold sequences' KV pages to the host store and
fetches them back on their next decode turn. Prefill runs the flash
kernel; the decode attends over the model's dense cache, as the JAX
package's does.

It prints the JAX example's lines, then one JSON line of the numbers it
printed; ``main(argv)`` returns that dict.
"""
import argparse
import json

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.launch.serve import Request, ServeLoop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--hbm-pages", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(args.arch)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, args.prompt_len,
                                    dtype=np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    loop = ServeLoop(cfg, batch_slots=3,
                     max_len=args.prompt_len + args.new_tokens + 8,
                     hbm_pages=args.hbm_pages, device=dev)
    out = loop.run(reqs)
    print(f"served {len(out)} requests "
          f"({loop.stats['decode_tokens']} decode tokens, "
          f"{loop.stats['decode_tok_per_s']:.1f} tok/s)")
    print(f"KV paging: {loop.stats['offloads']} offloads, "
          f"{loop.stats['fetches']} fetches, "
          f"{loop.stats['offload_bytes']/2**20:.1f} MB moved")
    sample = list(out.items())[0]
    print(f"request {sample[0]} generated: {sample[1]}")
    result = dict(device=str(dev), arch=cfg.name, requests=len(out),
                  decode_tokens=loop.stats["decode_tokens"],
                  decode_tok_per_s=loop.stats["decode_tok_per_s"],
                  offloads=loop.stats["offloads"],
                  fetches=loop.stats["fetches"],
                  offload_bytes=loop.stats["offload_bytes"],
                  generated={str(r): toks for r, toks in out.items()})
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
