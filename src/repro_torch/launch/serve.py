"""Serving loop: batched prefill + decode over the Pangea paged KV cache.

The ``PagedKVCache`` owns device page residency with the paper's Eq.-1
priority (finished/cold sequences evicted first). As in the JAX package, the
decode step attends over the model's dense cache per batch while the page
manager runs the paging policy on every step; ``kernels/paged_attention`` is
the device read of the pool. Prefill goes through the flash-attention kernel
(``LM(attn_impl="kernel")``).

Run: ``python -m repro_torch.launch.serve --arch qwen3-0.6b`` (on the card;
``--device cpu --smoke`` for a small CPU run).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs import get_config, smoke_config
from ..configs.base import ArchConfig
from ..core import PagedKVCache
from ..models.model import build_model


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray          # [T] int32
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)


class ServeLoop:
    """Static-batch serving with paged KV accounting.

    Each active slot is one sequence; the PagedKVCache tracks its pages and
    offloads cold/finished sequences' pages under pool pressure. ``params``
    (optional) are the model's params, e.g. bridged from the reference;
    without them the loop draws its own from ``seed``.
    """

    def __init__(self, cfg: ArchConfig, *, batch_slots: int = 4,
                 max_len: int = 256, hbm_pages: Optional[int] = None,
                 seed: int = 0, params=None, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, device=self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        self.params = params
        # Weights go to compute_dtype once here instead of on every call as
        # in the reference: the cast values are identical, and the model's
        # own cast leaves already-cast weights as they are.
        self.params_c = self.model._compute_cast(params)
        self.batch_slots = batch_slots
        self.max_len = max_len
        pages_per_seq = -(-max_len // cfg.page_size)
        self.pager = PagedKVCache(
            num_layers=cfg.n_layers,
            hbm_pages=hbm_pages or batch_slots * pages_per_seq,
            page_size=cfg.page_size,
            kv_heads=max(cfg.kv_heads, 1),
            head_dim=cfg.resolved_head_dim or 16,
            device=self.device)
        # seconds: prefill (model + first argmax), decode (the whole step
        # loop) and, inside both phases' loops, the pager's own calls
        self.stats = {"prefill_tokens": 0, "decode_tokens": 0,
                      "prefill_s": 0.0, "decode_s": 0.0, "pager_s": 0.0}

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        cfg = self.cfg
        out: Dict[int, List[int]] = {}
        queue = list(requests)
        t0 = time.time()
        while queue:
            active = queue[:self.batch_slots]
            queue = queue[self.batch_slots:]
            B = len(active)
            plen = max(len(r.prompt) for r in active)
            toks = np.zeros((B, plen), np.int32)
            tg = time.perf_counter()
            for i, r in enumerate(active):
                toks[i, :len(r.prompt)] = r.prompt
                self.pager.start_sequence(r.req_id)
                self.pager.ensure_capacity(r.req_id, plen)
                self.pager.advance(r.req_id, plen)
            tp = time.perf_counter()
            self.stats["pager_s"] += tp - tg
            logits, cache = self.model.prefill(
                self.params_c, {"tokens": torch.from_numpy(toks)},
                max_len=self.max_len)
            self.stats["prefill_tokens"] += B * plen
            last = logits[:, -1].argmax(dim=-1).cpu().numpy()   # syncs
            self.stats["prefill_s"] += time.perf_counter() - tp
            del logits
            nmax = max(r.max_new_tokens for r in active)
            td = time.perf_counter()
            for step in range(nmax):
                pos = plen + step
                tg = time.perf_counter()
                for r in active:
                    self.pager.ensure_capacity(r.req_id, 1)
                    self.pager.advance(r.req_id, 1)
                    # touch the block table = the decode read pattern
                    self.pager.block_table(
                        r.req_id, -(-self.max_len // cfg.page_size))
                self.stats["pager_s"] += time.perf_counter() - tg
                batch = {"tokens": torch.from_numpy(last[:, None])}
                logits, cache = self.model.decode_step(self.params_c, batch,
                                                       cache, pos)
                last = logits[:, 0].argmax(dim=-1).cpu().numpy()
                self.stats["decode_tokens"] += B
                for i, r in enumerate(active):
                    if len(r.generated) < r.max_new_tokens:
                        r.generated.append(int(last[i]))
            self.stats["decode_s"] += time.perf_counter() - td
            for r in active:
                self.pager.finish_sequence(r.req_id)
                out[r.req_id] = r.generated
        dt = max(time.time() - t0, 1e-9)
        self.stats["decode_tok_per_s"] = self.stats["decode_tokens"] / dt
        self.stats.update(self.pager.stats)
        return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, args.prompt_len,
                                    dtype=np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    loop = ServeLoop(cfg, max_len=args.prompt_len + args.new_tokens + 8,
                     device=args.device)
    out = loop.run(reqs)
    print(f"served {len(out)} requests; stats: {loop.stats}")


if __name__ == "__main__":
    main()
