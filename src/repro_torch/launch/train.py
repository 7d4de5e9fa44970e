"""Training loop: data pipeline (buffer pool) -> train step -> checkpoint
manager (async, heterogeneous layouts) -> fault-tolerance hooks, step for
step with the JAX package's ``launch/train.py``.

The token dataset is written through the port's ``BufferPool``
(``synthetic_token_dataset``) and read back by ``BatchLoader``; each batch
moves to the device for its step. Attention's forward runs the flash
kernel (``LM(attn_impl="kernel")``, with the rows' lse written) and its
backward the plain mirror of the reference's custom VJP; RWKV6's wkv runs
the GLA-scan kernel forward and a plain backward by recompute, RG-LRU's
diagonal scan its forward and backward kernels; the MoE block's dispatch
and combine their shuffle kernels forward and backward (each backward a
launch of the other's kernel, combine's gate gradient plain); the
optimizer is the port's AdamW. Checkpoints go through the port's
``CheckpointManager`` with the reference's layouts, shard count and
flattened keys, so either package restores the other's. Every family
trains: dense, ssm (rwkv6-3b), hybrid (recurrentgemma-9b), moe
(grok-1-314b, deepseek-v2-lite-16b with MLA), vlm (qwen2-vl-72b) and
encdec (seamless-m4t-large-v2), each batch completed as the reference's
loop completes it (``train_batch``).

Run: ``python -m repro_torch.launch.train --arch qwen3-0.6b`` on the card,
or ``--smoke --device cpu`` for a small CPU run.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import trace
from .._device import DeviceLike, resolve_device
from ..checkpoint import CheckpointManager
from ..configs import get_config, smoke_config
from ..configs.base import ArchConfig
from ..core import BufferPool
from ..data.pipeline import BatchLoader, synthetic_token_dataset
from ..models.blocks import embed
from ..models.lm import tree_map
from ..models.model import build_model
from ..optim import AdamWState, TrainState, make_train_state, make_train_step
from ..runtime import StepTimer
from ..sharding import use_rules
from .mesh import batch_shardings, distribute, param_shardings, sharding_rules


@dataclass
class TrainLoopResult:
    losses: list
    steps: int
    restored_from: Optional[int]
    tokens_per_s: float
    grad_norms: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)
    state: Any = None          # the final TrainState, on the device


class SimulatedFailure(RuntimeError):
    """The crash ``fail_at_step`` simulates. ``state`` is the TrainState at
    the crash step, the one the last checkpoint holds."""

    def __init__(self, step: int, state: TrainState):
        super().__init__(f"simulated failure at step {step}")
        self.state = state


def state_to(state: TrainState, device: torch.device) -> TrainState:
    """A TrainState (e.g. restored as CPU tensors) moved to ``device``."""
    move = lambda t: t.to(device)
    opt = state.opt
    return TrainState(params=tree_map(move, state.params),
                      opt=AdamWState(step=move(opt.step),
                                     m=tree_map(move, opt.m),
                                     v=tree_map(move, opt.v)),
                      model_state=None if state.model_state is None
                      else tree_map(move, state.model_state))


def frames_generator(seed: int, step: int,
                     device: torch.device) -> torch.Generator:
    """The generator of the enc-dec frames at ``step`` of a run seeded
    with ``seed``: one (seed, step) pair, one stream, so that a run
    restarted from a checkpoint draws the frames the first run drew at
    that step. The pair is mixed into 32 bits by numpy's ``SeedSequence``
    (the CPU generator keeps only a seed's low 32 bits). The reference
    draws them from ``jax.random.fold_in(PRNGKey(seed), step)``, which
    torch cannot reproduce: the two packages draw other frames (ROADMAP
    queue 3, quirk 12)."""
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


def train_batch(cfg: ArchConfig, batch: Dict[str, np.ndarray], params,
                step: int, seed: int, device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """A loader batch (tokens, labels) on ``device``, completed as the
    reference's ``run_training`` completes it: with M-RoPE the positions
    ``arange(T)`` on all three of [B, 3, T] (int32); for the VLM the
    embeddings of the tokens, gathered from the fp32 master ``params``
    before the step (a new tensor, detached: the step updates the params in
    place), in place of the tokens; for the enc-dec [B, T, d_model] fp32
    standard-normal frames from ``frames_generator(seed, step)``. The
    program span ``pangea.data.to_device``."""
    with trace.span("pangea.data.to_device"):
        tb = {k: torch.tensor(v, device=device) for k, v in batch.items()}
        B, T = tb["tokens"].shape
        if cfg.rope == "mrope":
            tb["positions"] = torch.arange(
                T, dtype=torch.int32, device=device).expand(B, 3, T)
        if cfg.embed_inputs and cfg.family != "encdec":
            with torch.no_grad():
                tb["embeds"] = embed(params["embed"],
                                     tb.pop("tokens").long())
        if cfg.family == "encdec":
            tb["src_embeds"] = torch.randn(
                (B, T, cfg.d_model), generator=frames_generator(seed, step,
                                                                device),
                dtype=torch.float32, device=device)
        return tb


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A metric as one tensor (a DTensor's value gathered)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _tokens_per_s(step_tokens: int, starts: List[float], ends: List[float],
                  step_seconds: List[float]) -> float:
    """Tokens of the steps after the first over the time from the second
    step's start (its batch's fetch) to the last step's end (its loss on
    the host): the first step's warm-up and the final checkpoint save are
    left out, the saves between steps are not. One step: its tokens over
    its ``step_seconds``; none: 0."""
    if len(ends) > 1:
        return step_tokens * (len(ends) - 1) / (ends[-1] - starts[1])
    if ends:
        return step_tokens / max(step_seconds[0], 1e-9)
    return 0.0


def run_training(cfg: ArchConfig, *, steps: int = 20, batch_size: int = 8,
                 seq_len: int = 64, lr: float = 3e-4,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
                 microbatches: int = 1, pool_bytes: int = 256 << 20,
                 num_sequences: Optional[int] = None, seed: int = 0,
                 log_every: int = 5,
                 fail_at_step: Optional[int] = None,
                 device: DeviceLike = "cuda",
                 params=None, mesh=None) -> TrainLoopResult:
    """Train on synthetic data staged through the Pangea buffer pool.

    ``params``: initial params (e.g. the reference's, bridged; the train
    step updates them in place); by default ``LM.init`` draws them from a
    ``torch.Generator`` seeded with ``seed`` on ``device``. A checkpoint
    copies the state to the host before the next step updates it.
    ``fail_at_step`` simulates a crash (raises ``SimulatedFailure``, a
    ``RuntimeError``); calling run_training again with the same
    ``ckpt_dir`` restores and continues.

    ``mesh``: a ``DeviceMesh`` over ("data", "model") (``launch/mesh.py``):
    the params, moments and each batch become DTensors with the placements
    of ``sharding_rules(cfg, mesh)`` and every step runs under
    ``sharding.use_rules``; the losses and grad norms are read whole.
    Checkpoints of a sharded state are not ported (``ckpt_dir`` raises).
    """
    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    rules = None
    if mesh is not None:
        if ckpt_dir:
            raise ValueError("run_training: checkpoints of a sharded state "
                             "are not ported; pass mesh or ckpt_dir")
        rules = sharding_rules(cfg, mesh)
        params = distribute(params, mesh,
                            param_shardings(model, cfg, mesh, rules))
    state = make_train_state(params, cfg.opt_state_dtype, model.init_state())
    step_fn = make_train_step(model.loss, lr=lr, microbatches=microbatches)

    mgr = None
    restored_from = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, layouts=("row", "col"),
                                num_shards=4)
        last = mgr.latest_step()
        if last is not None:
            state = state_to(mgr.restore(state, step=last), dev)
            restored_from = last

    pool = BufferPool(pool_bytes)
    nseq = num_sequences or batch_size * max(steps, 1)
    ds = synthetic_token_dataset(pool, "train_tokens", vocab=cfg.vocab,
                                 num_sequences=nseq, seq_len=seq_len,
                                 seed=seed)
    timer = StepTimer([0])
    res = TrainLoopResult(losses=[], steps=0, restored_from=restored_from,
                          tokens_per_s=0.0)
    done = int(state.opt.step)
    # each step's start (its batch's fetch) and end (its loss on the host)
    starts: List[float] = []
    ends: List[float] = []

    def batches() -> Iterable[Dict[str, np.ndarray]]:
        while True:
            for b in BatchLoader(ds, batch_size=batch_size):
                yield b

    feed = batches()
    while done < steps:
        starts.append(time.perf_counter())
        batch = next(feed)
        with (use_rules(rules, mesh) if mesh is not None
              else contextlib.nullcontext()):
            tb = train_batch(cfg, batch, state.params, done, seed, dev)
            if mesh is not None:
                tb = distribute(tb, mesh, batch_shardings(tb, mesh))
            t0 = time.time()
            state, metrics = step_fn(state, tb)
            loss = float(_whole(metrics["loss"]))
            dt = time.time() - t0
            ends.append(time.perf_counter())
        timer.record(0, dt)
        res.losses.append(loss)
        res.grad_norms.append(float(_whole(metrics["grad_norm"])))
        res.step_seconds.append(dt)
        done = int(metrics["step"])
        if done % log_every == 0 or done == steps:
            print(f"step {done:5d} loss {loss:.4f} "
                  f"({timer.ewma[0]*1e3:.0f} ms/step)")
        if mgr and done % ckpt_every == 0:
            mgr.save(done, state, async_=True)
        if fail_at_step is not None and done >= fail_at_step:
            if mgr:
                mgr.wait()
            raise SimulatedFailure(done, state)
    if mgr:
        mgr.save(done, state, async_=False)
    res.steps = done
    res.tokens_per_s = _tokens_per_s(batch_size * seq_len, starts, ends,
                                     res.step_seconds)
    res.state = state
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    res = run_training(cfg, steps=args.steps, batch_size=args.batch_size,
                       seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                       microbatches=args.microbatches, device=args.device)
    print(f"done: {res.steps} steps, final loss {res.losses[-1]:.4f}, "
          f"{res.tokens_per_s:.0f} tok/s")


if __name__ == "__main__":
    main()
