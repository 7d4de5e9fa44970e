#!/usr/bin/env python3
"""Why rwkv6-3b trains with its wkv chunked at 16 (``blocks.TRAIN_GLA_CHUNK``)
and not at the JAX package's 64: full-width rwkv6-3b on one CUDA card at
both chunks. Prints the card's name and power limit, then one JSON line.

    python3 tools/rwkv_gla_chunk.py [--runs] [--grads] [--steps N]

``--runs``: full-depth training, ``run_training`` as ``chip_smoke.py``
phase 21 calls it (8 x 512 tokens over 32 repeated sequences, fp32 params,
bf16 compute, remat per layer, fp32 AdamW moments), at each (chunk, lr)
of ``RUNS``: the losses, the gradient norms, the warm step's seconds, and
the largest |log decay| that reached the GLA scan under grad in each
step. A run that raises is recorded with its error.

``--grads``: one loss and gradient norm from init (seed 5) on one batch
of 8 x 512 tokens through three scans: the GLA kernel's forward with the
plain backward by recompute (``"kernel"``), the chunked plain path
(``"xla_chunked"``, the reference's algorithm) and the sequential oracle
(``"xla"``, which has no chunk), at chunks 64 and 16, at 4 and 32 layers,
in fp32 and in bf16 compute.

``--leaves``: at chunk 16 in fp32, from init, at 4 and 32 layers: each
path's gradient leaf by leaf against the sequential oracle's (the relative
L2 gap of each leaf, the largest six and the median), and the same for the
oracle with every wkv output o multiplied by 1 + 2^-23 N(0, 1), a
perturbation of the size of one fp32 rounding: where that moves the
gradient as far as the kernel's path does, the gap is rounding amplified
by the backward, not a fault of the kernel.

``--trained``: the same, at the params 12 steps of ``--runs``' training
at chunk 16 reach (``chip_smoke.py`` phase 21's) and on its route check's
batch, in bf16 compute (o perturbed by 2^-9, half a bf16 ulp) and fp32;
in bf16 also the kernel path with its forward on the inputs' own dtype,
the tensor-core ``mma`` route, where ``_GLAScan`` casts them to fp32.

``--inputs``: at those params and batch in bf16 compute, each layer's
wkv inputs as the model made them, through the kernel and the chunked
plain version at chunks 16 and 64, against the exact scan in fp64: the
largest and RMS relative error of o, its bias and the share of elements
off the exact value's bf16 rounding.
"""
import argparse
import gc
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
import numpy as np  # noqa: E402
import torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.linear_scan import ops as scan_ops  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.lm import tree_map  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

RUNS = [(64, 3e-4), (16, 3e-4), (64, 3e-5), (16, 1e-4)]   # chunk, lr
CHUNK = blocks.TRAIN_GLA_CHUNK


def train_runs(steps):
    """``RUNS`` through ``run_training`` (the chunk set through
    ``blocks.TRAIN_GLA_CHUNK``), the largest |log decay| of each step's wkv
    calls recorded by a wrapper of ``blocks.gla_scan``."""
    scan, seen = blocks.gla_scan, []

    def watched(r, k, v, w, u, **kw):
        if torch.is_grad_enabled():
            seen.append(float(w.detach().float().abs().max()))
        return scan(r, k, v, w, u, **kw)

    cfg = get_config("rwkv6-3b")
    out = []
    blocks.gla_scan = watched
    try:
        for chunk, lr in RUNS:
            seen.clear()
            blocks.TRAIN_GLA_CHUNK = chunk
            entry = dict(gla_chunk=chunk, lr=lr)
            try:
                res = run_training(cfg, steps=steps, batch_size=8,
                                   seq_len=512, num_sequences=32, seed=5,
                                   lr=lr, log_every=steps + 1,
                                   device="cuda")
                entry.update(losses=res.losses, grad_norms=res.grad_norms,
                             warm_step_s=float(np.median(
                                 res.step_seconds[1:])))
                del res
            except RuntimeError as e:      # a run that fails is a result
                entry["error"] = repr(e)[:300]
            # the forward and its remat recompute: 2 calls a layer a step
            per_step = 2 * cfg.n_layers
            entry["max_abs_log_decay"] = [
                max(seen[i:i + per_step]) for i in range(0, len(seen),
                                                         per_step)]
            out.append(entry)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        blocks.gla_scan, blocks.TRAIN_GLA_CHUNK = scan, CHUNK
    return out


def grad_norms():
    """Loss and gradient norm from init through each scan and chunk."""
    out = []
    for compute in ("float32", "bfloat16"):
        for layers in (4, 32):
            cfg = get_config("rwkv6-3b").with_(n_layers=layers,
                                               compute_dtype=compute)
            params = build_model(cfg).init(
                torch.Generator("cuda").manual_seed(5))
            toks = np.random.default_rng(0).integers(0, cfg.vocab, (8, 512))
            labels = np.concatenate([toks[:, 1:], np.full((8, 1), -100)], 1)
            tb = {"tokens": torch.from_numpy(toks).cuda(),
                  "labels": torch.from_numpy(labels).cuda()}
            flat = []
            tree_map(flat.append, params)
            for chunk, impl in ((64, "kernel"), (64, "xla_chunked"),
                                (16, "kernel"), (16, "xla_chunked"),
                                (None, "xla")):
                blocks.TRAIN_GLA_CHUNK = chunk or CHUNK
                leaves = [p.detach().requires_grad_(True) for p in flat]
                it = iter(leaves)
                loss = build_model(cfg, scan_impl=impl).loss(
                    tree_map(lambda _: next(it), params), tb)
                grads = torch.autograd.grad(loss, leaves)
                norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
                out.append(dict(layers=layers, compute=compute, chunk=chunk,
                                scan_impl=impl, loss=float(loss.detach()),
                                grad_norm=float(norm)))
                print(json.dumps(out[-1]), flush=True)
                del loss, grads, leaves
                gc.collect()
            blocks.TRAIN_GLA_CHUNK = CHUNK
            del params, flat
            torch.cuda.empty_cache()
    return out


def _names(tree, prefix=""):
    """The leaves' paths, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _names(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _names(v, f"{prefix}{i}/")]
    return [] if tree is None else [prefix.rstrip("/")]


class _MmaForward(torch.autograd.Function):
    """``_GLAScan`` with its kernel forward on the inputs' own dtype (in
    bf16 the tensor-core ``mma`` route), and the same plain backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        return scan_ops.gla_scan(r, k, v, w, u, impl="kernel", chunk=chunk)

    @staticmethod
    def backward(ctx, go, gS):
        return scan_ops._GLAScan.backward(ctx, go, gS)


def _mma_scan(r, k, v, w, u, *, impl, chunk):
    if impl != "kernel":
        return scan_ops.gla_scan(r, k, v, w, u, impl=impl, chunk=chunk)
    return _MmaForward.apply(r, k, v, w, u, chunk)


def _leaf_gaps(cfg, params, tb, eps, tag):
    """Each path's gradient at ``params`` on batch ``tb`` against the
    sequential oracle's, leaf by leaf; the perturbed oracle multiplies
    every wkv output o by 1 + ``eps`` N(0, 1)."""
    scan, out = blocks.gla_scan, []

    def perturbed(*args, **kw):
        # the same noise in the forward and in its remat recompute
        o, S = scan(*args, **kw)
        noise = torch.randn(o.shape, device=o.device,
                            generator=torch.Generator(o.device).manual_seed(11))
        return (o.float() * (1 + eps * noise)).to(o.dtype), S

    flat, names = [], _names(params)
    tree_map(flat.append, params)

    def grads_of(impl):
        leaves = [p.detach().requires_grad_(True) for p in flat]
        it = iter(leaves)
        loss = build_model(cfg, scan_impl=impl).loss(
            tree_map(lambda _: next(it), params), tb)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    def norm(gs):
        return float(torch.sqrt(sum(g.float().pow(2).sum() for g in gs)))

    ref_loss, ref = grads_of("xla")
    ref_norm = norm(ref)
    by_norm = sorted(((float(g.norm()), n) for g, n in zip(ref, names)),
                     reverse=True)[:4]
    ref = [g.cpu() for g in ref]
    paths = [("kernel", "kernel", scan),
             ("xla_chunked", "xla_chunked", scan),
             ("xla, o perturbed", "xla", perturbed)]
    if cfg.compute_dtype == "bfloat16":
        paths.insert(1, ("kernel forward on mma", "kernel",
                         lambda *a, **kw: _mma_scan(*a, **kw)))
    for label, impl, fn in paths:
        blocks.gla_scan = fn
        try:
            loss, grads = grads_of(impl)
        finally:
            blocks.gla_scan = scan
        gaps = {n: float((g.float() - r.cuda().float()).norm()
                         / r.float().norm().clamp_min(1e-30))
                for n, g, r in zip(names, grads, ref)}
        top = sorted(gaps.items(), key=lambda kv: -kv[1])
        out.append(dict(params=tag, layers=cfg.n_layers,
                        compute=cfg.compute_dtype,
                        chunk=blocks.TRAIN_GLA_CHUNK, perturbation=eps,
                        path=label, loss=loss, grad_norm=norm(grads),
                        oracle_loss=ref_loss, oracle_grad_norm=ref_norm,
                        oracle_largest_leaves=by_norm,
                        largest_leaf_gaps=top[:6],
                        median_leaf_gap=float(np.median(
                            list(gaps.values())))))
        print(json.dumps(out[-1]), flush=True)
        del grads
        gc.collect()
    return out


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (8, 512),
                                                dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((8, 1), -100, np.int32)],
                            1)
    return {"tokens": torch.from_numpy(toks).cuda(),
            "labels": torch.from_numpy(labels).cuda()}


def leaf_gaps():
    """``--leaves``: from init (seed 5), fp32, at 4 and 32 layers."""
    out = []
    for layers in (4, 32):
        cfg = get_config("rwkv6-3b").with_(n_layers=layers,
                                           compute_dtype="float32")
        params = build_model(cfg).init(torch.Generator("cuda").manual_seed(5))
        out += _leaf_gaps(cfg, params, _batch(cfg, 0), 2.0 ** -23, "init")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def trained_gaps(steps):
    """``--trained``: at the params of ``chip_smoke.py`` phase 21's run
    (``steps`` steps of ``run_training``, seed 5) and on its route check's
    batch (seed 8), in bf16 compute (perturbation 2^-9, half a bf16 ulp)
    and in fp32 (2^-23)."""
    cfg = get_config("rwkv6-3b")
    res = run_training(cfg, steps=steps, batch_size=8, seq_len=512,
                       num_sequences=32, seed=5, log_every=steps + 1,
                       device="cuda")
    params = res.state.params
    del res
    gc.collect()
    torch.cuda.empty_cache()
    out = []
    for compute, eps in (("bfloat16", 2.0 ** -9), ("float32", 2.0 ** -23)):
        ccfg = cfg.with_(compute_dtype=compute)
        out += _leaf_gaps(ccfg, params, _batch(ccfg, 8), eps,
                          f"trained {steps} steps")
    return out


def _o_stats(o, exact):
    """o (bf16) against the exact scan (fp64): the largest and the RMS of
    |o - exact| / (1 + |exact|), the mean signed error over the RMS of
    exact (a bias), and the share of elements whose bf16 value is not the
    exact value's bf16 rounding."""
    d = o.double() - exact
    rel = d.abs() / (1 + exact.abs())
    return dict(max_rel=float(rel.max()), rms_rel=float(rel.pow(2).mean()
                                                      .sqrt()),
                bias=float(d.mean() / exact.pow(2).mean().sqrt()),
                ulps_off=float((o != exact.to(o.dtype)).double().mean()))


def input_gaps(steps):
    """``--inputs``: the wkv's own inputs at ``trained_gaps``' params and
    batch in bf16 compute, captured layer by layer, through the kernel
    (``mma`` route) and the chunked plain version at chunks 16 and 64,
    each against the exact scan in fp64 (``gla_scan_ref``)."""
    from repro_torch.kernels.linear_scan.ops import gla_scan
    from repro_torch.kernels.linear_scan.ref import gla_scan_ref
    cfg = get_config("rwkv6-3b")
    res = run_training(cfg, steps=steps, batch_size=8, seq_len=512,
                       num_sequences=32, seed=5, log_every=steps + 1,
                       device="cuda")
    params = res.state.params
    del res
    gc.collect()
    torch.cuda.empty_cache()
    scan, seen = blocks.gla_scan, []

    def captured(*args, **kw):
        if torch.is_grad_enabled():         # not the remat's recompute
            seen.append([x.detach().clone() for x in args])
        return scan(*args, **kw)

    blocks.gla_scan = captured
    try:
        # under grad, so that the wkv is chunked as in training (16)
        build_model(cfg).loss(tree_map(
            lambda t: t.detach().requires_grad_(True), params), _batch(cfg, 8))
    finally:
        blocks.gla_scan = scan
    out = []
    for layer, xs in enumerate(seen):
        exact, _ = gla_scan_ref(*(x.double() for x in xs))
        entry = dict(layer=layer, max_abs_log_decay=float(xs[3].float().abs()
                                                          .max()),
                     exact_rms=float(exact.pow(2).mean().sqrt()))
        for chunk in (16, 64):
            for impl in ("kernel", "xla_chunked"):
                o, _ = gla_scan(*xs, impl=impl, chunk=chunk)
                entry[f"{impl} {chunk}"] = _o_stats(o, exact)
            # the remat recompute must see the forward's bits
            entry[f"kernel {chunk} repeatable"] = bool(torch.equal(
                gla_scan(*xs, impl="kernel", chunk=chunk)[0],
                gla_scan(*xs, impl="kernel", chunk=chunk)[0]))
        out.append(entry)
        print(json.dumps(entry), flush=True)
        del exact
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", action="store_true")
    ap.add_argument("--grads", action="store_true")
    ap.add_argument("--leaves", action="store_true")
    ap.add_argument("--trained", action="store_true")
    ap.add_argument("--inputs", action="store_true")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rwkv_gla_chunk: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    result = {"card": torch.cuda.get_device_name(0)}
    if args.runs:
        result["runs"] = train_runs(args.steps)
    if args.grads:
        result["grad_norms"] = grad_norms()
    if args.leaves:
        result["leaf_gaps"] = leaf_gaps()
    if args.trained:
        result["trained_gaps"] = trained_gaps(12)
    if args.inputs:
        result["input_gaps"] = input_gaps(12)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
