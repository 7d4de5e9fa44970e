#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its serving path on a GPU.

Run from the root of a checkout on a machine with one NVIDIA H100 (Hopper,
``nvcc`` under ``/usr/local/cuda``): ``python3 chip_smoke.py``.

Phases, each raising on failure (nothing is caught, so a failed phase is a
non-zero exit):

1. the card's name and power limit from ``nvidia-smi``;
2. build both CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``;
3. each kernel against its plain PyTorch version on the card: the reference
   test cases in fp32 and bf16, and the serving path's own shapes, with
   CUDA-event timings of the kernel, its plain version and (flash) SDPA as a
   yardstick that the port never calls;
4. serve: full-width qwen3-0.6b ``ServeLoop`` answers 8 requests of 512
   prompt tokens and 32 new tokens with a page pool too small to hold them,
   prefill through the flash kernel;
5. KV pool: the served prompts' K/V written into a ``PagedKVCache`` at
   qwen3's geometry, evicted and restored, and read in place by the paged
   kernel, against its plain version and dense attention;
6. profile: host wall time, device busy time and idle share of one warm
   prefill and one warm decode step (torch.profiler).

Launch counts are zeroed just before phase 4 and read just after phase 5.
The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of the
repo beside it, the script exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def _fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


if not torch.cuda.is_available():
    _fail("torch.cuda.is_available() is False; this runs on an NVIDIA GPU")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PagedKVCache  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_attention  # noqa: E402
from repro_torch.launch.serve import Request, ServeLoop  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

DEV = torch.device("cuda")
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
POOL_TOL = 2e-5

# the JAX package's kernel test cases (tests/test_kernels.py)
FLASH_CASES = [  # B, H, KH, Tq, Tk, D, causal, window
    (1, 4, 2, 64, 64, 32, True, None),
    (2, 4, 4, 40, 72, 16, True, None),
    (1, 2, 1, 64, 64, 32, False, None),
    (1, 2, 2, 96, 96, 32, True, 32),
    (1, 8, 4, 128, 128, 64, True, None),
]
PAGED_CASES = [  # B, H, KH, D, P, page, max_pages
    (2, 4, 2, 32, 16, 8, 4),
    (1, 8, 8, 16, 8, 16, 3),
    (3, 4, 1, 64, 32, 8, 6),
]


def log(*a):
    print(*a, flush=True)


def close_or_fail(out, ref, tol, what):
    """allclose with rtol = atol = tol; returns the max abs error."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape:
        _fail(f"{what}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        _fail(f"{what}: non-finite output")
    err = (out - ref).abs()
    excess = float((err - tol * (1 + ref.abs())).max())
    if excess > 0:
        _fail(f"{what}: max abs err {float(err.max())} over tol {tol}")
    return float(err.max())


_FLUSH = None


def time_ms(fn, reps=20, spin=True):
    """Median device ms of one call, timed with CUDA events. The 50 MB L2 is
    flushed before each call, so inputs come from device memory, and the GPU
    then spins for ~1 ms so that the host has enqueued the whole call before
    the start event fires: the host's launch overhead is not counted. With
    ``spin=False`` it is, as far as the device waits for it."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        if spin:
            torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand(rng, shape, dtype):
    return torch.from_numpy(rng.normal(size=shape)).to(DEV, dtype)


# -- phase 3: kernels against their plain versions ------------------------------
def check_flash(rng):
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            B, H, KH, Tq, Tk, D, causal, window = case
            q = rand(rng, (B, H, Tq, D), dtype)
            k, v = rand(rng, (B, KH, Tk, D), dtype), rand(rng, (B, KH, Tk, D), dtype)
            out = flash_attention(q, k, v, causal=causal, window=window,
                                  impl="kernel", block_q=32, block_k=32)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, causal=causal, window=window)
            err = close_or_fail(out, ref, TOL[dtype], f"flash {case} {dtype}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    # the serving path's prefill: qwen3-0.6b heads, 4 prompts of 512 tokens
    B, H, KH, T, D, dtype = 4, 16, 8, 512, 128, torch.bfloat16
    q = rand(rng, (B, H, T, D), dtype)
    k, v = rand(rng, (B, KH, T, D), dtype), rand(rng, (B, KH, T, D), dtype)
    out = flash_attention(q, k, v, causal=True, impl="kernel")
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=True)
    err = close_or_fail(out, ref, TOL[dtype], "flash slice shape")
    def run():
        return flash_attention(q, k, v, causal=True, impl="kernel")

    kernel_ms, call_ms = time_ms(run), time_ms(run, spin=False)
    plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    pairs = B * H * T * (T + 1) // 2                 # causal (q, k) pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = bound(nbytes, 4 * D * pairs, dtype)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:84",
                shape=f"B={B} H={H} KH={KH} T={T} D={D} bf16 causal",
                max_abs_err=err, tolerance=TOL[dtype],
                cases_max_abs_err=worst, ms=kernel_ms, kernel_ms=kernel_ms,
                call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def paged_inputs(rng, B, H, KH, D, P, page, lengths, dtype):
    q = rand(rng, (B, H, D), dtype)
    kv = rand(rng, (P, page, 2, KH, D), dtype)
    max_pages = max(-(-n // page) for n in lengths)
    bt = np.full((B, max_pages), -1, np.int32)
    for b, n in enumerate(lengths):
        npages = -(-n // page)
        bt[b, :npages] = rng.choice(P, size=npages, replace=False)
    return q, kv, bt, np.asarray(lengths, np.int32)


def check_paged(rng):
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in PAGED_CASES:
            B, H, KH, D, P, page, maxp = case
            lengths = []
            for _ in range(B):
                n = int(rng.integers(1, maxp + 1))
                lengths.append(int(rng.integers((n - 1) * page + 1, n * page + 1)))
            q, kv, bt, ln = paged_inputs(rng, B, H, KH, D, P, page, lengths,
                                         dtype)
            out = paged_attention(q, kv, bt, ln, impl="kernel")
            torch.cuda.synchronize()
            ref = paged_attention(q, kv, bt, ln, impl="xla")
            err = close_or_fail(out, ref, TOL[dtype], f"paged {case} {dtype}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
        # long sequences: several pages per split block (double-buffered)
        q, kv, bt, ln = paged_inputs(rng, 2, 4, 1, 128, 600, 16, [7999, 3001],
                                     dtype)
        out = paged_attention(q, kv, bt, ln, impl="kernel")
        torch.cuda.synchronize()
        ref = paged_attention(q, kv, bt, ln, impl="xla")
        worst[f"long {dtype}"] = close_or_fail(out, ref, TOL[dtype],
                                               f"paged long {dtype}")
    # the serving path's decode read: qwen3-0.6b heads over an fp32 pool with
    # page 64, ragged lengths up to max_len 552, tables in random slot order
    B, H, KH, D, P, page = 4, 16, 8, 128, 40, 64
    lengths = [552, 471, 300, 65]
    out = None
    for dtype in (torch.bfloat16, torch.float32):
        q, kv, bt, ln = paged_inputs(rng, B, H, KH, D, P, page, lengths, dtype)
        out = paged_attention(q, kv, bt, ln, impl="kernel")
        torch.cuda.synchronize()
        ref = paged_attention(q, kv, bt, ln, impl="xla")
        err = close_or_fail(out, ref, TOL[dtype], f"paged slice shape {dtype}")
        worst[f"slice {dtype}"] = err
    bt_d = torch.as_tensor(bt, device=DEV)
    ln_d = torch.as_tensor(ln, device=DEV)
    def run():
        return paged_attention(q, kv, bt_d, ln_d, impl="kernel")

    kernel_ms, call_ms = time_ms(run), time_ms(run, spin=False)
    plain_ms = time_ms(lambda: paged_attention(q, kv, bt_d, ln_d, impl="xla"))
    tokens = int(sum(lengths))                       # live K/V rows
    nbytes = (tokens * 2 * KH * D + 2 * q.numel()) * kv.element_size() \
        + bt.nbytes + ln.nbytes
    bound_ms, bound_by = bound(nbytes, 4 * H * D * tokens, torch.float32)
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention/kernel.py:79",
                shape=f"B={B} H={H} KH={KH} D={D} page={page} "
                      f"lengths={lengths} fp32",
                max_abs_err=err, tolerance=TOL[torch.float32],
                cases_max_abs_err=worst, ms=kernel_ms, kernel_ms=kernel_ms,
                call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def check_model_small(cfg, rng):
    """The LM's kernel path against its plain path on a small input: two
    full-width qwen3 layers in fp32, prefill logits at the fp32 tolerance
    of two layers of reordered sums."""
    small = cfg.with_(n_layers=2, compute_dtype="float32",
                      kv_cache_dtype="float32")
    kern = build_model(small, attn_impl="kernel")
    plain = build_model(small, attn_impl="xla")
    params = kern.init(torch.Generator("cuda").manual_seed(1))
    toks = torch.from_numpy(rng.integers(0, small.vocab, (2, 96)))
    lk, _ = kern.prefill(params, {"tokens": toks})
    lp, _ = plain.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    return close_or_fail(lk, lp, 1e-4, "2-layer prefill kernel vs plain")


# -- phase 4: serve ---------------------------------------------------------------
def serve(cfg, prompts):
    loop = ServeLoop(cfg, batch_slots=4, max_len=552, hbm_pages=18)
    reqs = [Request(i, p, max_new_tokens=32) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    out = loop.run(reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if len(out) != len(prompts):
        _fail(f"served {len(out)} of {len(prompts)} requests")
    for rid, toks in out.items():
        if len(toks) != 32 or not all(0 <= t < cfg.vocab for t in toks):
            _fail(f"request {rid}: {len(toks)} tokens, ids {toks[:4]}...")
    st = loop.stats
    if st["offloads"] <= 0:
        _fail("the page pool never offloaded")
    n_prefills = -(-len(prompts) // 4)
    if flash_attention.launches < cfg.n_layers * n_prefills:
        _fail(f"flash kernel launched {flash_attention.launches} times, "
              f"want >= {cfg.n_layers * n_prefills}")
    report = dict(requests=len(out), wall_s=wall_s,
                  prefill_ms_per_batch=st["prefill_s"] / n_prefills * 1e3,
                  decode_tok_per_s=st["decode_tokens"] / st["decode_s"],
                  decode_tok_per_s_whole_run=st["decode_tok_per_s"],
                  prefill_s=st["prefill_s"], decode_s=st["decode_s"],
                  pager_s=st["pager_s"],
                  offloads=st["offloads"], fetches=st["fetches"],
                  offload_bytes=st["offload_bytes"])
    log("serve", json.dumps(report))
    return loop


# -- phase 5: the KV page pool read in place ---------------------------------------
def kv_pool(loop, cfg, prompts, rng):
    L, KH, D, page = cfg.n_layers, cfg.kv_heads, cfg.resolved_head_dim, cfg.page_size
    H = cfg.n_heads
    lengths = [512, 461, 300, 130]                   # 8 + 8 + 5 + 3 pages
    _, cache = loop.model.prefill(
        loop.params_c, {"tokens": torch.from_numpy(np.stack(prompts[:4]))})
    dense_k, dense_v = cache["k"].float(), cache["v"].float()  # [L, B, KH, T, D]
    # fp32 as ServeLoop builds it; 20 slots < 24 pages written
    pool = PagedKVCache(num_layers=L, hbm_pages=20, page_size=page,
                        kv_heads=KH, head_dim=D, dtype=np.float32)
    written = {}
    for s, n in enumerate(lengths):
        pool.start_sequence(s)
        pool.ensure_capacity(s, n)
        pool.advance(s, n)
        for i in range(pool.num_pages(s)):
            sl = slice(i * page, (i + 1) * page)
            slab = torch.stack([cache["k"][:, s, :, sl].transpose(1, 2),
                                cache["v"][:, s, :, sl].transpose(1, 2)], dim=2)
            pool.write_page(s, i, slab)              # bf16 widens to fp32 exactly
            written[(s, i)] = slab.float().cpu().numpy()
    gen = torch.Generator("cuda").manual_seed(2)

    def attend(seqs):
        # one batch's pages fit the pool together: a restore inside
        # block_table may evict a page of another table (exclude_set is
        # ignored, as in the reference)
        max_pages = max(pool.num_pages(s) for s in seqs)
        tables = np.stack([pool.block_table(s, max_pages) for s in seqs])
        lens = np.asarray([pool.seq_length(s) for s in seqs], np.int32)
        q = torch.randn((len(seqs), H, D), generator=gen, device=DEV)
        worst = 0.0
        for layer in range(L):
            out = paged_attention(q, pool.kv[layer], tables, lens, impl="kernel")
            torch.cuda.synchronize()
            plain = paged_attention(q, pool.kv[layer], tables, lens, impl="xla")
            worst = max(worst, close_or_fail(out, plain, POOL_TOL,
                                             f"pool layer {layer} vs plain"))
            for j, s in enumerate(seqs):
                n = lengths[s]
                dense = attention_ref(q[j][None, :, None],
                                      dense_k[layer, s][None, :, :n],
                                      dense_v[layer, s][None, :, :n],
                                      causal=False)[0, :, 0]
                worst = max(worst, close_or_fail(
                    out[j], dense, POOL_TOL, f"pool layer {layer} seq {s} vs dense"))
        return worst

    worst = max(attend([0, 3]), attend([1, 2]), attend([0, 3]))
    st = pool.stats
    if st["offloads"] <= 0 or st["fetches"] <= 0:
        _fail(f"pool did not evict and restore: {st}")
    for (s, i), slab in written.items():
        if pool.read_page(s, i).tobytes() != slab.tobytes():
            _fail(f"read_page({s}, {i}) differs from what was written")
    log("kv_pool", json.dumps(dict(max_abs_err=worst, tolerance=POOL_TOL, **st)))


def profile_steps(loop, prompts):
    """Where a warm prefill (the served batch: 4 x 512 tokens) and one warm
    decode step spend their time: host wall ms without and with
    torch.profiler, device busy ms (sum of kernel times in the profiled run),
    the device's idle share of the profiled wall time, and the top kernels.
    Runs after the launch counts are read."""
    from torch.profiler import ProfilerActivity, profile
    model, params = loop.model, loop.params_c
    toks = torch.from_numpy(np.stack(prompts[:4]))
    state = {}

    def prefill():
        logits, state["cache"] = model.prefill(params, {"tokens": toks},
                                               max_len=loop.max_len)
        state["last"] = logits[:, -1].argmax(dim=-1)[:, None]

    def decode():
        logits, _ = model.decode_step(params, {"tokens": state["last"]},
                                      state["cache"], toks.shape[1])
        logits[:, 0].argmax(dim=-1)

    report = {}
    for name, fn in (("prefill", prefill), ("decode_step", decode)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        report[name] = dict(
            wall_ms=plain_wall * 1e3, profiled_wall_ms=wall * 1e3,
            device_busy_ms=busy_ms, idle_share=1 - busy_ms / (wall * 1e3),
            kernel_launches=sum(e.count for e in kernels),
            top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
                 for e in top])
    log("profile", json.dumps(report))


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    built = _build.build()
    log("build", json.dumps(dict(seconds=time.perf_counter() - t0,
                                 per_source=built)))

    rng = np.random.default_rng(42)
    kernels = [check_flash(rng), check_paged(rng)]
    cfg = get_config("qwen3-0.6b")
    log("model_small", json.dumps(dict(max_abs_err=check_model_small(cfg, rng),
                                       tolerance=1e-4)))

    prompts = [np.random.default_rng(100 + i).integers(0, cfg.vocab, 512,
                                                       dtype=np.int32)
               for i in range(8)]
    flash_attention.launches = 0
    paged_attention.launches = 0
    loop = serve(cfg, prompts)
    kv_pool(loop, cfg, prompts, rng)
    launches = {"flash_attention": flash_attention.launches,
                "paged_attention": paged_attention.launches}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            _fail(f"{k['name']} was never launched on the main path")
    profile_steps(loop, prompts)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
